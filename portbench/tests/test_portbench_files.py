"""Every configuration, cell, traffic, limit and metric file of
BENCHMARK.json loads by name, and each configuration is the program's."""
import json
from pathlib import Path

import pytest

from portbench import check, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(workload):
    s = run.spec(workload)
    assert set(s["limits"]) == set(check.NUMBERS)
    for key in ("batch_size", "images", "r1_interval", "check_steps",
                "warm_steps", "trace_steps"):
        assert isinstance(s["traffic"][key], int)
    assert s["traffic"]["check_steps"] <= s["traffic"]["warm_steps"]
    names = {m["name"] for m in s["end_to_end"] + s["per_layer"]}
    assert {"setup_s", "train_images_per_s"} <= names


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_programs(config):
    # each key of the configuration that its model module says the
    # program builds, as the program builds it
    cfg = run.load_json(ROOT / config["file"])
    assert cfg["name"] == config["name"]
    prog = run.model(cfg["model"]).programs_config(cfg)
    assert prog and prog == {k: cfg[k] for k in prog}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    assert callable(run.reader(metric["name"]))
