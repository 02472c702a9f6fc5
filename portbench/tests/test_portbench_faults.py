"""``correct`` comes out false for the control and for each fault a
training cell can have, at a tiny size on the CPU, held to the cell's own
limits: the reference computed in fp8 in the program's place, a step that
returns its state unchanged, a step that sees half the batch, and G's
optimizer given the negated gradient. The harness's look for a card is
skipped; the rest of a run is driven."""
import json
from pathlib import Path

import pytest

from portbench import check, run, study

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())[
        "workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_passes(tiny, workload):
    s = tiny(workload)
    result, res, _ = run.run_cell(s, 7, 0.0, False, "cpu")
    assert result["correct"], res["numbers"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "negated_g"])
def test_fault_fails(tiny, workload, fault):
    s = tiny(workload)
    result, res, _ = run.run_cell(s, 7, 0.0, False, "cpu", fault=fault)
    assert not result["correct"], res["numbers"]
    if fault == "negated_g":  # G's gradient alone tells it
        n = res["numbers"]
        assert n["g_grad"] > s["limits"]["g_grad"], n


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(tiny, workload):
    s = tiny(workload)
    w, batches, draws = study.inputs(s, 7, "cpu")
    prog = run.reference_steps(s, w, batches, draws, "cpu",
                               s["model"].reference.fp8)
    ref = run.reference_steps(s, w, batches, draws, "cpu")
    ref["g_grads_on_prog"] = run.g_grads_on(s, w, prog["after_1"], draws[0],
                                            "cpu")
    prog["before"] = ref["before"] = run.before_state(w)
    numbers = check.compare(prog, ref)
    assert not check.judge(numbers, s["limits"]), numbers


@pytest.mark.cuda
def test_cell_runs_on_the_card(tiny, cuda):
    s = tiny("sagan-512thin-r1-b64", blocks=(16, 16, 8), attention=(1,),
             dtype="bf16")
    result, _, _ = run.run_cell(s, 7, 0.5, True, cuda)
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
