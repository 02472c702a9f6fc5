"""Run one cell of the benchmark of tartangan_torch once.

    python3 portbench/run.py --workload W --seed N --seconds S --trace 0|1

from the root of a checkout (``python3 -m portbench.run`` works too). The
cell ``W`` of ``BENCHMARK.json`` names a configuration (its file) and a
traffic mix (``portbench/traffic/<traffic>.json``); its limits are in
``portbench/limits/<W>.json``, each metric's reader in
``portbench/metrics/<metric>.py`` and the configuration's model (its
``"model"`` key: the trainer, its draws, its reference and its counts) in
``portbench/models/<model>.py``, all found by name. A run makes the data
and the weights from the seed, trains through the program's own loop
(``portbench/program.py``): the set-up's steps, which the check keeps, and
the warm-up, then the window of ``S`` seconds (``--trace 1``: and then the
traffic's ``trace_steps`` steps under the profiler), then holds the
set-up's steps against the model's plain reference
(``portbench/check.py``). It prints, as its last lines on standard error,
each number compared with its limit, and as the last line of standard
output the result as JSON.

It exits with 2 and prints no result without the CUDA devices the cell
needs, and with 3 if the JAX package or JAX was loaded.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The moment this process started, on ``time.perf_counter``'s clock
    (the kernel's record of it, to a clock tick); now, where there is
    none."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return now - age if 0 <= age < 3600 else now


START = _process_start()

import functools  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the program's build and kernel caches stay in the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "tartangan_tpu")


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def spec(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic, limits and
    metrics, as ``BENCHMARK.json`` names them."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root / config["file"])
    listed = lambda m: workload in m.get("workloads", [workload])  # noqa
    return {
        "cell": cell,
        "config": cfg,
        "model": model(cfg["model"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
        "per_layer": [m for m in bench["per_layer"] if listed(m)],
    }


def seeds(seed: int) -> dict:
    """The run's seeds, drawn from ``seed``: the data, the weights and the
    trainer's (its batch order and latents)."""
    state = np.random.SeedSequence(seed).generate_state(3)
    return dict(zip(("data", "weights", "trainer"),
                    (int(s) for s in state)))


def reader(name: str):
    """The ``read(run)`` function of metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def model(name: str):
    """The model module ``name`` (``portbench/models/<name>.py``)."""
    return importlib.import_module(f"portbench.models.{name}")


def train(s: dict, seed: int, seconds: float, trace: bool, device: str,
          fault=None, dtype=None):
    """Set-up, window and the program's records of one run. Returns
    (the run record, the check's inputs from the program, the data).
    ``dtype`` is for ``study.py`` alone."""
    import torch

    from . import flops, program
    from .synthetic import make_tartans
    cfg, traffic, m = dict(s["config"]), s["traffic"], s["model"]
    if dtype is not None:
        cfg["dtype"] = dtype
    marks = {"torch": time.perf_counter()}
    sd = seeds(seed)
    arch = m.architecture(cfg)
    archive = make_tartans(traffic["images"], m.image_size(arch), sd["data"],
                           device)
    marks["data"] = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        np_path = os.path.join(tmp, "tartans.npz")
        np.savez(np_path, images=archive)
        w = m.make_weights(arch, cfg["train"], sd["weights"], device)
        marks["weights"] = time.perf_counter()
        trainer, window = program.run(
            m, cfg, traffic, w, np_path, os.path.join(tmp, "out"),
            sd["trainer"], device, seconds=seconds, trace=trace, fault=fault)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cuda = device.startswith("cuda")
    # what the metric readers read: the cell, the model's counts of a step
    # (``counts(r1)``), the window, the traced steps after it and their
    # trace
    run = SimpleNamespace(
        cell=s["cell"], cfg=cfg, traffic=traffic, arch=arch,
        counts=functools.partial(flops.counts, m, arch,
                                 traffic["batch_size"]),
        steps=window.steps, step_r1=window.step_r1,
        window_s=window.t1 - window.t0, setup_s=window.t0 - START,
        images=window.steps * traffic["batch_size"],
        memory_peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
        trace_r1=window.trace_r1, trace=None)
    marks.update(window.marks)
    run.setup_marks = {k: v - START for k, v in marks.items()}
    first = traffic["warm_steps"]
    done = window.steps + len(window.trace_r1)
    losses = torch.stack([torch.stack([v.float() for v in trainer.logs[k]
                                       [first:first + done]])
                          for k in ("d_loss", "g_loss")])
    run.failed = int((~losses.isfinite().all(0)).sum())
    if trace:
        from .trace import Trace
        run.trace = Trace(window.prof, window.trace_t0_ns,
                          window.trace_t1_ns)
    prog = dict(window.records)
    prog["fed"] = trainer.fed
    del trainer, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run, prog, (archive, w)


def _on(draws: dict, device) -> dict:
    return {k: v.to(device) for k, v in draws.items()}


def reference_steps(s: dict, w: dict, batches: list, draws: list,
                    device: str, quant=None, dtype=None) -> dict:
    """The model's reference's steps on the given batches (uint8 NHWC,
    host) and draws (one dict a step); its losses, first gradients and
    state after the first step and after all."""
    import torch
    ref = s["model"].reference
    ref.full_float32()
    cfg, traffic = s["config"], s["traffic"]
    hp = cfg["train"]
    trainer = ref.Trainer(s["model"].architecture(cfg), hp, w, device, quant,
                          dtype or torch.float32)
    out = {"losses": []}
    for t, (batch, step_draws) in enumerate(zip(batches, draws)):
        r1 = hp["grad_penalty"] * traffic["r1_interval"] \
            if t % traffic["r1_interval"] == 0 else 0.0
        losses, grads = trainer.step(torch.from_numpy(batch).to(device),
                                     _on(step_draws, device), r1)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if t == 0:
            out["grads"], out["after_1"] = grads, trainer.state()
    out["after"] = trainer.state()
    return out


def g_grads_on(s: dict, w: dict, after_1: dict, draws: dict, device: str,
               dtype=None) -> dict:
    """The reference's first G gradient (float32; ``dtype`` for
    ``study.py``), taken on the D of ``after_1`` (the other side's state
    after step 1: the D that its G step saw) from the weights, at step 1's
    ``draws``."""
    import torch
    ref = s["model"].reference
    ref.full_float32()
    d = {n[2:]: t for n, t in after_1.items() if n.startswith("d.")}
    trainer = ref.Trainer(s["model"].architecture(s["config"]),
                          s["config"]["train"], {"g": w["g"], "d": d},
                          device, dtype=dtype or torch.float32)
    return {n: t.float()
            for n, t in trainer.g_grads(_on(draws, device)).items()}


def before_state(w: dict) -> dict:
    """The weights as ``check.state_of`` names them."""
    out = {f"g.{n}": t for n, t in w["g"].items()}
    out.update({f"d.{n}": t for n, t in w["d"].items()})
    out.update({f"g_target.{n}": t for n, t in w["g"].items()
                if "running_" not in n})
    return out


def reference_of(s: dict, prog: dict, archive, w, device: str):
    """The reference's side of the check: its steps on the rows the program
    was fed (found in the benchmark's own archive) and the draws the
    program's steps took, and its first G gradient on the program's D
    after step 1. None where the rows fed are not distinct rows of the
    archive."""
    from . import program
    rows = program.rows_of([b for b, _ in prog["fed"]], archive)
    flat = [r for batch in rows for r in batch]
    if None in flat or len(set(flat)) != len(flat):
        return None
    draws = [d for _, d in prog["fed"]]
    ref = reference_steps(s, w, [archive[r] for r in rows], draws, device)
    ref["g_grads_on_prog"] = g_grads_on(s, w, prog["after_1"], draws[0],
                                        device)
    ref["before"] = prog["before"] = before_state(w)
    return ref


def held(s: dict, prog: dict, archive, w, device: str) -> dict:
    """The check: ``numbers`` (``check.compare``'s), ``correct`` and,
    where the feed was wrong, ``why``."""
    from . import check
    ref = reference_of(s, prog, archive, w, device)
    if ref is None:
        return {"correct": False, "numbers": {k: float("nan")
                                              for k in check.NUMBERS},
                "why": "the rows fed are not distinct rows of the archive"}
    numbers = check.compare(prog, ref)
    return {"numbers": numbers,
            "correct": check.judge(numbers, s["limits"])}


def run_cell(s: dict, seed: int, seconds: float, trace: bool,
             device: str, fault=None) -> tuple:
    """One run of cell ``s``: (result dict, check dict, run record)."""
    import torch
    run, prog, (archive, w) = train(s, seed, seconds, trace, device, fault)
    metrics = {}
    for m in (s["per_layer"] if trace else s["end_to_end"]):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t0 = time.perf_counter()
    res = held(s, prog, archive, w, device)
    run.check_s = time.perf_counter() - t0
    device_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if device.startswith("cuda") else "cpu"),
                   "count": s["cell"]["chips"],
                   "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": bool(res["correct"]) and run.failed == 0,
              "attempted": run.steps, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {k: {"value": finite(res["numbers"][k]),
                            "limit": s["limits"][k]}
                        for k in res["numbers"]}
    return result, res, run


def finite(x):
    """x, or None where it is not a finite number (JSON has no NaN)."""
    return x if x == x and abs(x) != float("inf") else None


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    s = spec(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < s["cell"]["chips"]):
        print(f"portbench: {args.workload} needs {s['cell']['chips']} CUDA "
              "device(s); none or too few here", file=sys.stderr)
        return 2
    result, res, run = run_cell(s, args.seed, args.seconds,
                                bool(args.trace), "cuda")
    print("portbench: set-up (s from the start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_marks.items()), file=sys.stderr)
    if run.trace is not None:
        slower = (run.trace.window_s / len(run.trace_r1)) / (
            run.window_s / run.steps)
        print(f"portbench: traced {len(run.trace_r1)} steps, each {slower:.3f}"
              f" times as long as the window's; K1 {run.trace.k1_events} and "
              f"K2 {run.trace.k2_events} device events", file=sys.stderr)
    print(f"portbench: the reference and the check took {run.check_s:.3f} s",
          file=sys.stderr)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    if "why" in res:
        print(f"check failed: {res['why']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    if not __package__:  # run as a file: take the package's own module
        from portbench.run import main
    sys.exit(main())
