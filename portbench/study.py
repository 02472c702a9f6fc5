"""Readings of the check's numbers over many seeds, from which
``limits/<workload>.json`` are set (``PERF.md`` gives them):

    python3 portbench/study.py --workload W --seeds 1 2 3 [--mode M]

``--mode program`` (with ``--dtype bf16|f32`` and ``--fault
unchanged|half_batch|negated_g``) runs the program's set-up steps and
holds them against the reference, as a run does, without a measured
window. ``--mode control`` puts the reference computed in fp8 in the
program's place; ``--mode witness`` the reference in float32 against the
same in float64. The cell's model module gives the data's size, the
weights, the draws and the reference, as it does a run's.
Each seed prints one JSON line (``details``). Needs a CUDA device unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, run  # noqa: E402
from portbench.synthetic import make_tartans  # noqa: E402


def _leaf_differences(prog: dict, ref: dict) -> dict:
    """leaf -> [|prog - ref| / max(|ref|, the median leaf's |ref|), |prog|,
    |ref|] over the leaves of ``ref`` that ``check.moved`` keeps."""
    names = check.moved(ref)
    norm = lambda t: float(t.double().norm())  # noqa: E731
    med = statistics.median(norm(ref[n]) for n in names)
    return {n: [norm(prog[n].float() - ref[n].float())
                / max(norm(ref[n]), med, 1e-30),
                norm(prog[n]), norm(ref[n])] for n in names}


def details(prog: dict, ref: dict) -> dict:
    """The check's numbers with what a reader of the seed study needs:
    each step's losses on both sides, each gradient leaf's difference and
    each leaf's gap of the norms of its change, with the norms they are
    taken from, and the worst of each."""
    grads = {"g": _leaf_differences(prog["grads"]["g"],
                                    ref["g_grads_on_prog"]),
             "d": _leaf_differences(prog["grads"]["d"], ref["grads"]["d"])}
    change = check.change_leaves(prog, ref)
    worst = {f"{k}_grad": max(v.items(), key=lambda kv: kv[1][0])
             for k, v in grads.items()}
    worst["change"] = max(change.items(), key=lambda kv: kv[1])
    return {"numbers": check.compare(prog, ref), "worst": worst,
            "losses": [{k: [lp[k], lr[k]] for k in lp}
                       for lp, lr in zip(prog["losses"], ref["losses"])],
            "grad_leaves": grads, "change_leaves": change}


def program_reading(s, seed, device, dtype, fault):
    _, prog, (archive, w) = run.train(s, seed, 0.0, False, device, fault,
                                      dtype)
    return details(prog, run.reference_of(s, prog, archive, w, device))


def inputs(s, seed, device):
    """The weights, rows and draws of a run's check, made by the benchmark
    alone (for the readings without the program)."""
    cfg, traffic, m = s["config"], s["traffic"], s["model"]
    sd = run.seeds(seed)
    arch = m.architecture(cfg)
    archive = make_tartans(traffic["images"], m.image_size(arch), sd["data"],
                           device)
    w = m.make_weights(arch, cfg["train"], sd["weights"], device)
    b, n = traffic["batch_size"], traffic["check_steps"]
    order = np.random.default_rng(sd["trainer"]).permutation(len(archive))
    batches = [archive[order[i * b:(i + 1) * b]] for i in range(n)]
    gen = torch.Generator(device=device).manual_seed(sd["trainer"])
    draws = [m.draws(gen, b, arch, device) for _ in range(n)]
    return w, batches, draws


def pair_reading(s, seed, device, mode):
    """Side a, the reference in fp8 (``control``) or in float32
    (``witness``), in the program's place against side b, the reference
    in float32 or in float64."""
    w, batches, draws = inputs(s, seed, device)
    if mode == "control":
        a = run.reference_steps(s, w, batches, draws, device,
                                s["model"].reference.fp8)
        b = run.reference_steps(s, w, batches, draws, device)
    else:
        a = run.reference_steps(s, w, batches, draws, device)
        b = run.reference_steps(s, w, batches, draws, device,
                                dtype=torch.float64)
        b["grads"] = {k: {n: t.float() for n, t in v.items()}
                      for k, v in b["grads"].items()}
        b["after"] = {n: t.float() for n, t in b["after"].items()}
    b["g_grads_on_prog"] = run.g_grads_on(
        s, w, a["after_1"], draws[0], device,
        torch.float64 if mode == "witness" else None)
    a["before"] = b["before"] = run.before_state(w)
    return details(a, b)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=("program", "control", "witness"),
                   default="program")
    p.add_argument("--dtype", choices=("bf16", "f32"), default=None)
    p.add_argument("--fault", choices=("unchanged", "half_batch",
                                        "negated_g"), default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    s = run.spec(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode == "program":
            out = program_reading(s, seed, args.device, args.dtype,
                                  args.fault)
        else:
            out = pair_reading(s, seed, args.device, args.mode)
        out = {"workload": args.workload, "mode": args.mode,
               "dtype": args.dtype or s["config"]["dtype"],
               "fault": args.fault, "seed": seed,
               "seconds": time.perf_counter() - t0, **out}
        print("STUDY " + json.dumps(out), flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
