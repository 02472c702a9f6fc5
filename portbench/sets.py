"""Runs of one cell in a row, each a process of its own as a check makes
them, and the spread of each metric: what the bounds of BENCHMARK.json are
set from.

    python3 portbench/sets.py --workload W --seconds S --seeds N1 N2 ...
        [--trace 0|1] [--sets 2] [--log DIR]

The seeds are used by every set, in the same order. Each run's result line
is printed as ``RUN {...}``; then, per set and metric, the median and the
spread: the distance between the first and the third quartile (Python's
``statistics.quantiles(values, n=4)``) as a share of the median, and the
spread with the run farthest from the median left out.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", default="0")
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--log", default=None)
    args = p.parse_args(argv)
    runs = []
    for k in range(args.sets):
        for seed in args.seeds:
            cmd = [sys.executable, str(HERE / "run.py"), "--workload",
                   args.workload, "--seed", str(seed), "--seconds",
                   args.seconds, "--trace", args.trace]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if args.log:
                log = Path(args.log)
                log.mkdir(parents=True, exist_ok=True)
                stem = f"{args.workload}.{args.trace}.{k}.{seed}"
                (log / f"{stem}.out").write_text(proc.stdout)
                (log / f"{stem}.err").write_text(proc.stderr)
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                result = {"correct": None, "rc": proc.returncode,
                          "stderr": proc.stderr[-2000:]}
            result["set"], result["seed"] = k, seed
            runs.append(result)
            print("RUN " + json.dumps(result), flush=True)
    summary = {}
    for k in range(args.sets):
        done = [r for r in runs if r["set"] == k and r.get("metrics")]
        for name in sorted({m for r in done for m in r["metrics"]}):
            values = [r["metrics"][name]["value"] for r in done
                      if name in r["metrics"]]
            if len(values) < 4:
                continue
            summary.setdefault(name, []).append({
                "median": statistics.median(values),
                "spread": spread(values),
                "spread_trimmed": spread(trimmed(values)),
                "first": values[0], "values": values})
    print("SUMMARY " + json.dumps({
        "workload": args.workload, "seconds": args.seconds,
        "correct": [r["correct"] for r in runs], "metrics": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
