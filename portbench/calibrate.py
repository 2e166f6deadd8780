"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3
                                   [--control 3] [--seconds 2]

runs the cell once a seed in this one process (the benchmark's own path,
with a short window) and prints one JSON line a seed: the run's own numbers
(``checks``) and, for the first ``--control`` seeds, those of the control
and of the planted faults (``calibration``). Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from . import run


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    print(json.dumps({"card": card()}), flush=True)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.time()
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           calibrate=k < args.control, t_start=t)
        print(json.dumps({"seed": seed, "checks": out["checks"],
                          "calibration": out.get("calibration"),
                          "metrics": out["metrics"],
                          "seconds": time.time() - t}), flush=True)
    bad = run.forbidden_modules()
    if bad:
        print("loaded: " + ", ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
