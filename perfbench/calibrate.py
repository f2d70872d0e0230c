"""Readings that the limits of a cell's check are set from, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2 [--out readings.jsonl]

Runs the cell (set-up, a short window, the staged call, the check) with
the program on each of ``--seeds`` and with the control (the reference,
one precision below what the configuration states) on each of
``--control-seeds``, and prints every number the check compares: one JSON
line a run, then the largest reading of the program and the smallest of
the control for each number. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of the cell's kind in the program "
                         "first (perfbench/faults.py)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import run as runner

    runner.environment()
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    if args.fault:
        from perfbench import faults

        faults.plant(args.fault, args.workload)
    lim = harness.limits(args.workload)
    rows = []
    plan = [("program", s) for s in args.seeds.split(",") if s] + \
           [("control", s) for s in args.control_seeds.split(",") if s]
    for system, seed in plan:
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, int(seed), args.seconds, False,
                               system=system, lim={k: float("inf")
                                                   for k in lim})
        row = {"system": system, "seed": int(seed), "fault": args.fault,
               "numbers": out["_numbers"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "memory_peak_bytes": out["device"]["memory_peak_bytes"],
               "check_s": out["_check_s"],
               "setup_phases": out["_setup_phases"],
               "calls_s": out["_calls_s"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for k in lim:
        prog = [r["numbers"][k] for r in rows if r["system"] == "program"]
        ctrl = [r["numbers"][k] for r in rows if r["system"] == "control"]
        summary[k] = {"program_max": max(prog) if prog else None,
                      "control_min": min(ctrl) if ctrl else None,
                      "limit": lim[k]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
