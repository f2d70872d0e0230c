"""One run of one benchmark cell on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last, ``checks``: each number the check compared beside its
limit, which also end standard error; before them standard error gives
the set-up's phases (seconds each) and the window's call times. Exits
non-zero, printing no result, without a card, when the program cannot be
imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench-cache"


def environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    set before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("REPRO_TORCH_GRAM_AUTOTUNE_CACHE",
                      "gram_autotune.json")):
        os.environ[var] = str(CACHE / sub)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    from perfbench import harness

    bench = harness.benchmark()
    chips = int(harness.cell(bench, args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t0=T0,
                           bench=bench)
    out.pop("_numbers", None)
    phases = out.pop("_setup_phases")
    print("perfbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items()), file=sys.stderr)
    calls = sorted(out.pop("_calls_s"))
    print(f"perfbench: {len(calls)} calls of {calls[0]:.4f} / "
          f"{calls[len(calls) // 2]:.4f} / {calls[-1]:.4f} s (least / "
          f"median / most); the check took {out.pop('_check_s'):.3f} s",
          file=sys.stderr)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
