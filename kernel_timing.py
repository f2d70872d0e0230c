"""Device time of the packed-sign Gram and the per-symbol encode kernels,
and time to tree of the runs that reach them, on one CUDA card, for one
or more copies of the port's package, run in turns.

  python3 kernel_timing.py --src build/ab/parent/src --src src --turns 2

Each turn runs every ``--src`` in order (every other turn in reverse, so
two sources run A, B, B, A), each in a fresh process that imports
``repro_torch`` from that directory. At the main path's shapes (d = 4096
features, n = 2^18 samples) the process measures, as CUDA-event medians
of 5 calls after one warm-up (``chip_smoke.py``'s ``event_ms``):

- ``sign_corr_packed_ms``: the packed sign Gram (random bits, the
  wire's zero bits past n);
- ``quantize_ms``: ``quantize_fused`` on x of (n, d) f32 from N(0, 1),
  codes only at R = 1, 2, 4, 7, and with the values or the packed bytes
  at R = 4 (and packed at R = 1, 2);
- ``time_to_tree_s``: ``learn_structure`` wall seconds (synchronised) of
  the sign run on the packed wire and the per-symbol runs at R = 4, 2
  (packed wire) and 1, as ``chip_smoke.py`` phase 4 runs them, twice
  each in a row.

Prints the card's name and power limit, then one JSON line a process.
"""
from __future__ import annotations

import statistics
import sys
import time

D, N, REPS = 4096, 1 << 18, 5
STRATEGIES = (dict(method="sign", wire="packed"),
              dict(method="persymbol", rate=4),
              dict(method="persymbol", rate=2, wire="packed"),
              dict(method="persymbol", rate=1))


def measure(src: str) -> dict:
    import torch

    from repro_torch.configs import PRODUCTION
    from repro_torch.core.chow_liu import learn_structure
    from repro_torch.core.quantizers import pack_codes
    from repro_torch.core.strategy import Strategy
    from repro_torch.data import GGMDataset
    from repro_torch.kernels import quantize_fused, sign_corr_packed

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bits = torch.randint(0, 2, (D, N), generator=gen, device="cuda",
                         dtype=torch.uint8)
    p = pack_codes(bits, 1)
    del bits
    out = {"src": src,
           "sign_corr_packed_ms": event_ms(lambda: sign_corr_packed(p, N))}
    del p
    x = torch.randn((N, D), generator=gen, device="cuda")
    q = {}
    for rate in (1, 2, 4, 7):
        q[f"R{rate}"] = event_ms(lambda: quantize_fused(x, rate))
    q["R4_values"] = event_ms(lambda: quantize_fused(x, 4, values=True))
    for rate in (1, 2, 4):
        q[f"R{rate}_pack"] = event_ms(lambda: quantize_fused(x, rate,
                                                             pack=True))
    out["quantize_ms"] = q
    del x
    torch.cuda.empty_cache()

    ds = GGMDataset(d=D, seed=PRODUCTION.seed)
    xs = ds.sample(N, batch_seed=1, device="cuda")
    ttt = {}
    for fields in STRATEGIES:
        s = Strategy(**fields)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learn_structure(xs, strategy=s)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ttt[f"{s.label}/{s.wire}"] = walls
    out["time_to_tree_s"] = ttt
    return out


if __name__ == "__main__":
    from decode_timing import run_in_turns

    sys.exit(run_in_turns(measure, __file__, __doc__))
