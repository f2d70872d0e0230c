#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port (``src/repro_torch``) runs on one card.

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, learns the Chow-Liu tree at the
production size (d = 4096 features, n = 2^20 samples, the sign method on
the int8 wire) and at n = 2^18 for the other wires and methods, and checks
that the card and the CPU give the same edge lists. Then it serves
granite-8b at full width in bf16 (random weights from a seed; batch 8,
2048-token prompts, 32 greedy tokens) through the flash-prefill and
flash-decode kernels, and checks a small GQA model's greedy decode on the
card against the CPU. Any failed check exits non-zero. The last three
lines of standard output are the card's name and power limit, one JSON
object per kernel ({"kernels": [...]}) and {"ok": true, "device": {...}}.
Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 494.7e12
F32_OPS_PER_S = 67e12

MAIN_N = 1 << 20          # PRODUCTION samples (sign, int8 wire)
CUT_N = 1 << 18           # the other strategies, cut to keep the run short
D = 4096
CHECK_N = 1 << 16         # kernel checks at the main path's width

# The LM serving run: granite-8b at full width, uncut.
SERVE_ARCH = "granite-8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 32
#: f32 kernel against its f32 plain version: sums in another order
ATTN_F32_ATOL = 3e-5
#: bf16: the output is rounded once to bf16 (2^-8 relative) after f32 sums
#: in another order, so one bf16 ulp may differ
ATTN_BF16_TOL = dict(atol=1e-2, rtol=2 ** -7)


class SmokeFailure(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


def timed(fn):
    """(result, seconds) of fn() ending in a device synchronize."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch

    fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Device time of one fn() call in ms: the kernels' time that
    torch.profiler records over ``reps`` calls (after one warm-up), summed
    over every kernel a call launches, over ``reps``. Unlike event_ms it
    leaves out the host's time to issue a call, which sets the pace of a
    call whose kernels take tens of microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total = sum(getattr(e, "self_device_time_total", 0) or 0
                for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", "")))
    expect(total > 0, "the profiler saw no device time")
    return total / reps / 1e3


def make_record(phase, name, source, replaces, shape, ms, plain_ms,
                library_ms, bytes_moved, ops, op_rate, max_abs_err):
    """One kernel's entry of the JSON line; bound_ms is the larger of its
    bytes over the HBM rate and its operations over ``op_rate``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    rec = {"name": name, "ok": True, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{source}",
           "replaces": replaces, "shape": shape, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": max_abs_err}
    log(f"{phase} {name} {shape}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']})")
    return rec


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def _signs(gen, shape, dev):
    import torch

    u = torch.randint(0, 2, shape, generator=gen, device=dev,
                      dtype=torch.int8)
    return u.mul_(2).sub_(1)


def _packed(gen, shape_bits, dev):
    """Random sign bits (..., d, n) packed feature-major, bits >= n zero."""
    import torch
    from repro_torch.core.quantizers import pack_codes

    bits = torch.randint(0, 2, shape_bits, generator=gen, device=dev,
                         dtype=torch.uint8)
    pad = (-shape_bits[-1]) % 8
    return pack_codes(torch.nn.functional.pad(bits, (0, pad)), 1)


def _random_bytes(gen, shape, dev):
    """Random packed bytes: every bit random, those beyond n too."""
    import torch

    return torch.randint(0, 256, shape, generator=gen, device=dev,
                         dtype=torch.uint8)


def _codes(gen, shape, rate, dev):
    import torch

    return torch.randint(-1, 1 << rate, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def code_tolerance(n: int, plain):
    """|kernel - plain| allowed for code_corr: the kernel sums 3xTF32
    products on the tensor cores in 128-sample partials and those in f32
    (compensated), the plain version in f64 rounded once."""
    return 1e-5 * n + 1e-5 * plain.abs()


def check_kernels(dev, gen, main_n, cut_n, check_n, d, reps):
    """Correctness cases of all four kernels, then the main-path timings.

    Returns the per-kernel records of the JSON line (without launches)."""
    import torch
    from repro_torch.core.gram import GramEngine
    from repro_torch.core.quantizers import PerSymbolQuantizer, codebook_tensors
    from repro_torch.kernels import (code_corr, quantize_fused, ref, sign_corr,
                                     sign_corr_packed)

    cases = {k: 0 for k in ("sign_corr", "sign_corr_packed", "code_corr",
                            "quantize_fused")}

    def same(name, got, want, what):
        expect(torch.equal(got, want), f"{name} differs from its plain "
               f"version: {what}")
        cases[name] += 1

    # sign_corr: single, batched, rectangular, column slice, main width;
    # rows off 16 bytes (d = 20, 37: the transpose reads global memory)
    # and on them (d = 144, 272: TMA); n off the 128-sample stage
    for shape_l, shape_r in [((1000, 20), None), ((3, 1000, 20), None),
                             ((1000, 20), (1000, 37)),
                             ((3, 1000, 20), (3, 1000, 37)),
                             ((2, 999, 144), (2, 999, 272)),
                             ((129, 272), None),
                             ((check_n, d), None)]:
        u = _signs(gen, shape_l, dev)
        v = None if shape_r is None else _signs(gen, shape_r, dev)
        same("sign_corr", sign_corr(u, v), ref.sign_corr_ref(u, v),
             f"{shape_l} x {shape_r}")
    wide = _signs(gen, (1000, 45), dev)
    same("sign_corr", sign_corr(wide[:, 5:25], wide[:, 3:40]),
         ref.sign_corr_ref(wide[:, 5:25], wide[:, 3:40]), "column slices")
    wide = _signs(gen, (1001, 300), dev)
    same("sign_corr", GramEngine(backend="kernel", d_tile=100).gram(wide),
         ref.sign_corr_ref(wide), "d_tile=100 blocks")

    # sign_corr_packed: n not a multiple of 8 or of the 128-sample stage,
    # batched, rectangular; bits beyond n zero (the wire's) and random
    # (the unpack zeroes them); byte widths off 16 (1, 17, 125, 126, 500:
    # the wrapper pads them) and on them (16); d = 20, 37, 144, 272
    for n, dl, dr, b in [(1000, 20, None, None), (997, 20, None, None),
                         (1003, 20, 37, None), (997, 20, None, 3),
                         (1000, 20, 37, 3), (1, 144, 272, None),
                         (127, 37, None, 2), (128, 144, None, None),
                         (129, 272, 144, 2), (4000, 144, 272, None),
                         (check_n, d, None, None)]:
        lead = () if b is None else (b,)
        p = _packed(gen, (*lead, dl, n), dev)
        q = None if dr is None else _packed(gen, (*lead, dr, n), dev)
        same("sign_corr_packed", sign_corr_packed(p, n, q),
             ref.sign_corr_packed_ref(p, n, q), f"n={n} d={dl}x{dr} b={b}")
        p = _random_bytes(gen, p.shape, dev)
        q = None if q is None else _random_bytes(gen, q.shape, dev)
        same("sign_corr_packed", sign_corr_packed(p, n, q),
             ref.sign_corr_packed_ref(p, n, q),
             f"n={n} d={dl}x{dr} b={b}, random bits beyond n")
    wide = _random_bytes(gen, (300, 80), dev)
    same("sign_corr_packed", sign_corr_packed(wide[:, 3:70], 500),
         ref.sign_corr_packed_ref(wide[:, 3:70], 500), "byte slice")
    same("sign_corr_packed",
         GramEngine(backend="kernel", d_tile=100).packed_sign_gram(wide, 633),
         ref.sign_corr_packed_ref(wide, 633), "d_tile=100 blocks")

    # code_corr: -1 sentinels at R = 2, 4, 7; batched, rectangular; rows
    # off 16 bytes (d = 20, 37: element loads) and on them (d = 144, 256,
    # 272: TMA); n not a multiple of the 32-sample stage or of the
    # 128-sample partial, and a single stage; column slices at offsets off
    # 16 bytes, alone and as GramEngine's d_tile blocks
    def code_case(c, cb, c2=None, what=""):
        got, want = code_corr(c, cb, c2), ref.code_corr_ref(c, cb, c2)
        err = (got - want).abs()
        expect(bool((err <= code_tolerance(c.shape[-2], want)).all()),
               f"code_corr {what} {tuple(c.shape)}x"
               f"{None if c2 is None else tuple(c2.shape)}: max |err| "
               f"{float(err.max())}")
        cases["code_corr"] += 1

    for rate in (2, 4, 7):
        cb = torch.as_tensor(PerSymbolQuantizer(rate).centroids_np,
                             device=dev)
        for shape_l, shape_r in [((1000, 20), None), ((3, 1000, 20), None),
                                 ((1000, 20), (1000, 37)),
                                 ((3, 1000, 20), (3, 1000, 37)),
                                 ((4133, 256), None), ((7, 256), None),
                                 ((2, 999, 144), (2, 999, 272))]:
            c = _codes(gen, shape_l, rate, dev)
            c2 = None if shape_r is None else _codes(gen, shape_r, rate, dev)
            code_case(c, cb, c2, f"R={rate}")
        wide = _codes(gen, (1001, 300), rate, dev)
        code_case(wide[:, 5:133], cb, wide[:, 40:290],
                  f"R={rate} column slices")
        want = ref.code_corr_ref(wide, cb)
        err = (GramEngine(backend="kernel", d_tile=100).code_gram(wide, cb)
               - want).abs()
        expect(bool((err <= code_tolerance(1001, want)).all()),
               f"code_corr R={rate} in d_tile=100 blocks: max |err| "
               f"{float(err.max())}")
        cases["code_corr"] += 1
    cb4 = torch.as_tensor(PerSymbolQuantizer(4).centroids_np, device=dev)
    c = _codes(gen, (check_n, d), 4, dev)
    code_case(c, cb4, None, "at main width")

    # quantize_fused: +-inf, NaN, +-0.0 and exact boundaries at R = 1..7
    for rate in range(1, 8):
        bounds, cents = codebook_tensors(rate, dev)
        x = torch.randn((257, 64), generator=gen, device=dev)
        x[0, :5] = torch.tensor([float("inf"), -float("inf"), float("nan"),
                                 0.0, -0.0])
        x[1, :bounds.numel()] = bounds[:64]
        x[2, :bounds.numel()] = torch.nextafter(
            bounds, torch.tensor(float("inf"), device=dev))[:64]
        # f32 subnormals encode as 0.0 does (repro's XLA flushes them)
        x[3, :6] = torch.tensor([1e-45, -1e-45, 1e-40, -1e-40, 0.0, -0.0])
        pack = 8 % rate == 0
        got = quantize_fused(x, rate, values=True, pack=pack)
        want = ref.quantize_fused_ref(x, bounds, cents, rate, values=True,
                                      pack=pack)
        expect(bool((got[0][3, :6] == got[0][3, 4]).all()),
               f"quantize_fused R={rate}: a subnormal encodes unlike 0.0")
        for g_, w_, what in zip(got, want, ("codes", "values", "packed")):
            same("quantize_fused", g_, w_, f"R={rate} {what}")
    # views at an offset of 1..3 elements (off 16 bytes) and totals of
    # 0..3 mod 4 over several of the kernel's 4096-element tiles, R = 1..7
    flat = torch.randn(70000, generator=gen, device=dev)
    for rate in range(1, 8):
        bounds, cents = codebook_tensors(rate, dev)
        group = 8 // rate if 8 % rate == 0 else 1
        for off, total in ((1, 12289), (2, 16386), (3, 8195), (0, 40963),
                           (3, 65536)):
            total -= total % group
            x = flat[off:off + total].view(-1, group)
            got = quantize_fused(x, rate, values=True, pack=group > 1)
            want = ref.quantize_fused_ref(x, bounds, cents, rate,
                                          values=True, pack=group > 1)
            for g_, w_, what in zip(got, want, ("codes", "values", "packed")):
                same("quantize_fused", g_, w_,
                     f"R={rate} offset {off} total {total} {what}")
    xm = torch.randn((check_n, d), generator=gen, device=dev)
    b4, _ = codebook_tensors(4, dev)
    same("quantize_fused", quantize_fused(xm, 4), ref.encode_ref(xm, b4),
         "codes at main width")
    del xm, c, got, want, err, wide, flat
    log("phase 3 correctness cases:", json.dumps(cases))

    # -- timings at the main path's shapes --------------------------------
    records = []

    def record(*args):
        records.append(make_record("phase 3", *args))

    # sign_corr at PRODUCTION: n = 2^20, d = 4096, int8
    u = _signs(gen, (main_n, d), dev)
    g = sign_corr(u)
    same("sign_corr", g, ref.sign_corr_ref(u), "main-path shape")
    ms = event_ms(lambda: sign_corr(u), reps)
    plain = event_ms(lambda: ref.sign_corr_ref(u), reps)
    ut = u.t().contiguous()
    lib = torch._int_mm(ut, u)
    expect(torch.equal(lib.to(torch.float32), g),
           "torch._int_mm disagrees with sign_corr")
    library = event_ms(lambda: torch._int_mm(ut, u), reps)
    log(f"phase 3 sign_corr n={main_n} d={d}: kernel {ms:.4f} ms, "
        f"torch._int_mm {library:.4f} ms")
    record("sign_corr", "sign_corr.cu",
           "src/repro/kernels/sign_corr.py:113", f"n={main_n} d={d} int8",
           ms, plain, library, main_n * d + d * d * 4, 2 * main_n * d * d,
           INT8_TENSOR_OPS_PER_S, 0.0)
    del u, ut, g, lib

    # sign_corr_packed at n = 2^18, d = 4096
    p = _packed(gen, (d, cut_n), dev)
    g = sign_corr_packed(p, cut_n)
    same("sign_corr_packed", g, ref.sign_corr_packed_ref(p, cut_n),
         "main-path shape")
    ms = event_ms(lambda: sign_corr_packed(p, cut_n), reps)
    plain = event_ms(lambda: ref.sign_corr_packed_ref(p, cut_n), reps)
    # yardstick: the library's int8 matmul of the signs already unpacked
    # to +-1 bytes (the unpack left out), as code_corr's row times the
    # matmul of the decoded codes
    ut = ref.unpack_signs_pm1(p, cut_n).to(torch.int8)
    u = ut.t().contiguous()
    expect(torch.equal(torch._int_mm(ut, u).to(torch.float32), g),
           "torch._int_mm disagrees with sign_corr_packed")
    library = event_ms(lambda: torch._int_mm(ut, u), reps)
    log(f"phase 3 sign_corr_packed n={cut_n} d={d}: kernel {ms:.4f} ms, "
        f"torch._int_mm of the unpacked +-1 bytes {library:.4f} ms")
    # the Gram of the unpacked signs on the int8 tensor cores
    record("sign_corr_packed", "sign_corr_packed.cu",
           "src/repro/kernels/sign_corr.py:278",
           f"n={cut_n} d={d} packed", ms, plain, library,
           p.numel() + d * d * 4, 2 * cut_n * d * d, INT8_TENSOR_OPS_PER_S,
           0.0)
    del p, g, ut, u

    # code_corr at n = 2^18, d = 4096: R = 2 and 7 (where the accumulation
    # error is largest) checked, R = 4 (the main path's) checked and timed;
    # beside the kernel's error, that of the library's f32 matmul (no TF32)
    for rate in (2, 7, 4):
        cb = torch.as_tensor(PerSymbolQuantizer(rate).centroids_np,
                             device=dev)
        c = _codes(gen, (cut_n, d), rate, dev)
        g = code_corr(c, cb)
        want = ref.code_corr_ref(c, cb)
        err = (g - want).abs()
        expect(bool((err <= code_tolerance(cut_n, want)).all()),
               f"code_corr at n={cut_n} d={d} R={rate}: max |err| "
               f"{float(err.max())}")
        cases["code_corr"] += 1
        max_err = float(err.max())
        dec = ref.decode_codes(c, cb)
        lib_err = float((torch.matmul(dec.t(), dec) - want).abs().max())
        del want, err, g
        log(f"phase 3 code_corr n={cut_n} d={d} R={rate}: max |kernel - "
            f"plain| {max_err} max |torch.matmul - plain| {lib_err}")
        if rate == 4:
            ms = event_ms(lambda: code_corr(c, cb), reps)
            plain = event_ms(lambda: ref.code_corr_ref(c, cb), reps)
            library = event_ms(lambda: torch.matmul(dec.t(), dec), reps)
            # 3xTF32: three TF32 products per code pair
            record("code_corr", "code_corr.cu",
                   "src/repro/kernels/sign_corr.py:190",
                   f"n={cut_n} d={d} R=4 int8 codes", ms, plain, library,
                   c.numel() + 16 * 4 + d * d * 4, 3 * 2 * cut_n * d * d,
                   TF32_TENSOR_OPS_PER_S, max_err)
            records[-1]["library_max_abs_err"] = lib_err
        del c, dec

    # quantize_fused at n = 2^18, d = 4096: R = 7 and 1 checked and timed
    # (the deepest and the shallowest search), R = 4 (the main path's)
    # checked, timed and recorded; codes only
    x = torch.randn((cut_n, d), generator=gen, device=dev)
    by_rate = {}
    for rate in (7, 1):
        br, _ = codebook_tensors(rate, dev)
        same("quantize_fused", quantize_fused(x, rate), ref.encode_ref(x, br),
             f"main-path shape R={rate}")
        by_rate[rate] = event_ms(lambda: quantize_fused(x, rate), reps)
    log(f"phase 3 quantize_fused n={cut_n} d={d} codes: R=7 "
        f"{by_rate[7]:.4f} ms, R=1 {by_rate[1]:.4f} ms")
    same("quantize_fused", quantize_fused(x, 4), ref.encode_ref(x, b4),
         "main-path shape")
    ms = event_ms(lambda: quantize_fused(x, 4), reps)
    plain = event_ms(lambda: ref.encode_ref(x, b4), reps)
    # torch.bucketize (right=False) counts the boundaries strictly below x:
    # the same codes, as int64, for every non-NaN, non-subnormal x
    expect(torch.equal(torch.bucketize(x, b4).to(torch.int8),
                       quantize_fused(x, 4)),
           "torch.bucketize disagrees with quantize_fused")
    library = event_ms(lambda: torch.bucketize(x, b4), reps)
    # operations: the R = 4 compares of the binary search a symbol
    record("quantize_fused", "quantize.cu",
           "src/repro/kernels/quantize.py:81",
           f"n={cut_n} d={d} R=4 codes", ms, plain, library,
           x.numel() * 5 + (15 + 16) * 4, 4 * x.numel(), F32_OPS_PER_S, 0.0)
    del x
    return records


# ---------------------------------------------------------------------------
# Phases 4-5: the main path
# ---------------------------------------------------------------------------

#: (strategy fields, kernels it must launch) of the cut-n runs
CUT_STRATEGIES = (
    (dict(method="sign", wire="packed"), ("sign_corr_packed",)),
    (dict(method="persymbol", rate=4), ("quantize_fused", "code_corr")),
    (dict(method="persymbol", rate=2, wire="packed"),
     ("quantize_fused", "code_corr")),
    (dict(method="persymbol", rate=1), ("quantize_fused", "sign_corr")),
    (dict(method="original"), ()),
)


def run_main_path(dev, d, main_n, cut_n):
    """learn_structure at PRODUCTION and at the cut n; returns the summed
    launch counts of these runs (counts reset before each, read after)."""
    import torch
    from repro_torch.configs import PRODUCTION
    from repro_torch.core import estimators
    from repro_torch.core.chow_liu import (adjacency_to_edges, boruvka_mst,
                                           learn_structure)
    from repro_torch.core.strategy import Strategy
    from repro_torch.core.trees import is_tree, tree_edit_distance
    from repro_torch.data import GGMDataset
    from repro_torch.kernels import launches, reset_launches

    total = {k: 0 for k in launches()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    ds = GGMDataset(d=d, seed=PRODUCTION.seed)
    truth, _ = ds.structure()
    torch.cuda.reset_peak_memory_stats()
    x, t_sample = timed(lambda: ds.sample(main_n, device=dev))
    s = Strategy(method=PRODUCTION.method)
    reset_launches()
    est, t_total = timed(lambda: learn_structure(x, strategy=s))
    counts = launches()
    add(counts)
    expect(counts["sign_corr"] > 0, "the PRODUCTION run launched no "
           "sign_corr")
    expect(is_tree(d, est), "the PRODUCTION result is not a spanning tree")
    # the same run stage by stage, for the breakdown
    payload, t_enc = timed(lambda: estimators.strategy_payload(x, s))
    del x
    gram, t_gram = timed(lambda: estimators.payload_gram(payload, s))
    del payload
    w, t_w = timed(lambda: estimators.weights_from_gram(gram, main_n, s))
    adj, t_mst = timed(lambda: boruvka_mst(w))
    expect(adjacency_to_edges(adj) == est,
           "the staged PRODUCTION run disagrees with learn_structure")
    peak = torch.cuda.max_memory_allocated()
    del gram, w, adj
    log(f"phase 4 PRODUCTION d={d} n={main_n} sign/int8/boruvka: "
        f"sample_s={t_sample:.4f} learn_structure_s={t_total:.4f} "
        f"encode_s={t_enc:.4f} gram_s={t_gram:.4f} weights_s={t_w:.4f} "
        f"mwst_s={t_mst:.4f} edit_distance={tree_edit_distance(est, truth)} "
        f"peak_bytes={peak} launches={json.dumps(counts)}")

    torch.cuda.empty_cache()
    x = ds.sample(cut_n, batch_seed=1, device=dev)
    for fields, must in CUT_STRATEGIES:
        s = Strategy(**fields)
        reset_launches()
        est, t = timed(lambda: learn_structure(x, strategy=s))
        counts = launches()
        add(counts)
        for k in must:
            expect(counts[k] > 0, f"{s.label}/{s.wire} launched no {k}")
        expect(is_tree(d, est), f"{s.label}/{s.wire}: not a spanning tree")
        log(f"phase 4 d={d} n={cut_n} (cut from 2^20 to keep the run "
            f"short) {s.label}/{s.wire}: learn_structure_s={t:.4f} "
            f"edit_distance={tree_edit_distance(est, truth)} "
            f"launches={json.dumps(counts)}")
    return total


def card_vs_cpu(dev, d, n):
    """The same samples through the kernels on the card and through their
    plain versions on the CPU give identical edge lists."""
    from repro_torch.core.chow_liu import learn_structure
    from repro_torch.core.gram import GramEngine
    from repro_torch.core.strategy import Strategy
    from repro_torch.data import GGMDataset

    x = GGMDataset(d=d, seed=1).sample(n, device=dev)
    xc = x.cpu()
    eng = GramEngine(backend="kernel")
    for fields in ({}, *(f for f, _ in CUT_STRATEGIES)):
        s = Strategy(**fields)
        on_card = learn_structure(x, strategy=s, engine=eng)
        on_cpu = learn_structure(xc, strategy=s, engine=eng)
        expect(on_card == on_cpu, f"card and CPU edge lists differ for "
               f"{s.label}/{s.wire} at d={d} n={n}")
    log(f"phase 5 card == CPU edge lists at d={d} n={n} for "
        f"{1 + len(CUT_STRATEGIES)} strategies")


# ---------------------------------------------------------------------------
# Phases 6-8: the LM serving path (flash_prefill, decode_attention)
# ---------------------------------------------------------------------------

def _attn_close(got, want, what):
    """Hold an attention kernel's output to its plain version: f32 within
    ATTN_F32_ATOL, bf16 within ATTN_BF16_TOL. Returns max |error|."""
    import torch

    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        ok = bool((err <= ATTN_F32_ATOL).all())
    else:
        tol = ATTN_BF16_TOL["atol"] + ATTN_BF16_TOL["rtol"] * want.float().abs()
        ok = bool((err <= tol).all())
    expect(ok and bool(torch.isfinite(got).all()),
           f"{what}: max |kernel - plain| {float(err.max())}")
    return float(err.max())


def check_prefill_bf16_edges(dev, rnd):
    """The bf16 (tensor-core) flash_prefill at its edges, against its plain
    version within ATTN_BF16_TOL: every head size at lengths that are not
    multiples of 16 or 64, Sq != Skv, G = 48, a window shorter than a key
    tile, strided and 16-byte-unaligned operands, and rows that see no key
    (exactly 0). Returns the number of cases."""
    import torch
    from repro_torch.kernels import flash_prefill, ref
    from repro_torch.kernels.flash_prefill import HEAD_DIMS

    bf = torch.bfloat16
    n = 0

    def check(q, k, v, causal, window, what):
        nonlocal n
        got = flash_prefill(q, k, v, causal=causal, window=window)
        _attn_close(got, ref.flash_prefill_ref(q, k, v, causal=causal,
                                               window=window),
                    f"flash_prefill bf16 {what} causal={causal} "
                    f"window={window}")
        n += 1
        return got

    for dh in HEAD_DIMS:
        for s in (1, 17, 63, 65, 300):
            check(rnd(1, s, 4, dh, dtype=bf), rnd(1, s, 2, dh, dtype=bf),
                  rnd(1, s, 2, dh, dtype=bf), True, 0, f"Dh={dh} S={s}")
    check(rnd(1, 2049, 8, 128, dtype=bf), rnd(1, 2049, 2, 128, dtype=bf),
          rnd(1, 2049, 2, 128, dtype=bf), True, 0, "Dh=128 S=2049")
    for sq, skv in ((200, 130), (130, 200)):   # Sq != Skv, non-causal
        check(rnd(2, sq, 8, 128, dtype=bf), rnd(2, skv, 2, 128, dtype=bf),
              rnd(2, skv, 2, 128, dtype=bf), False, 0, f"Sq={sq} Skv={skv}")
    check(rnd(1, 300, 48, 128, dtype=bf), rnd(1, 300, 1, 128, dtype=bf),
          rnd(1, 300, 1, 128, dtype=bf), True, 0, "G=48")
    check(rnd(1, 300, 4, 64, dtype=bf), rnd(1, 300, 2, 64, dtype=bf),
          rnd(1, 300, 2, 64, dtype=bf), True, 10, "window < a tile")
    q = rnd(1, 100, 4, 129, dtype=bf)[..., 1:]   # rows off 16-byte bounds
    check(q, rnd(1, 100, 2, 128, dtype=bf), rnd(1, 100, 2, 128, dtype=bf),
          True, 30, "unaligned q")
    # Sq > Skv with a window: rows >= Skv + window - 1 see no key
    got = check(rnd(1, 260, 4, 80, dtype=bf), rnd(1, 100, 2, 80, dtype=bf),
                rnd(1, 100, 2, 80, dtype=bf), False, 30, "rows without keys")
    expect(bool((got[:, 129:] == 0).all()),
           "flash_prefill bf16: a row that sees no key is not 0")
    return n


def check_decode_split_edges(dev, rnd):
    """The split-KV decode_attention with forced split counts (1, 2, 7 and
    more than the range has tiles), so that whole splits hold no valid
    entry (windows, pos = 1, window 0), in f32 and bf16 against its plain
    version (``_attn_close``); the same bits on a second call (the combine
    runs in split order and resets its counters); then calls of several
    shapes on one stream, which share the wrapper's workspace. Returns the
    cases."""
    import torch
    from repro_torch.kernels import decode_attention, ref

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        # (B, Hq, Hkv, S, Dh, pos, window)
        for b, hq, hkv, s, dh, pos, window in [
                (2, 32, 8, 1000, 128, 1, None),   # one entry: 1 tile
                (1, 48, 1, 777, 128, 500, None),  # G = 48
                (2, 8, 2, 900, 80, 880, 100),     # window: 2 of 14 tiles
                (1, 8, 8, 300, 64, 300, 0)]:      # no valid entry
            q = rnd(b, hq, dh, dtype=dtype)
            k, v = (rnd(b, s, hkv, dh, dtype=dtype).transpose(1, 2)
                    for _ in range(2))
            want = ref.decode_attention_ref(q, k, v, pos, window=window)
            for splits in (1, 2, 7, 64):
                got = decode_attention(q, k, v, pos, window=window,
                                       splits=splits)
                what = (f"decode_attention {dtype} B={b} Hq={hq} Hkv={hkv} "
                        f"S={s} Dh={dh} pos={pos} window={window} "
                        f"splits={splits}")
                _attn_close(got, want, what)
                expect(torch.equal(got, decode_attention(
                    q, k, v, pos, window=window, splits=splits)),
                    f"{what}: two calls differ")
                if window == 0:
                    expect(bool((got == 0).all()), f"{what}: not 0")
                n += 1
    # shapes that share the workspace on one stream: B = 12 after the
    # serving shape has more groups and fewer splits, so its counters must
    # not lie where the B = 8 partials were
    for b, splits in ((8, None), (12, None), (8, None), (2, 64),
                      (16, None), (12, None)):
        q = rnd(b, 32, 128, dtype=torch.bfloat16)
        k, v = (rnd(b, 2080, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        _attn_close(decode_attention(q, k, v, 2064, splits=splits),
                    ref.decode_attention_ref(q, k, v, 2064),
                    f"decode_attention bf16 B={b} splits={splits} after "
                    f"other shapes on one stream")
        n += 1
    return n


def check_attention_kernels(dev, gen, reps, batch, prompt, gen_len):
    """Both attention kernels against their plain versions (f32 and bf16;
    groups of 1, 4 and 48; head sizes 64, 80 and 128; ragged lengths,
    windows, non-causal, pos = 1 and pos = S, strided operands), then
    timed at the serving shapes of granite-8b. Returns their records
    (without launches)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, flash_prefill, ref
    from repro_torch.kernels.decode_attention import split_count

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = {"flash_prefill": 0, "decode_attention": 0}
    for dtype in (torch.float32, torch.bfloat16):
        # (B, S, Hq, Hkv, Dh, causal, window, strided)
        for b, s, hq, hkv, dh, causal, window, strided in [
                (2, 300, 8, 8, 64, True, 0, False),      # G = 1
                (2, 300, 32, 8, 128, True, 0, True),     # G = 4, views
                (1, 257, 48, 1, 128, True, 0, False),    # G = 48 (MQA)
                (1, 200, 32, 32, 80, True, 100, False),  # Dh 80, window
                (1, 130, 8, 2, 64, False, 0, False),     # non-causal
                (1, 130, 8, 2, 80, False, 40, True)]:    # both, views
            if strided:  # q from a fused projection, k/v head-major
                qkv = rnd(b, s, hq + 2 * hkv, dh, dtype=dtype)
                q = qkv[:, :, :hq]
                k = rnd(b, hkv, s, dh, dtype=dtype).transpose(1, 2)
                v = qkv[:, :, hq + hkv:]
            else:
                q = rnd(b, s, hq, dh, dtype=dtype)
                k, v = (rnd(b, s, hkv, dh, dtype=dtype) for _ in range(2))
            _attn_close(flash_prefill(q, k, v, causal=causal, window=window),
                        ref.flash_prefill_ref(q, k, v, causal=causal,
                                              window=window),
                        f"flash_prefill {dtype} B={b} S={s} Hq={hq} "
                        f"Hkv={hkv} Dh={dh} causal={causal} window={window}")
            cases["flash_prefill"] += 1
        # (B, Hq, Hkv, S, Dh, pos, window, model-layout cache)
        for b, hq, hkv, s, dh, pos, window, model_layout in [
                (2, 8, 8, 1000, 64, 1, None, False),     # G = 1, pos = 1
                (2, 32, 8, 1000, 128, 1000, None, True),  # G = 4, pos = S
                (1, 48, 1, 777, 128, 500, None, True),   # G = 48 (MQA)
                (1, 32, 32, 300, 80, 300, 100, False),   # Dh 80, window
                (2, 32, 8, 2080, 128, 2049, None, True),  # serving cache
                (1, 8, 2, 333, 64, 200, 50, "unaligned")]:  # element loads
            q = rnd(b, hq, dh, dtype=dtype)
            if model_layout == "unaligned":  # rows off a 16-byte boundary
                kv = rnd(b, hkv, s, dh + 1, dtype=dtype)
                k, v = kv[..., 1:], kv[..., :dh]
            elif model_layout:  # (B, S, Hkv, Dh) viewed as (B, Hkv, S, Dh)
                k, v = (rnd(b, s, hkv, dh, dtype=dtype).transpose(1, 2)
                        for _ in range(2))
            else:
                k, v = (rnd(b, hkv, s, dh, dtype=dtype) for _ in range(2))
            _attn_close(decode_attention(q, k, v, pos, window=window),
                        ref.decode_attention_ref(q, k, v, pos, window=window),
                        f"decode_attention {dtype} B={b} Hq={hq} Hkv={hkv} "
                        f"S={s} Dh={dh} pos={pos} window={window}")
            cases["decode_attention"] += 1
    cases["decode_attention split edges"] = check_decode_split_edges(dev, rnd)
    cases["flash_prefill bf16 edges"] = check_prefill_bf16_edges(dev, rnd)
    log("phase 6 correctness cases:", json.dumps(cases))

    # -- timings at granite-8b's serving shapes (bf16) ---------------------
    from repro_torch.models.arch import get_arch

    cfg = get_arch(SERVE_ARCH)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf = torch.bfloat16
    records = []
    s = prompt
    q = rnd(batch, s, hq, dh, dtype=bf)
    k, v = (rnd(batch, s, hkv, dh, dtype=bf) for _ in range(2))
    out = flash_prefill(q, k, v, causal=True)
    err = _attn_close(out, ref.flash_prefill_ref(q, k, v, causal=True),
                      "flash_prefill at the serving shape")
    ms = event_ms(lambda: flash_prefill(q, k, v, causal=True), reps)
    plain = event_ms(lambda: ref.flash_prefill_ref(q, k, v, causal=True),
                     reps)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    _attn_close(out, lib.transpose(1, 2), "flash_prefill against "
                "scaled_dot_product_attention")
    library = event_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps)
    flop = 4 * batch * hq * dh * s * (s + 1) // 2    # causal QK^T and PV
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    records.append(make_record(
        "phase 6", "flash_prefill", "flash_prefill.cu",
        "src/repro/kernels/flash_prefill.py:92",
        f"B={batch} S={s} Hq={hq} Hkv={hkv} Dh={dh} bf16 causal",
        ms, plain, library, nbytes, flop, BF16_TENSOR_OPS_PER_S, err))
    del q, k, v, out, qt, kt, vt, lib

    # one decode step in the middle of the run: a (B, Sbuf, Hkv, Dh) cache
    # of prompt + gen slots, n_valid = prompt + gen / 2 entries
    sbuf, n_valid = prompt + gen_len, prompt + gen_len // 2
    qd = rnd(batch, hq, dh, dtype=bf)
    ck, cv = (rnd(batch, sbuf, hkv, dh, dtype=bf) for _ in range(2))
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    out = decode_attention(qd, kt, vt, n_valid)
    splits = split_count(qd, kt, n_valid)
    expect(splits > 1, f"decode_attention does not split the serving "
           f"shape's cache ({splits} split)")
    log(f"phase 6 decode_attention at the serving shape: {splits} splits, "
        f"grid {splits} x {hkv} x {batch} blocks in one launch")
    sweep = {n: device_ms(lambda: decode_attention(qd, kt, vt, n_valid,
                                                   splits=n), 5 * reps)
             for n in (1, 2, 3, 4, 6, 8, 12)}
    log("phase 6 decode_attention device ms by forced split count: "
        + json.dumps(sweep))
    err = _attn_close(out, ref.decode_attention_ref(qd, kt, vt, n_valid),
                      "decode_attention at the serving shape")
    # a call's kernels take tens of microseconds, less than the host needs
    # to issue it: ms, plain_ms and library_ms are device time
    # (device_ms); the CUDA-event times, which include the host's issue
    # time, are logged beside them
    dreps = 20 * reps
    mask = (torch.arange(sbuf, device=dev) < n_valid).view(1, 1, 1, sbuf)
    q4 = qd.unsqueeze(2)
    lib = F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                         enable_gqa=True)
    _attn_close(out, lib.squeeze(2), "decode_attention against "
                "scaled_dot_product_attention")
    calls = {
        "kernel": lambda: decode_attention(qd, kt, vt, n_valid),
        "plain": lambda: ref.decode_attention_ref(qd, kt, vt, n_valid),
        "library": lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True)}
    dev_t = {k: device_ms(fn, dreps) for k, fn in calls.items()}
    ev_t = {k: event_ms(fn, dreps) for k, fn in calls.items()}
    log("phase 6 decode_attention at the serving shape, ms a call: device "
        + json.dumps(dev_t) + " CUDA events (with the host's issue time) "
        + json.dumps(ev_t))
    ms, plain, library = dev_t["kernel"], dev_t["plain"], dev_t["library"]
    nbytes = 2 * (2 * batch * hkv * n_valid * dh + 2 * qd.numel())
    flop = 4 * batch * hq * n_valid * dh
    records.append(make_record(
        "phase 6", "decode_attention", "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:79",
        f"B={batch} Hq={hq} Hkv={hkv} Sbuf={sbuf} n_valid={n_valid} "
        f"Dh={dh} bf16", ms, plain, library, nbytes, flop,
        BF16_TENSOR_OPS_PER_S, err))
    records[-1]["timing"] = "device time (torch.profiler)"
    records[-1]["event_ms"] = ev_t["kernel"]
    return records


def serve_lm(dev, batch, prompt, gen_len):
    """granite-8b at full width in bf16: prefill ``batch`` prompts of
    ``prompt`` tokens, decode ``gen_len`` greedy tokens. Returns the launch
    counts of the measured run (reset just before it, read just after)."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import build, random_prompts, serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, t_init = timed(lambda: build(SERVE_ARCH, seed=0, device=dev,
                                        dtype=torch.bfloat16))
    expect(model.dtype == torch.bfloat16, "the serving model is not bf16")
    n_params = model.param_count()
    prompts = random_prompts(model, batch, prompt)
    serve(model, prompts[:, :64], gen=2)   # warm-up: cuBLAS, first launches
    reset_launches()
    res = serve(model, prompts, gen=gen_len)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    expect(res.logits_finite, "a serving logit is not finite")
    expect(tuple(res.ids.shape) == (batch, gen_len), "wrong id shape")
    expect(int(res.ids.min()) >= 0 and int(res.ids.max()) < cfg.vocab,
           "a served id is a vocab-padding id")
    want = {"flash_prefill": cfg.n_layers,
            "decode_attention": cfg.n_layers * (gen_len - 1)}
    for k, n in want.items():
        expect(counts[k] > 0, f"the serving run launched no {k}")
        expect(counts[k] == n, f"the serving run launched {k} "
               f"{counts[k]} times, not {n}")
    log(f"phase 7 serve {cfg.name} (full width: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}) bf16 params={n_params} "
        f"init_s={t_init:.4f} batch={batch} prompt={prompt} gen={gen_len}: "
        f"prefill_s={res.prefill_s:.4f} "
        f"prefill_tok_s={batch * prompt / res.prefill_s:.1f} "
        f"decode_s={res.decode_s:.4f} "
        f"decode_tok_s={batch * (gen_len - 1) / res.decode_s:.1f} "
        f"peak_bytes={peak} launches={json.dumps(counts)}")
    log(f"phase 7 sample ids: {res.ids[0, :12].tolist()}")
    profile_serving(model, prompts, res.prefill_s,
                    res.decode_s / (gen_len - 1))
    del model, res
    torch.cuda.empty_cache()
    return counts


def _kernel_group(name: str) -> str:
    for key, group in (("flash_prefill", "flash_prefill"),
                       ("decode_attention", "decode_attention"),
                       ("gemm", "matmul"), ("nvjet", "matmul"),
                       ("xmma", "matmul"), ("cutlass", "matmul")):
        if key in name:
            return group
    return "other"


def profile_serving(model, prompts, prefill_s, step_s, steps=4):
    """Device time of one prefill and of ``steps`` decode steps by kernel
    group (torch.profiler), against the wall time of the unprofiled run:
    the device's busy share is device time over that wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    b, s = prompts.shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_ms(prof):
        groups: dict = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0) or 0
            if t and getattr(e, "device_type", None) is not None and \
                    "CUDA" in str(e.device_type):
                g = _kernel_group(e.key)
                groups[g] = groups.get(g, 0.0) + t / 1e3
        return groups

    with profile(activities=acts) as prof:
        logits, cache = model.prefill(prompts, max_len=s + steps + 1)
        sync()
    pre = device_ms(prof)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    with profile(activities=acts) as prof:
        for i in range(steps):
            logits, cache = model.decode_step(cache, tok, s + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        sync()
    dec = {g: t / steps for g, t in device_ms(prof).items()}
    del logits, cache
    for what, groups, wall_ms in (("prefill", pre, prefill_s * 1e3),
                                  ("decode step", dec, step_s * 1e3)):
        total = sum(groups.values())
        if total == 0:
            log(f"phase 7 profile {what}: the profiler saw no device time "
                f"(not measured)")
            continue
        split = " ".join(f"{g}={t:.3f}ms" for g, t in
                         sorted(groups.items(), key=lambda kv: -kv[1]))
        log(f"phase 7 profile {what}: device_ms={total:.3f} "
            f"wall_ms={wall_ms:.3f} busy_share={total / wall_ms:.3f} {split}")


def lm_card_vs_cpu(dev):
    """A small GQA model in f32, the same weights on the card (kernels)
    and on the CPU (plain versions): equal greedy ids and logits within
    1e-4 over a prefill and 8 decode steps, without and with a window."""
    import copy

    import torch
    from repro_torch.models.arch import ArchConfig, LayerSpec
    from repro_torch.models.transformer import Transformer

    cfg = ArchConfig(name="gqa-smoke", family="dense", n_layers=2,
                     d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
                     vocab=1024, pattern=(LayerSpec(),), rope_theta=1e4)
    gen = torch.Generator().manual_seed(0)
    cpu = Transformer(cfg, device="cpu", dtype=torch.float32, generator=gen)
    card = copy.deepcopy(cpu).to(dev)
    b, s, steps = 2, 40, 8
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    worst = 0.0
    for window in (0, 48):
        lc, cc = cpu.prefill(tokens, window=window, max_len=s + steps)
        lg, cg = card.prefill(tokens.to(dev), window=window,
                              max_len=s + steps)
        for i in range(steps + 1):
            err = float((lg.cpu() - lc).abs().max())
            worst = max(worst, err)
            expect(err <= 1e-4, f"LM card vs CPU window={window} step {i}: "
                   f"max |logit error| {err}")
            tok = lc[:, -1].argmax(-1, keepdim=True)
            expect(torch.equal(lg[:, -1].argmax(-1, keepdim=True).cpu(), tok),
                   f"LM card vs CPU window={window} step {i}: ids differ")
            if i < steps:
                lc, cc = cpu.decode_step(cc, tok, s + i, window=window)
                lg, cg = card.decode_step(cg, tok.to(dev), s + i,
                                          window=window)
    log(f"phase 8 LM card == CPU greedy ids over a prefill + {steps} decode "
        f"steps, window 0 and 48 ({cfg.name}: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"f32); max |logit error| {worst}")


def _cuobjdump():
    """cuobjdump from PATH, the CUDA toolkit or Triton's bundle, else None."""
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = ["/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if os.path.exists(c)), None)


#: (library, what its tensor-core kernels are, a substring of their
#: mangled names, the SASS opcodes one of which it must hold) whose SASS
#: phase 2 shows
TENSOR_CORE_KERNELS = (("flash_prefill", "bf16", "wgmma", ("HGMMA", "HMMA")),
                       ("code_corr", "3xTF32", "code_corr_tf32", ("HGMMA",)),
                       ("sign_corr", "int8", "sign_corr_s8_wgmma",
                        ("IGMMA",)),
                       ("sign_corr_packed", "int8",
                        "sign_corr_packed_s8_wgmma", ("IGMMA",)),
                       ("decode_attention", "bf16",
                        "decode_attention_kernelI13__nv_bfloat16",
                        ("HMMA",)))


def log_tensor_core_use(build_dir):
    """Evidence that flash_prefill's and decode_attention's bf16 kernels,
    code_corr, sign_corr and sign_corr_packed run on the tensor cores: the
    HMMA / HGMMA (float) and IGMMA (int8) instructions in each library's
    SASS, and the spills ptxas reports for those kernels."""
    import re

    tool = _cuobjdump()
    for lib, what, key, opcodes in TENSOR_CORE_KERNELS:
        log_lines = (build_dir / f"lib{lib}.log").read_text().splitlines()
        spills, current = {}, None
        for ln in log_lines:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                current = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and current and key in current:
                spills[current] = int(m.group(1)) + int(m.group(2))
        log(f"phase 2 {lib} {what} kernels: {len(spills)}, spill bytes "
            f"{sum(spills.values())}")
        expect(len(spills) > 0, f"ptxas reported no {what} kernel of "
               f"lib{lib}.so (no entry function names {key!r})")
        expect(sum(spills.values()) == 0, f"lib{lib}.so's {what} kernels "
               f"spill: {spills}")
        if tool is None:
            log(f"phase 2 {lib} SASS: cuobjdump not found")
            continue
        sass = subprocess.run([tool, "-sass", str(build_dir / f"lib{lib}.so")],
                              capture_output=True, text=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\.", sass))
                  for op in ("HGMMA", "HMMA", "IGMMA")}
        log(f"phase 2 {lib} SASS ({tool}): " +
            ", ".join(f"{op} {c}" for op, c in counts.items()))
        expect(sum(counts[op] for op in opcodes) > 0, f"lib{lib}.so holds "
               f"no {what} tensor-core instruction ({'/'.join(opcodes)})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import _build

    # phase 1: the card, the versions, the f32 matmul precision
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    expect(not torch.backends.cuda.matmul.allow_tf32
           and not torch.backends.cudnn.allow_tf32, "TF32 is still on")
    log(f"phase 1 card: {card}")
    log(f"phase 1 python={sys.version.split()[0]} torch={torch.__version__} "
        f"cuda={torch.version.cuda} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # phase 2: build every kernel from the checkout's sources
    out = _build.build_all()
    log(f"phase 2 built {len(_build.KERNELS)} kernels in "
        f"{_build.last_build_seconds:.1f} s into {out}")
    for k in _build.KERNELS:
        usage = [ln.split("info    :")[-1].strip()
                 for ln in (out / f"lib{k}.log").read_text().splitlines()
                 if "registers" in ln]
        log(f"phase 2 {k}: {'; '.join(usage)}")
    log_tensor_core_use(out)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = check_kernels("cuda", gen, MAIN_N, CUT_N, CHECK_N, D, reps=3)
    total = run_main_path("cuda", D, MAIN_N, CUT_N)
    card_vs_cpu("cuda", 256, 1 << 14)
    records += check_attention_kernels("cuda", gen, 5, SERVE_BATCH,
                                       SERVE_PROMPT, SERVE_GEN)
    for k, n in serve_lm("cuda", SERVE_BATCH, SERVE_PROMPT,
                         SERVE_GEN).items():
        total[k] += n
    lm_card_vs_cpu("cuda")
    for r in records:
        r["launches"] = total[r["name"]]
        expect(r["launches"] > 0, f"the main path never launched "
               f"{r['name']}")

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
