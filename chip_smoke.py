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
card against the CPU. Then the serving plane: StreamingGram at d = 4096
against the batch Gram (phase 9), the structure server at 64 tenants and
d = 1024 with its throughput and a tick's time split (phase 10), and its
crash recovery, card-vs-CPU and per-symbol checks (phase 11); the three
Gram kernels are also held and timed on the server's batched grids
(phase 3). Last, the trial plane (phase 12): the four kernels held and
timed at its batched shapes, the row-normals kernel held and timed at
the sweep's block (120 x 136 x 1024), the paper's Fig. 3 sweep (d = 20,
720 trials) on the card and the CPU with one device->host copy a sweep,
sweeps at d = 1024 with their time split, and the fault plane (a
zero-fault plan bit-identical to none, a mixed plan's telemetry card
against CPU). Then the sparse plane (phase 13): the kernels held at its
shapes; examples/sparse_glasso.py's sweep (d = 16, 384 trials) with a
fixed penalty, an EBIC path and a StARS path, card against CPU (supports
may part only at partial correlations that sit at the threshold) with the
device->host copies counted by cause; a d = 128 sweep with its time
split and eigh's time a step, card against CPU; and the sparse fault
checks. Last, the channel plane (phase 14): sign_corr on MAC-masked
codes and quantize_fused at R = 1..4 held and timed at b = 32, n = 8192,
d = 1024; benchmarks/channels.py's plan (gather, MAC superposition and
bit-budget strategies, pristine and faulty) card against CPU with its
five checks; the channel strategies at d = 1024 over 16 machines with
their time split; and learn_structure over a MAC at PRODUCTION (phase
4's edges exactly) and over a bit budget at d = 4096, n = 2^18. Last,
the mesh and wire plane (phase 15): distributed_learn_structure at
PRODUCTION over a one-rank NCCL mesh (phase 4's edges, weights equal to
the single-device ones), run_trials over one-rank NCCL meshes equal to
the mesh-less sweeps bit for bit, and four gloo ranks on the one card
over a (2, 2) wire mesh. Then LM training (phase 16): flash_prefill's
gradient route against autograd through its plain version; the trainer
(launch/train.py) on stablelm-3b at full width in bf16 for 6 steps
(batch 4, 2048 tokens) with a step's time split; the reduced model's
steps card against CPU; and a resumed run equal to the straight one bit
for bit. Last, the Gram autotune cache (phase 17): the three kernel paths
tuned at the main path's buckets, no sweep when warm, the tuned Grams
against the default's, and run_trials with an autotuning engine equal to
the untuned sweep. Then MoE and Mamba2 serving (phase 18): qwen2-moe-a2.7b
and mamba2-370m at full width in bf16 (batch 8, 2048-token prompts, 32
greedy tokens; the MoE's dropped assignments, the decode step beside its
byte bound, no attention launch for mamba2), and reduced qwen2-moe (at
capacity factors 64 and 1.25), mamba2 and jamba card against CPU. Last,
the modality stubs and the encoder-decoder stack (phase 19):
llava-next-mistral-7b (a 576-row patch prefix) and seamless-m4t-large-v2
(24 encoder layers over 512 frames, 24 decoder layers cross-attending to
them) at full size and llama4-scout-17b-a16e at full width cut to 8 of
its 48 layers, each served at phase 7's shape in bf16 with its
launches counted by kind; both attention kernels held and timed on the
slice's own operands (the bidirectional encoder, the cross-attention, the
patch-prefixed prompt, the cross cache); and the reduced models' greedy
decode and one train step card against CPU. Last, the LM mesh (phase
20): granite-8b at phase 7's shape and qwen2-moe-a2.7b through the
expert-parallel branch over a one-rank NCCL mesh, bit for bit the
mesh-less runs; four gloo ranks on the card over (1, 4) and (2, 2)
serving llama4-scout-17b-a16e at full width cut to 2 layers (a quarter
of the weights a rank over (1, 4)) against the mesh-less card run, and
reduced qwen2-moe and jamba (and one ep2d decode) against the same ranks
on the CPU; two gloo ranks training reduced stablelm-3b over (2, 1) and
(1, 2) against the mesh-less card steps, a resume and a checkpoint moved
between meshes; the structure server on a one-card tenant mesh; and the
compressed gradient collectives over four ranks. Any failed check exits
non-zero. The last three
lines of standard output are the card's name and power limit, one JSON
object per kernel ({"kernels": [...]}) and {"ok": true, "device": {...}}.
Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
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
# The serving plane (phases 9-11): StreamingGram at the main path's width
# (n = 2^18 over 8 machines), and the structure server of
# benchmarks/serve.py's throughput phase widened to d = 1024 and 256-row
# payloads; a fold launches its kernels at b = SERVE_SLOTS payload slots.
STREAM_MACHINES = 8
SERVE_TENANTS, SERVE_MACHINES, SERVE_TICKS = 64, 4, 16
SERVE_D, SERVE_BLOCK_N, SERVE_SLOTS = 1024, 256, 64
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


def check_fold_kernels(dev, gen, slots, block_n, d, reps):
    """The three Gram kernels on the batched grids the serving plane's
    fold launches (b = ``slots`` payload slots of ``block_n`` rows), with
    the fold's padding: sign slots pad with 0, per-symbol slots with the
    -1 sentinel, packed slots with zero bytes. Held to the plain versions
    at the fold shape and at d = 250 and block_n = 24 (rows off 16 bytes),
    then timed at the fold shape. Returns {kernel: fold record}."""
    import torch
    from repro_torch.core.quantizers import PerSymbolQuantizer
    from repro_torch.kernels import (code_corr, ref, sign_corr,
                                     sign_corr_packed)

    cb = torch.as_tensor(PerSymbolQuantizer(4).centroids_np, device=dev)

    def operands(b, n, dd):
        used = b - max(1, b // 4)     # the last quarter are padding slots
        u = _signs(gen, (b, n, dd), dev)
        u[used:] = 0
        u[:used, n - n // 3:] = 0     # ragged payloads: rows past n pad
        c = _codes(gen, (b, n, dd), 4, dev)
        c[used:] = -1
        p = _packed(gen, (b, dd, n), dev)
        p[used:] = 0
        return u, c, p

    for b, n, dd in ((slots, block_n, d), (slots, 24, 250), (3, 256, 250)):
        u, c, p = operands(b, n, dd)
        expect(torch.equal(sign_corr(u), ref.sign_corr_ref(u)),
               f"sign_corr at the fold shape b={b} n={n} d={dd}")
        g = sign_corr_packed(p, n)
        expect(torch.equal(g, ref.sign_corr_packed_ref(p, n)),
               f"sign_corr_packed at the fold shape b={b} n={n} d={dd}")
        # an all-zero padding slot comes out as n everywhere (every
        # zero bit is -1 on both sides), which the fold's shift removes
        expect(bool((g[b - 1] == n).all()), "a padding slot of "
               "sign_corr_packed is not exactly n")
        want = ref.code_corr_ref(c, cb)
        err = (code_corr(c, cb) - want).abs()
        expect(bool((err <= code_tolerance(n, want)).all()),
               f"code_corr at the fold shape b={b} n={n} d={dd}: max |err| "
               f"{float(err.max())}")
        expect(bool((want[b - 1] == 0).all()), "a sentinel slot of "
               "code_corr_ref is not 0")
    log(f"phase 3 fold shapes (b={slots}, n={block_n}, d={d}; b={slots}, "
        f"n=24, d=250; b=3, n=256, d=250): sign_corr, sign_corr_packed, "
        f"code_corr equal their plain versions")

    u, c, p = operands(slots, block_n, d)
    out = {}

    def fold_record(name, fn, plain, library, bytes_moved, ops, op_rate):
        ms = event_ms(fn, reps)
        rec = make_record("phase 3 fold", name, "", "",
                          f"b={slots} n={block_n} d={d}", ms,
                          event_ms(plain, reps), event_ms(library, reps),
                          bytes_moved, ops, op_rate, 0.0)
        out[name] = {k: rec[k] for k in ("shape", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")}

    # library yardstick: one f32 torch.bmm of the operands already in
    # f32 (signs, unpacked signs, decoded codes; the conversion left out)
    out_bytes = slots * d * d * 4
    uf = u.to(torch.float32)
    ut = uf.transpose(1, 2).contiguous()
    fold_record("sign_corr", lambda: sign_corr(u),
                lambda: ref.sign_corr_ref(u), lambda: torch.bmm(ut, uf),
                u.numel() + out_bytes, 2 * slots * block_n * d * d,
                INT8_TENSOR_OPS_PER_S)
    pf = ref.unpack_signs_pm1(p, block_n)
    pt = pf.transpose(1, 2).contiguous()
    fold_record("sign_corr_packed", lambda: sign_corr_packed(p, block_n),
                lambda: ref.sign_corr_packed_ref(p, block_n),
                lambda: torch.bmm(pf, pt), p.numel() + out_bytes,
                2 * slots * block_n * d * d, INT8_TENSOR_OPS_PER_S)
    dec = ref.decode_codes(c, cb)
    dt = dec.transpose(1, 2).contiguous()
    fold_record("code_corr", lambda: code_corr(c, cb),
                lambda: ref.code_corr_ref(c, cb), lambda: torch.bmm(dt, dec),
                c.numel() + 16 * 4 + out_bytes,
                3 * 2 * slots * block_n * d * d, TF32_TENSOR_OPS_PER_S)
    return out


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
    launch counts of these runs (counts reset before each, read after)
    and the PRODUCTION edge list."""
    import torch
    from repro_torch import trace
    from repro_torch.configs import PRODUCTION
    from repro_torch.core.chow_liu import learn_structure
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
    # the entry's own spans give the breakdown (CUDA events)
    with trace.recording() as spans:
        est, t_total = timed(lambda: learn_structure(x, strategy=s))
    counts = launches()
    add(counts)
    expect(counts["sign_corr"] > 0, "the PRODUCTION run launched no "
           "sign_corr")
    expect(is_tree(d, est), "the PRODUCTION result is not a spanning tree")
    main_edges = est
    del x
    peak = torch.cuda.max_memory_allocated()
    stage = {r.name.removeprefix("repro_torch."): r.seconds for r in spans}
    (root,) = [r for r in spans if r.parent is None]
    log(f"phase 4 PRODUCTION d={d} n={main_n} sign/int8/boruvka: "
        f"sample_s={t_sample:.4f} learn_structure_s={t_total:.4f} "
        + " ".join(f"{k}_s={stage[k]:.4f}" for k in (
            "encode", "gram", "weights", "mst", "edges"))
        + f" self_s={trace.self_s(root, spans):.4f} "
        f"host_reads={root.counts.get('host_reads', 0)} "
        f"edit_distance={tree_edit_distance(est, truth)} "
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
    return total, main_edges


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


def attention_layers(model):
    """{kernel: launches one serve of ``model`` makes per prefill or decode
    step}: flash_prefill once per encoder, decoder and cross attention
    layer of the prefill; decode_attention once per decoder and cross
    attention layer of each decode step."""
    dec = sum(blk.spec.mixer == "attn" for blk in model.layers)
    cross = sum(blk.spec.cross_attn for blk in model.layers)
    enc = sum(blk.spec.mixer == "attn" for blk in getattr(
        model, "enc_layers", ()))
    return {"flash_prefill": dec + cross + enc, "decode_attention":
            dec + cross, "encoder": enc, "cross": cross}


def serve_at_width(dev, arch, batch, prompt, gen_len, phase, layers=0):
    """``arch`` at full width in bf16 (random weights from seed 0; its
    decoder cut to ``layers`` when given): a 64-token warm-up, then
    ``batch`` prompts of ``prompt`` tokens and ``gen_len`` greedy tokens
    through ``serve``, after the modality stub's embeddings
    (``random_embeds``: a vision model's P patch rows, an encoder-decoder
    model's max(prompt // 4, 8) encoder frames). Checks the ids, the
    logits and the attention kernels' launch counts (reset just before
    the measured run, read just after: ``flash_prefill`` once an encoder,
    decoder and cross attention layer, ``decode_attention`` once a decoder
    and cross attention layer a decode step, 0 for an attention-free
    model). Returns (model, prompts, result, counts, embeddings)."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import (build, random_embeds,
                                          random_prompts, serve)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, t_init = timed(lambda: build(arch, seed=0, device=dev,
                                        dtype=torch.bfloat16, layers=layers))
    expect(model.dtype == torch.bfloat16, "the serving model is not bf16")
    prompts = random_prompts(model, batch, prompt)
    embeds = random_embeds(model, batch, prompt)
    # warm-up: cuBLAS, first launches
    serve(model, prompts[:, :64], gen=2, **random_embeds(model, batch, 64))
    reset_launches()
    res = serve(model, prompts, gen=gen_len, **embeds)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    expect(res.logits_finite, f"{phase} {arch}: a serving logit is not "
           f"finite")
    expect(tuple(res.ids.shape) == (batch, gen_len), "wrong id shape")
    expect(int(res.ids.min()) >= 0 and int(res.ids.max()) < cfg.vocab,
           f"{phase} {arch}: a served id is a vocab-padding id")
    per = attention_layers(model)
    want = {"flash_prefill": per["flash_prefill"],
            "decode_attention": per["decode_attention"] * (gen_len - 1)}
    for k, n in want.items():
        expect(n == 0 or counts[k] > 0, f"the serving run launched no {k}")
        expect(counts[k] == n, f"{phase} {arch}: the serving run launched "
               f"{k} {counts[k]} times, not {n}")
    p = embeds["modal_embeds"].shape[1] if "modal_embeds" in embeds else 0
    stub = ""
    if p:
        stub = (f" modal_rows={p} prefill_positions_s="
                f"{batch * (prompt + p) / res.prefill_s:.1f}")
    if "enc_embeds" in embeds:
        stub += (f" encoder_frames={embeds['enc_embeds'].shape[1]} "
                 f"({cfg.encoder_layers} encoder layers, {per['cross']} "
                 f"cross layers)")
    log(f"{phase} serve {cfg.name} (full width: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}) bf16 "
        f"params={model.param_count()} init_s={t_init:.4f} batch={batch} "
        f"prompt={prompt} gen={gen_len}: prefill_s={res.prefill_s:.4f} "
        f"prefill_tok_s={batch * prompt / res.prefill_s:.1f}{stub} "
        f"decode_s={res.decode_s:.4f} "
        f"decode_tok_s={batch * (gen_len - 1) / res.decode_s:.1f} "
        f"peak_bytes={peak} launches={json.dumps(counts)}")
    log(f"{phase} sample ids: {res.ids[0, :12].tolist()}")
    return model, prompts, res, counts, embeds


def serve_lm(dev, batch, prompt, gen_len):
    """granite-8b at full width in bf16 (phase 7); returns the launch
    counts of the measured run."""
    import torch

    model, prompts, res, counts, _ = serve_at_width(
        dev, SERVE_ARCH, batch, prompt, gen_len, "phase 7")
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


def profile_serving(model, prompts, prefill_s, step_s, steps=4,
                    phase="phase 7", ops=None, embeds=None):
    """Device time of one prefill (after ``embeds``, the modality stub's
    inputs) and of ``steps`` decode steps by kernel group
    (torch.profiler), against the wall time of the unprofiled run: the
    device's busy share is device time over that wall time. ``ops`` ({CPU
    op: label}) names ops whose kernels' device time (part of the groups)
    is logged beside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    embeds = embeds or {}
    b = prompts.shape[0]
    s = prompts.shape[1] + (embeds["modal_embeds"].shape[1]
                            if "modal_embeds" in embeds else 0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_ms(prof):
        groups: dict = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0) or 0
            if t and getattr(e, "device_type", None) is not None and \
                    "CUDA" in str(e.device_type):
                g = _kernel_group(e.key)
                groups[g] = groups.get(g, 0.0) + t / 1e3
            if e.key in (ops or {}):
                t = getattr(e, "device_time_total", 0) or 0
                groups[ops[e.key]] = t / 1e3
        return groups

    with profile(activities=acts) as prof:
        logits, cache = model.prefill(prompts, max_len=s + steps + 1,
                                      **embeds)
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
        parts = {g: groups.pop(g) for g in (ops or {}).values()
                 if g in groups}
        total = sum(groups.values())
        if total == 0:
            log(f"{phase} profile {what}: the profiler saw no device time "
                f"(not measured)")
            continue
        split = " ".join(f"{g}={t:.3f}ms" for g, t in
                         sorted(groups.items(), key=lambda kv: -kv[1]))
        split += "".join(f"; of which {g}={t:.3f}ms"
                         for g, t in parts.items())
        log(f"{phase} profile {what}: device_ms={total:.3f} "
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


# ---------------------------------------------------------------------------
# Phases 9-11: streaming ingest and the structure server
# ---------------------------------------------------------------------------

def counted(total, fn):
    """fn() with every launch count set to 0 just before it; the counts it
    leaves are added to ``total`` and returned beside its result."""
    from repro_torch.kernels import launches, reset_launches

    reset_launches()
    out = fn()
    counts = launches()
    for k, v in counts.items():
        total[k] += v
    return out, counts


def _update_in_batches(sg, x, batches):
    for part in x.chunk(batches):
        sg.update(part)
    return sg


def stream_at_width(dev, d, n, machines, total):
    """Phase 9: ``StreamingGram`` at the main path's width. One sample set
    goes through the int8 wire (``update_codes_batch``, one sign_corr
    launch at b = machines), the packed wire (``update_packed_batch`` with
    two machines truncated) and per-symbol R = 4 (``update`` over
    ``machines`` batches: quantize_fused + code_corr); each is held to the
    batch Gram of the same samples and to ``learn_structure``'s edges."""
    import numpy as np
    import torch
    from repro_torch.configs import PRODUCTION
    from repro_torch.core import StreamingGram, Strategy
    from repro_torch.core.chow_liu import learn_structure
    from repro_torch.core.gram import GramEngine
    from repro_torch.core.quantizers import (PerSymbolQuantizer, pack_codes,
                                             sign_bits, sign_codes)
    from repro_torch.data import GGMDataset

    t0 = time.perf_counter()
    x = GGMDataset(d=d, seed=PRODUCTION.seed).sample(n, batch_seed=3,
                                                     device=dev)
    m_b = n // machines
    codes = sign_codes(x).view(machines, m_b, d)

    def int8_wire():
        sg = StreamingGram(d).update_codes_batch(codes)
        return sg, sg.learn_structure("boruvka")

    (sg, edges), counts = counted(total, int8_wire)
    expect(counts["sign_corr"] == 1, f"the int8 stream launched "
           f"{counts['sign_corr']} sign_corr, not 1")
    expect(torch.equal(sg.gram, GramEngine().gram(codes.view(n, d))),
           "streaming != batch Gram on the int8 wire")
    truth = learn_structure(x, strategy=Strategy())
    expect(edges == truth, "the int8 stream's edges differ from "
           "learn_structure's")
    del sg

    bits = sign_bits(x).view(machines, m_b, d).transpose(1, 2)
    payloads = pack_codes(bits.to(torch.uint8).contiguous(), 1)
    del bits
    nv = np.full(machines, m_b, np.int64)
    nv[2], nv[5] = m_b // 3 + 5, 0          # a straggler and a dropout
    sp, counts = counted(total, lambda: StreamingGram(d).update_packed_batch(
        payloads, m_b, nv))
    expect(counts["sign_corr_packed"] == 1, "the packed stream launched "
           f"{counts['sign_corr_packed']} sign_corr_packed, not 1")
    prefixes = torch.cat([codes[i, :nv[i]] for i in range(machines)])
    expect(torch.equal(sp.gram, GramEngine().gram(prefixes))
           and sp.n == int(nv.sum()), "the packed stream with n_valid != "
           "the fold of the surviving prefixes")
    del sp, payloads, prefixes, codes

    sq, counts = counted(total, lambda: _update_in_batches(
        StreamingGram(d, method="persymbol", rate=4), x, machines))
    expect(counts["quantize_fused"] == machines
           and counts["code_corr"] == machines, "the per-symbol stream "
           f"launched {counts}")
    q = PerSymbolQuantizer(4)
    batch = GramEngine().code_gram(q.encode(x), q.centroids_np)
    err = (sq.gram - batch).abs()
    expect(bool((err <= code_tolerance(n, batch)).all()),
           f"per-symbol streaming vs batch Gram: max |err| {float(err.max())}")
    edges = sq.learn_structure("boruvka")
    expect(edges == learn_structure(
        x, strategy=Strategy(method="persymbol", rate=4)),
        "the per-symbol stream's edges differ from learn_structure's")
    log(f"phase 9 StreamingGram d={d} n={n} ({machines} machines x {m_b}): "
        f"int8 wire == batch Gram, packed wire with n_valid={nv.tolist()} "
        f"== surviving prefixes, per-symbol R=4 max |stream - batch| "
        f"{float(err.max())}; edges == learn_structure's; "
        f"{time.perf_counter() - t0:.1f} s")
    del x, sq, batch, err
    torch.cuda.empty_cache()


def _drive(srv, trace, extra_ticks=4):
    """Deliver the trace tick by tick, then drain the reorder deadlines
    and solve every tenant; returns the per-tick telemetry."""
    tele = []
    for batch in trace:
        for p in batch:
            srv.submit(p)
        tele.append(srv.run_tick())
    for _ in range(extra_ticks):
        tele.append(srv.run_tick())
    srv.force_resolve()
    return tele


class TickSplit:
    """Times the parts of the server's ticks by wrapping its stages:
    the fold stages' device work by CUDA events (a fold stage never waits
    for the host), the host parts by the host clock (the device -> host
    copy after a synchronize, so the wait for the fold kernels is a part
    of its own)."""

    def __init__(self):
        self.host = {}
        self.events = {}
        self._undo = []

    def _wrap(self, owner, name, key, timed):
        orig = getattr(owner, name)

        def wrapper(*args, **kw):
            return timed(key, orig, args, kw)

        setattr(owner, name, wrapper)
        self._undo.append((owner, name, orig))

    def _add(self, key, seconds):
        self.host[key] = self.host.get(key, 0.0) + seconds

    def _host(self, key, fn, args, kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            self._add(key, time.perf_counter() - t0)

    def _device(self, key, fn, args, kw):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        self.events.setdefault(key, []).append((start, end))
        return out

    def _copy(self, key, fn, args, kw):
        t0 = time.perf_counter()
        sync()
        t1 = time.perf_counter()
        out = fn(*args, **kw)
        self._add("wait for the fold kernels", t1 - t0)
        self._add(key, time.perf_counter() - t1)
        return out

    def install(self):
        from repro_torch.serve import journal, server, table

        self._wrap(table, "codes_fold_stage", "fold kernels (device)",
                   self._device)
        self._wrap(table, "packed_fold_stage", "fold kernels (device)",
                   self._device)
        self._wrap(table, "to_host", "device->host copy + f64 cast",
                   self._copy)
        self._wrap(table.TenantTable, "_scatter", "host scatter", self._host)
        self._wrap(table.TenantTable, "resolve", "solve", self._host)
        self._wrap(journal.FoldJournal, "append", "journal append",
                   self._host)
        self._wrap(journal.FoldJournal, "sync", "journal fsync", self._host)
        self._wrap(server.StructureServer, "save_snapshot", "snapshot",
                   self._host)
        return self

    def remove(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def device_seconds(self) -> dict:
        sync()
        return {k: sum(s.elapsed_time(e) for s, e in pairs) / 1e3
                for k, pairs in self.events.items()}


def serve_structures(dev, tenants, machines, d, block_n, ticks, workdir,
                     total):
    """Phase 10: the structure server at a size a user would run (the
    throughput phase of ``benchmarks/serve.py``, widened to d = 1024 and
    256-row payloads): ticks/s, rows/s, fold p50/p99, a tick's time split,
    the launches; its accumulators against an independent exactly-once
    StreamingGram fold on the card, bit for bit, and drained buffers."""
    import shutil

    import numpy as np
    from repro_torch.core import StreamingGram
    from repro_torch.serve import (ServeConfig, StructureServer,
                                   TrafficConfig, make_trace,
                                   unique_payloads)

    t0 = time.perf_counter()
    trace = make_trace(TrafficConfig(
        tenants=tenants, machines=machines, ticks=ticks, n=block_n, d=d,
        packed_fraction=0.5, p_duplicate=0.05, p_reorder=0.05, p_drop=0.02,
        seed=3))
    t_trace = time.perf_counter() - t0
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = ServeConfig(tenants=tenants, machines=machines, d=d,
                      block_n=block_n, snapshot_every=4, reorder_ticks=2,
                      fold_budget=8 * tenants, queue_capacity=16 * tenants)
    srv = StructureServer(cfg, workdir)
    split = TickSplit().install()
    try:
        t0 = time.perf_counter()
        tele, counts = counted(total, lambda: _drive(srv, trace))
        sync()
        wall = time.perf_counter() - t0
        device_s = split.device_seconds()
    finally:
        split.remove()
    # the solve syncs with the host once a Boruvka round, so its device
    # time comes from the profiler: one more solve of every tenant
    solve_ms = device_ms(srv.force_resolve, 1)
    folds = sorted(t["fold_seconds"] for t in tele)
    rows = sum(t["rows"] for t in tele)
    n_ticks = len(tele)
    expect(counts["sign_corr"] > 0 and counts["sign_corr_packed"] > 0,
           f"the server launched {counts}")
    expect(srv.log.buffered() == 0, "the server did not drain clean")
    parts = {**device_s, **split.host}
    other = wall - sum(split.host.values())
    log(f"phase 10 server {tenants} tenants x {machines} machines, d={d}, "
        f"block_n={block_n}, {ticks} ticks + 4 drain ticks + a final solve "
        f"(trace made in {t_trace:.1f} s): wall_s={wall:.3f} "
        f"ticks_per_s={n_ticks / wall:.4f} rows_per_s={rows / wall:.1f} "
        f"fold_p50_ms={1e3 * folds[len(folds) // 2]:.3f} "
        f"fold_p99_ms={1e3 * folds[int(len(folds) * 0.99)]:.3f} "
        f"launches={json.dumps(counts)}")
    log("phase 10 a tick's split, ms a tick: " + " ".join(
        f"{k}={1e3 * v / n_ticks:.3f}" for k, v in parts.items())
        + f" other={1e3 * other / n_ticks:.3f} (host ms outside the parts: "
        f"drain, cursors, batch assembly, host->device; the device parts "
        f"lie inside the host's); a {tenants}-tenant solve's kernels "
        f"(torch.profiler) {solve_ms:.3f} ms")
    last = tele[-1]
    log("phase 10 telemetry: " + json.dumps({k: last[k] for k in (
        "duplicates", "reordered", "lost", "degraded_tenants",
        "watchdog_fires", "rejected")}))

    t0 = time.perf_counter()
    refs = {}
    for p in unique_payloads(trace):
        sg = refs.setdefault(p.tenant, StreamingGram(d))
        if p.kind == "codes":
            sg.update_codes(p.codes)
        else:
            sg.update_packed(p.packed, p.n)
    for t, sg in refs.items():
        expect(np.array_equal(sg.gram.cpu().numpy().astype(np.float64),
                              srv.table.gram[t])
               and sg.n == int(srv.table.n[t]),
               f"tenant {t}: the server's accumulator != the exactly-once "
               f"StreamingGram fold")
    expect(len(refs) == tenants, "a tenant received nothing")
    log(f"phase 10 folds exactly once: {tenants} accumulators == the "
        f"exactly-once StreamingGram fold on the card, bit for bit "
        f"({time.perf_counter() - t0:.1f} s); drained_clean=True")
    srv.close()
    shutil.rmtree(workdir, ignore_errors=True)


_CRASH_CHILD = """\
import sys
sys.path.insert(0, {src!r})
from repro_torch.serve import (ServeConfig, StructureServer, TrafficConfig,
                               make_trace)

srv = StructureServer(ServeConfig(**{scfg!r},
                                  crash_after_journal_records={crash}),
                      sys.argv[1])
for batch in make_trace(TrafficConfig(**{tcfg!r})):
    for p in batch:
        srv.submit(p)
    srv.run_tick()
print("SURVIVED")
sys.exit(3)
"""

#: repro's crash configuration (``benchmarks/serve.py``), widened to d = 250
CRASH_TRAFFIC = dict(tenants=8, machines=3, ticks=12, n=24, d=250,
                     p_duplicate=0.25, p_reorder=0.25, p_drop=0.1, seed=11)
CRASH_SERVE = dict(tenants=8, machines=3, d=250, block_n=24,
                   snapshot_every=3, reorder_ticks=2)

PERSYMBOL_TRAFFIC = dict(tenants=16, machines=4, ticks=8, n=256, d=1024,
                         method="persymbol", rate=4, p_duplicate=0.05,
                         p_reorder=0.05, p_drop=0.02, seed=5)
PERSYMBOL_SERVE = dict(tenants=16, machines=4, d=1024, method="persymbol",
                       rate=4, block_n=256, snapshot_every=4,
                       reorder_ticks=2)


def _equal_states(a, b, what):
    import numpy as np

    sa, sb = a.comparable_state(), b.comparable_state()
    for k in sa:
        expect(np.array_equal(sa[k], sb[k]), f"{what}: {k} differs")


def serve_correctness(dev, workdir, total, crash_after=60):
    """Phase 11: the server's correctness on the card. Crash recovery
    (a child on the card SIGKILLs itself after ``crash_after`` journal
    records) is bit-identical to the clean run; the card and the CPU give
    equal states and per-tick telemetry on the sign trace; a per-symbol
    R = 4 run gives card-vs-CPU Grams within code_tolerance and equal
    trees."""
    import shutil

    import numpy as np
    from repro_torch.core.gram import GramEngine
    from repro_torch.serve import (ServeConfig, StructureServer,
                                   TrafficConfig, make_trace)

    t_start = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    cpu = GramEngine(device="cpu")
    trace = make_trace(TrafficConfig(**CRASH_TRAFFIC))
    clean = StructureServer(ServeConfig(**CRASH_SERVE),
                            os.path.join(workdir, "clean"))
    tele_card, _ = counted(total, lambda: _drive(clean, trace))
    crash_dir = os.path.join(workdir, "crash")
    child = _CRASH_CHILD.format(src=os.path.join(ROOT, "src"),
                                scfg=CRASH_SERVE, tcfg=CRASH_TRAFFIC,
                                crash=crash_after)
    r = subprocess.run([sys.executable, "-c", child, crash_dir],
                       capture_output=True, text=True, timeout=600)
    expect(r.returncode == -9, f"the crash child exited {r.returncode}, "
           f"not by SIGKILL: {r.stdout[-2000:]} {r.stderr[-2000:]}")
    srv = StructureServer(ServeConfig(**CRASH_SERVE), crash_dir)
    recovered = (srv.recovered_records, srv.snapshot_step)
    counted(total, lambda: _drive(srv, trace))
    _equal_states(clean, srv, "crash recovery on the card")
    log(f"phase 11 crash recovery on the card (d={CRASH_SERVE['d']}, "
        f"SIGKILL after "
        f"{crash_after} journal records; replayed {recovered[0]} records "
        f"after snapshot {recovered[1]}): state == the clean run's, bit "
        f"for bit")
    srv.close()

    host = StructureServer(ServeConfig(**CRASH_SERVE, engine=cpu),
                           os.path.join(workdir, "cpu"))
    tele_cpu = _drive(host, trace)
    _equal_states(clean, host, "card vs CPU server")
    diff = [(i, {k: (a[k], b[k]) for k in a
                 if k != "fold_seconds" and a[k] != b[k]})
            for i, (a, b) in enumerate(zip(tele_card, tele_cpu))]
    diff = [d for d in diff if d[1]]
    expect(len(tele_card) == len(tele_cpu) and not diff,
           f"card and CPU per-tick telemetry differ: {diff[:3]}")
    log(f"phase 11 card == CPU server (d={CRASH_SERVE['d']}): equal state and "
        f"{len(tele_card)} ticks of telemetry")
    clean.close(), host.close()

    scfg = PERSYMBOL_SERVE
    trace = make_trace(TrafficConfig(**PERSYMBOL_TRAFFIC))
    card = StructureServer(ServeConfig(**scfg),
                           os.path.join(workdir, "persymbol-card"))
    _, counts = counted(total, lambda: _drive(card, trace))
    expect(counts["code_corr"] > 0, f"the per-symbol server launched "
           f"{counts}")
    host = StructureServer(ServeConfig(**scfg, engine=cpu),
                           os.path.join(workdir, "persymbol-cpu"))
    _drive(host, trace)
    a, b = card.comparable_state(), host.comparable_state()
    for k in ("n", "cursors", "lost", "adj"):
        expect(np.array_equal(a[k], b[k]), f"per-symbol card vs CPU: {k} "
               f"differs")
    err = np.abs(a["gram"] - b["gram"])
    bound = 1e-5 * a["n"][:, None, None] + 1e-5 * np.abs(b["gram"])
    expect(bool((err <= bound).all()), f"per-symbol card vs CPU Grams: "
           f"max |err| {float(err.max())}")
    log(f"phase 11 per-symbol R=4 server ({scfg['tenants']} tenants, "
        f"d={scfg['d']}, {PERSYMBOL_TRAFFIC['ticks']} ticks): "
        f"card vs CPU max |gram error| {float(err.max())}, equal trees; "
        f"phase 11 took {time.perf_counter() - t_start:.1f} s")
    card.close(), host.close()
    shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 12: the trial plane
# ---------------------------------------------------------------------------

#: benchmarks/trials.py's point, the paper's Fig. 3: d = 20, four ns, the
#: six strategies of FIG3_STRATEGIES, 30 reps (720 trials)
TRIALS_FIG3 = dict(d=20, ns=(125, 250, 500, 1000), reps=30)
#: benchmarks/bigd.py's width: d = 1024 at n up to 8192, 32 reps
TRIALS_BIGD = dict(d=1024, ns=(2048, 8192), reps=32)
#: benchmarks/faults.py's plan (seed0 = 7, its three strategies) at the
#: large width, and cut to d = 64, 8 reps for the card-vs-CPU check
TRIALS_FAULTS = dict(d=1024, ns=(8192,), reps=32, seed0=7)
TRIALS_FAULTS_CUT = dict(d=64, ns=(1024,), reps=8, seed0=7)
#: benchmarks/faults.py's mixed_faults plan with its machines widened from
#: 4 to 16, which divide d = 1024 and d = 64
MIXED_FAULTS = dict(dropout=0.15, straggle=0.3, straggle_frac=0.5,
                    bitflip=0.005, retries=1, machines=16, seed=1)
#: (d, n, b, n_valid) of the kernels' checks at the trial plane's shapes:
#: Fig. 3's largest bucket (b = 30 trials) and the d = 1024 plan's
TRIAL_KERNEL_SHAPES = ((20, 1024, 30, 1000), (1024, 8192, 32, 8000))
#: the result fields card and CPU must agree on exactly
TRIAL_FIELDS = ("error_rate", "edit_distance", "edge_f1", "buckets",
                "host_syncs", "faults", "tiling")


def _packed_strategies():
    from repro_torch.core import Strategy

    # their labels ("sign", "R2") are FIG3_STRATEGIES' own and a plan's
    # labels are unique, so the packed wires sweep as a second plan over
    # the same trials
    return (Strategy("sign", wire="packed"),
            Strategy("persymbol", rate=2, wire="packed"))


def _fault_strategies():
    from repro_torch.core import Strategy

    return (Strategy("sign", wire="packed"), Strategy("persymbol", rate=4),
            Strategy("original"))


def _same_results(a, b, what, fields=TRIAL_FIELDS, comm=True):
    import dataclasses

    for f in fields:
        expect(getattr(a, f) == getattr(b, f), f"{what}: {f} differs "
               f"({getattr(a, f)} vs {getattr(b, f)})")
    if not comm:
        return
    ca = {k: [dataclasses.asdict(r) for r in v] for k, v in a.comm.items()}
    cb = {k: [dataclasses.asdict(r) for r in v] for k, v in b.comm.items()}
    expect(ca == cb, f"{what}: the CommReports differ")


#: card vs CPU weights of one trial: max |difference| <= TIE_RTOL * max |w|
#: (code_corr's f32-accurate Grams against the CPU's exactly rounded ones)
TIE_RTOL = 1e-5
METRIC_FIELDS = ("error_rate", "edit_distance", "edge_f1", "precision",
                 "recall")


def card_vs_cpu_sweep(plan, card, host, dev, what):
    """Hold a sweep's card results to its CPU results: every field equal,
    or, for the metrics, different only through trials whose two trees
    are both maximum spanning trees of weights that agree within
    TIE_RTOL — a tie, broken one way by the card's rounding and the other
    by the CPU's. Recomputes each differing point's weights and trees on
    both devices and checks that they reproduce both results. Returns the
    ties found as (label, n, trial, weight gap, max |w_card - w_cpu|)."""
    import numpy as np
    import torch
    from repro_torch.core import experiments
    from repro_torch.core.chow_liu import boruvka_mst_batch
    from repro_torch.core.faults import fault_trial_keys
    from repro_torch.core.gram import GramEngine

    _same_results(card, host, what, fields=[
        f for f in TRIAL_FIELDS if f not in METRIC_FIELDS])
    ties = []
    for s in plan.strategies:
        for j, n in enumerate(plan.ns):
            if all(getattr(card, f)[s.label][j] == getattr(host, f)[s.label][j]
                   for f in METRIC_FIELDS):
                continue
            got = {}
            for where in (dev, "cpu"):
                where = str(torch.device(where))
                parents, rhos, adj, keys = experiments._plan_setup(
                    *experiments._setup_key(plan), where)
                extra = () if plan.faults is None else (
                    plan.faults, fault_trial_keys(plan.faults, plan.reps,
                                                  device=where))
                w = experiments._stacked_weights(
                    keys, parents, rhos, n, (s,), plan.bucket_for(n),
                    GramEngine(), *(extra or (None, None)),
                    experiments._rates_operand((s,), n, plan.d, where))
                w = (w if plan.faults is None else w[0])[0]
                t = boruvka_mst_batch(w, early_exit=False)
                ham = ((t != adj).sum(dim=(1, 2)) // 2).cpu().numpy()
                got[where] = (w.double().cpu(), t.cpu(), ham)
            (wc, tc, hc), (wh, th, hh) = got[str(torch.device(dev))], \
                got["cpu"]
            for res, ham in ((card, hc), (host, hh)):
                expect(res.edit_distance[s.label][j] == float(
                    np.float32(ham.sum()) / np.float32(plan.reps)),
                    f"{what}: recomputed trees of {s.label} n={n} do not "
                    f"give the sweep's edit distance")
            ties += trace_ties(wc, tc, wh, th, plan.d,
                               f"{what}: {s.label} n={n}", (s.label, n))
    return ties


def trace_ties(wa, ta, wb, tb, d, what, tag=()):
    """Hold each trial whose trees ``ta`` and ``tb`` (of weights ``wa``
    and ``wb``, (r, d, d) on the host) differ to a tie: the weights agree
    within TIE_RTOL, and tree ``ta`` falls short of ``tb``'s maximum by
    no more than the weights' difference can explain. Returns (*tag,
    trial, weight gap, max |wa - wb|) of each."""
    import numpy as np

    ties = []
    for k in np.flatnonzero((ta != tb).flatten(1).any(1).numpy()):
        delta = float((wa[k] - wb[k]).abs().max())
        expect(delta <= TIE_RTOL * float(wb[k].abs().max()),
               f"{what} trial {k}: the weights differ by {delta}")
        gap = float(wb[k][tb[k]].sum() - wb[k][ta[k]].sum()) / 2
        expect(0.0 <= gap <= 2 * (d - 1) * delta,
               f"{what} trial {k}: one tree is {gap} below the other's "
               f"maximum, beyond a tie at {delta}")
        ties.append((*tag, int(k), gap, delta))
    return ties


def _profile(fn):
    """(result, wall s, device busy ms, device->host copies, profile) of
    fn() under torch.profiler: busy is the kernels' and copies' device
    time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total", 0) or 0
               for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", "")))
    dtoh = sum(1 for e in prof.events()
               if "CUDA" in str(getattr(e, "device_type", ""))
               and "DtoH" in e.name)
    expect(busy > 0, "the profiler saw no device time")
    return out, wall, busy / 1e3, dtoh, prof


def profiled(fn):
    """(result, wall s, device busy ms, device->host copies) of fn()."""
    return _profile(fn)[:4]


def check_trial_kernels(dev, reps):
    """The four kernels of the trial plane against their plain versions on
    the operands its sweeps give them: b = 30 trials at d = 20 (Fig. 3,
    n = 1024, rows off 16 bytes) and b = 32 at d = 1024 (n = 8192), from
    the row-keyed sampler, masked to n_valid or to fault counts. Timed at
    the larger shape; returns {kernel: trial record}."""
    import torch
    from repro_torch.core import estimators, sampler
    from repro_torch.core.experiments import (TrialPlan, stacked_trees,
                                              trial_keys)
    from repro_torch.core.faults import FaultPlan, fault_trial_keys
    from repro_torch.core.quantizers import PerSymbolQuantizer, codebook_tensors
    from repro_torch.core.strategy import Strategy
    from repro_torch.kernels import (code_corr, quantize_fused, ref,
                                     sign_corr, sign_corr_packed)

    out = {}
    for d, n, b, n_valid in TRIAL_KERNEL_SHAPES:
        plan = TrialPlan(d=d, ns=(n,), reps=b)
        parents, rhos, _ = stacked_trees(plan, device=dev)
        x = sampler.sample_tree_ggm_rows_batch(trial_keys(plan, device=dev),
                                               n, parents, rhos)
        shape = f"b={b} n={n} d={d}"
        for rate in (1, 2, 4):
            bounds, _ = codebook_tensors(rate, dev)
            expect(torch.equal(quantize_fused(x, rate),
                               ref.encode_ref(x, bounds)),
                   f"quantize_fused R={rate} at the trial shape {shape}")
        u = estimators.strategy_payload(x, Strategy(), n_valid=n_valid)
        expect(torch.equal(sign_corr(u), ref.sign_corr_ref(u)),
               f"sign_corr at the trial shape {shape}")
        fp = FaultPlan(**MIXED_FAULTS) if d % 16 == 0 else FaultPlan(
            dropout=0.2, straggle=0.3, bitflip=0.01, machines=4, seed=1)
        n_rows, flip, _ = fp.draw_batch(fault_trial_keys(fp, b, device=dev),
                                        n, n_valid, d)
        sp = Strategy("sign", wire="packed")
        uf = estimators.payload_operand(estimators.strategy_payload(
            x, sp, n_valid=n_valid, n_rows=n_rows, flip=flip), sp,
            n_rows=n_rows)
        expect(torch.equal(sign_corr(uf), ref.sign_corr_ref(uf)),
               f"sign_corr on the faulty unpacked wire at {shape}")
        p = estimators.strategy_payload(x, sp, n_valid=n_valid)
        expect(torch.equal(sign_corr_packed(p, n),
                           ref.sign_corr_packed_ref(p, n)),
               f"sign_corr_packed at the trial shape {shape}")
        for s in (Strategy("persymbol", rate=4),
                  Strategy("persymbol", rate=2, wire="packed")):
            c = estimators.payload_operand(estimators.strategy_payload(
                x, s, n_valid=n_valid), s, n_valid=n_valid)
            cb = torch.as_tensor(PerSymbolQuantizer(s.rate).centroids_np,
                                 device=dev)
            want = ref.code_corr_ref(c, cb)
            err = (code_corr(c, cb) - want).abs()
            expect(bool((err <= code_tolerance(n, want)).all()),
                   f"code_corr R={s.rate} at the trial shape {shape}: max "
                   f"|err| {float(err.max())}")
        del u, uf, p, c, want, err, n_rows, flip
    log("phase 12 trial shapes (" + "; ".join(
        f"b={b} n={n} d={d}" for d, n, b, _ in TRIAL_KERNEL_SHAPES)
        + "): sign_corr (int8, and the faulty unpacked wire), "
        "sign_corr_packed, code_corr (R=4 int8, R=2 packed), "
        "quantize_fused (R=1, 2, 4) equal their plain versions")

    # timings at b = 32, n = 8192, d = 1024 (x from the last loop)
    u = estimators.strategy_payload(x, Strategy())
    p = estimators.strategy_payload(x, Strategy("sign", wire="packed"))
    c = PerSymbolQuantizer(4).encode(x)
    cb = torch.as_tensor(PerSymbolQuantizer(4).centroids_np, device=dev)
    b4, _ = codebook_tensors(4, dev)
    out_bytes = b * d * d * 4
    ops = 2 * b * n * d * d

    def trial_record(name, fn, plain, library, bytes_moved, n_ops, rate):
        rec = make_record("phase 12 trial", name, "", "", shape,
                          event_ms(fn, reps), event_ms(plain, reps),
                          event_ms(library, reps), bytes_moved, n_ops, rate,
                          0.0)
        out[name] = {k: rec[k] for k in ("shape", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")}

    uf = u.to(torch.float32)
    ut = uf.transpose(1, 2).contiguous()
    trial_record("sign_corr", lambda: sign_corr(u),
                 lambda: ref.sign_corr_ref(u), lambda: torch.bmm(ut, uf),
                 u.numel() + out_bytes, ops, INT8_TENSOR_OPS_PER_S)
    del uf, ut
    pf = ref.unpack_signs_pm1(p, n)
    pt = pf.transpose(1, 2).contiguous()
    trial_record("sign_corr_packed", lambda: sign_corr_packed(p, n),
                 lambda: ref.sign_corr_packed_ref(p, n),
                 lambda: torch.bmm(pf, pt), p.numel() + out_bytes, ops,
                 INT8_TENSOR_OPS_PER_S)
    del pf, pt
    dec = ref.decode_codes(c, cb)
    dt = dec.transpose(1, 2).contiguous()
    trial_record("code_corr", lambda: code_corr(c, cb),
                 lambda: ref.code_corr_ref(c, cb), lambda: torch.bmm(dt, dec),
                 c.numel() + 16 * 4 + out_bytes, 3 * ops,
                 TF32_TENSOR_OPS_PER_S)
    del dec, dt
    trial_record("quantize_fused", lambda: quantize_fused(x, 4),
                 lambda: ref.encode_ref(x, b4),
                 lambda: torch.bucketize(x, b4), x.numel() * 5 + 31 * 4,
                 4 * x.numel(), F32_OPS_PER_S)
    del x, u, p, c
    torch.cuda.empty_cache()
    return out


def sweep_card_and_cpu(plan, dev, total, what):
    """A sweep cold, warm and profiled on the card and once on the CPU:
    one host read, one device->host copy in the profile of a warm sweep,
    the reruns equal to the cold run, and card == CPU (but for ties).
    Returns the cold result."""
    from repro_torch.core.experiments import run_trials

    card, counts = counted(total, lambda: run_trials(plan, device=dev))
    warm, _ = counted(total, lambda: run_trials(plan, device=dev))
    (prof, wall, busy, dtoh), _ = counted(
        total, lambda: profiled(lambda: run_trials(plan, device=dev)))
    host, t_cpu = timed(lambda: run_trials(plan, device="cpu"))
    expect(card.host_syncs == warm.host_syncs == prof.host_syncs == 1,
           f"{what}: host_syncs {card.host_syncs}")
    expect(dtoh == 1, f"{what}: a warm sweep made {dtoh} device->host "
           f"copies, not 1")
    ties = card_vs_cpu_sweep(plan, card, host, dev, f"{what} card vs CPU")
    _same_results(warm, card, f"{what} warm vs cold")
    _same_results(prof, card, f"{what} profiled vs cold")
    log(f"{what}: {plan.trials} trials, card cold {card.seconds:.4f} s, "
        f"warm {warm.seconds:.4f} s ({warm.trials_per_s:.1f} trials/s; "
        f"profiled wall {wall:.4f} s, device busy {busy:.3f} ms, idle "
        f"{100 * (1 - busy / 1e3 / wall):.1f}%, device->host copies "
        f"{dtoh}); CPU {t_cpu:.2f} s; card == CPU"
        f"{' but for ties (label, n, trial, gap, max |dw|): '
           + json.dumps(ties) if ties else ''}; "
        f"buckets={card.buckets} launches={json.dumps(counts)}")
    log(f"{what} error_rate={json.dumps(card.error_rate)}")
    return card


def fig3_sweeps(dev, total):
    """Part 1: the Fig. 3 sweep with pow2 buckets and exact shapes, and
    the packed wires over the same trials, on the card and on the CPU
    (:func:`sweep_card_and_cpu`)."""
    from repro_torch.core import FIG3_STRATEGIES
    from repro_torch.core.experiments import TrialPlan

    for strategies, what in ((FIG3_STRATEGIES, "FIG3"),
                             (_packed_strategies(), "packed")):
        for buckets in ("pow2", None):
            plan = TrialPlan(strategies=strategies, n_buckets=buckets,
                             **TRIALS_FIG3)
            sweep_card_and_cpu(plan, dev, total, f"phase 12 Fig. 3 {what} "
                               f"n_buckets={buckets}")


def bigd_sweeps(dev, total):
    """Part 2: the sweep at d = 1024 (FIG3_STRATEGIES, then the packed
    wires over the same trials: 512 trials): cold and warm seconds and
    trials/s, the device's idle share, peak memory, the tiling chosen, a
    stage split from run_trials' own spans (its results held to the cold
    run's), and the card's sampler against the CPU's at a row block of
    the plan."""
    import torch
    from repro_torch import trace
    from repro_torch.core import FIG3_STRATEGIES, prng
    from repro_torch.core.experiments import (TrialPlan, clear_compile_caches,
                                              run_trials, trial_keys)
    from repro_torch.kernels import row_normals

    plans = [TrialPlan(strategies=s, **TRIALS_BIGD)
             for s in (FIG3_STRATEGIES, _packed_strategies())]
    trials = sum(p.trials for p in plans)
    clear_compile_caches()
    torch.cuda.empty_cache()
    cold, launches = [], {}
    for plan in plans:
        (res, t), counts = counted(total, lambda: timed(
            lambda: run_trials(plan, device=dev)))
        cold.append((res, t))
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for k in ("sign_corr", "sign_corr_packed", "code_corr",
              "quantize_fused", "row_normals"):
        expect(launches[k] > 0, f"the d=1024 sweeps launched no {k}")
    torch.cuda.reset_peak_memory_stats()
    warm = [counted(total, lambda: run_trials(plan, device=dev))[0] for plan in plans]
    peak = torch.cuda.max_memory_allocated()
    wall = busy = 0.0
    for plan, (c, _), w in zip(plans, cold, warm):
        (p, t, b, dtoh), _ = counted(
            total, lambda: profiled(lambda: run_trials(plan, device=dev)))
        wall, busy = wall + t, busy + b
        expect(dtoh == 1, f"a warm d=1024 sweep made {dtoh} device->host "
               f"copies")
        expect(c.host_syncs == 1, "a d=1024 sweep read the host twice")
        _same_results(w, c, "d=1024 warm vs cold")
        _same_results(p, c, "d=1024 profiled vs cold")
    cold_s = sum(t for _, t in cold)
    warm_s = sum(w.seconds for w in warm)
    log(f"phase 12 d=1024 sweeps ({trials} trials: FIG3 + packed, ns="
        f"{TRIALS_BIGD['ns']}, reps={TRIALS_BIGD['reps']}): cold "
        f"{cold_s:.3f} s ({trials / cold_s:.1f} trials/s, setup included), "
        f"warm {warm_s:.3f} s ({trials / warm_s:.1f} trials/s); profiled "
        f"warm wall {wall:.3f} s, device busy {busy:.1f} ms, idle "
        f"{100 * (1 - busy / 1e3 / wall):.1f}%; peak_bytes={peak}; "
        f"tiling={json.dumps(cold[0][0].tiling)} "
        f"buckets={cold[0][0].buckets} launches={json.dumps(launches)}")
    for (res, _) in cold:
        log(f"phase 12 d=1024 error_rate={json.dumps(res.error_rate)} "
            f"edit_distance={json.dumps(res.edit_distance)}")

    # the stage split from the entry's own spans (CUDA events)
    split = dict.fromkeys(("sample", "stats", "mst", "readback"), 0.0)
    reads = 0
    for plan, (c, _) in zip(plans, cold):
        with trace.recording() as spans:
            traced, _ = counted(total, lambda: run_trials(plan, device=dev))
        _same_results(traced, c, "d=1024 traced vs cold")
        (root,) = [r for r in spans if r.parent is None]
        reads += root.counts.get("host_reads", 0)
        for r in spans:
            if r.parent == root.id:
                split[r.name.removeprefix("repro_torch.")] += r.seconds
    log("phase 12 d=1024 stage split, s (both plans, the entry's spans): "
        + " ".join(f"{k}={v:.4f}" for k, v in split.items())
        + f" host_reads={reads}")

    # the sampler's last row block of the plan, on the card and the CPU
    plan = plans[0]
    n = max(plan.ns)
    r0 = n - 64
    out = {}
    for where in (dev, "cpu"):
        keys = trial_keys(plan, device=where)
        rows = prng.fold_in(keys[:, None, :],
                            torch.arange(r0, n, device=keys.device))
        out[where] = (prng.uniform(rows, (plan.d,),
                                   minval=prng._NORMAL_LO).cpu(),
                      row_normals(keys, r0, n, plan.d).cpu())
    (uc, zc), (uh, zh) = out[dev], out["cpu"]
    expect(torch.equal(uc, uh), "card and CPU uniforms differ")
    rel = float(((zc - zh).abs() / zh.abs().clamp_min(1e-30)).max())
    expect(rel <= 2.0 ** -21, f"card and CPU normals differ by {rel} "
           f"relative")
    log(f"phase 12 sampler rows {r0}..{n} of {plan.reps} trials at d="
        f"{plan.d}: card uniforms == CPU uniforms bit for bit; normals "
        f"max relative difference {rel} (tolerance 2^-21), "
        f"{float((zc == zh).float().mean()):.6f} of them equal")
    del out, uc, zc, uh, zh


def fault_sweeps(dev, total):
    """Part 3: benchmarks/faults.py's mixed plan at d = 1024: a zero-fault
    plan bit-identical to none on the card (weights and results), the
    mixed sweep's telemetry and retry accounting, and the cut run's
    faults and retries card == CPU."""
    import dataclasses

    import torch
    from repro_torch.core import experiments
    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan, fault_trial_keys
    from repro_torch.core.gram import GramEngine

    plan = TrialPlan(strategies=_fault_strategies(), **TRIALS_FAULTS)
    zero = dataclasses.replace(plan, faults=FaultPlan(machines=16,
                                                      retries=1))
    mixed = dataclasses.replace(plan, faults=FaultPlan(**MIXED_FAULTS))
    n = plan.ns[0]
    parents, rhos, _, keys = experiments._plan_setup(
        *experiments._setup_key(plan), str(torch.device(dev)))
    engine = GramEngine()
    w = experiments._stacked_weights(keys, parents, rhos, n, plan.strategies,
                                     plan.bucket_for(n), engine)
    wz, tele = experiments._stacked_weights(
        keys, parents, rhos, n, plan.strategies, plan.bucket_for(n), engine,
        zero.faults, fault_trial_keys(zero.faults, plan.reps, device=dev))
    expect(torch.equal(w, wz) and not bool(tele.any()),
           "the zero-fault plan's weights differ from no plan's")
    del w, wz
    none_r, _ = counted(total, lambda: run_trials(plan, device=dev))
    zero_r, _ = counted(total, lambda: run_trials(zero, device=dev))
    _same_results(zero_r, none_r, "zero-fault vs no faults",
                  fields=("error_rate", "edit_distance", "edge_f1",
                          "buckets", "host_syncs"), comm=False)
    mixed_r, counts = counted(total, lambda: run_trials(mixed, device=dev))
    expect(mixed_r.host_syncs == 1, "the faulty sweep read the host twice")
    retry = {k: [(r.retry_bytes, r.retry_collectives) for r in v]
             for k, v in mixed_r.comm.items()}
    log(f"phase 12 faults d={plan.d} n={n} reps={plan.reps}: zero-fault "
        f"plan == no plan bit for bit (weights and results); mixed "
        f"{mixed_r.seconds:.3f} s ({mixed_r.trials_per_s:.1f} trials/s) "
        f"error_rate={json.dumps(mixed_r.error_rate)} (lossless "
        f"{json.dumps(none_r.error_rate)}) faults="
        f"{json.dumps(mixed_r.faults)} retry (bytes, rounds)="
        f"{json.dumps(retry)} launches={json.dumps(counts)}")
    cut = TrialPlan(strategies=_fault_strategies(),
                    faults=FaultPlan(**MIXED_FAULTS), **TRIALS_FAULTS_CUT)
    card, _ = counted(total, lambda: run_trials(cut, device=dev))
    host = run_trials(cut, device="cpu")
    ties = card_vs_cpu_sweep(cut, card, host, dev,
                             "the cut faulty sweep card vs CPU")
    log(f"phase 12 faults cut (d={cut.d}, reps={cut.reps}, ns={cut.ns}): "
        f"card == CPU in TrialResult.faults and CommReport retry fields, "
        f"and in metrics{' but for ties: ' + json.dumps(ties) if ties else ''}"
        f"; faults={json.dumps(card.faults)}")


#: the sweep's block of row-keyed normals (fig3-d1024-sweep: 120 trials x
#: 136 rows x d = 1024, 2^24 // (120 x 1024) rows a block), at the rows of
#: its 60th block at n = 8192
ROW_NORMALS_BLOCK = (120, 136, 1024)
ROW_NORMALS_R0 = 136 * 59
#: uint32 operations a normal takes in the kernel: threefry's 2 key adds,
#: 20 rounds of add, rotate and xor, 5 injections of 2 adds, the xor of
#: its words, the uniform's shift and or
ROW_NORMAL_INT_OPS = 2 + 20 * 3 + 5 * 2 + 1 + 2
#: 32-bit integer operations a second: 132 SMs x 64 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def check_row_normals(dev, reps):
    """Phase 12 (row normals): the kernel against its plain version at
    the sweep's block shape with the innovation scale, bit for bit, both
    timed, with torch.randn (Philox, another generator) as the library's
    yardstick; returns the kernel's record."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import ref, row_normals

    t, rows, d = ROW_NORMALS_BLOCK
    r0, r1 = ROW_NORMALS_R0, ROW_NORMALS_R0 + rows
    keys = prng.fold_in(prng.key(2 ** 32 - 1, device=dev),
                        torch.arange(t, device=dev))
    gen = torch.Generator(device=dev).manual_seed(12)
    scale = torch.rand((t, d), generator=gen, device=dev) + 0.4
    got = row_normals(keys, r0, r1, d, scale)
    want = ref.row_normals_ref(keys, r0, r1, d, scale)
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = float((got - want).abs().max())
    expect(differ == 0, f"row_normals at t={t} rows={rows} d={d}: {differ} "
           f"of {got.numel()} normals differ from the plain version, by up "
           f"to {err}")
    del got, want
    n = t * rows * d
    rec = make_record(
        "phase 12", "row_normals", "row_normals.cu",
        "none (port-only: repro has no Pallas sampler)",
        f"t={t} rows={rows} d={d} (rows {r0}..{r1}) scaled",
        event_ms(lambda: row_normals(keys, r0, r1, d, scale), reps),
        event_ms(lambda: ref.row_normals_ref(keys, r0, r1, d, scale), reps),
        event_ms(lambda: torch.randn((t, rows, d), device=dev), reps),
        4 * n + keys.numel() * 8 + scale.numel() * 4,
        ROW_NORMAL_INT_OPS * n, INT32_OPS_PER_S, err)
    log(f"phase 12 row_normals: kernel == plain version bit for bit at "
        f"t={t} rows={rows} d={d}; {rec['plain_ms'] / rec['ms']:.1f}x the "
        f"plain version")
    torch.cuda.empty_cache()
    return rec


def trial_plane(dev, total, records, reps):
    """Phase 12: the trial plane on the card: its kernels at its shapes,
    then parts 1-3 above. Adds each kernel's trial record to
    ``records``, and the row-normals kernel's own record."""
    t0 = time.perf_counter()
    trial = check_trial_kernels(dev, reps)
    for r in records:
        if r["name"] in trial:
            r["trial"] = trial[r["name"]]
    records.append(check_row_normals(dev, reps))
    fig3_sweeps(dev, total)
    bigd_sweeps(dev, total)
    fault_sweeps(dev, total)
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 13: the sparse plane
# ---------------------------------------------------------------------------

#: examples/sparse_glasso.py's plan, uncut: d = 16, three ns, 32 reps of
#: sign, R2, R4 and original at lam = 0.06 (384 trials), 300 ISTA steps
SPARSE_SWEEP = dict(d=16, ns=(250, 1000, 4000), tree="sparse", density=0.18,
                    rho_min=0.25, rho_max=0.45, reps=32, glasso_steps=300)
SPARSE_LAM = 0.06
#: the example's path grid
SPARSE_PATH = dict(n_lams=6, lam_min_ratio=0.08)
#: the width: d = 128 at d = 16's expected degree (~2.7 edges a node);
#: 8 reps (16 before phase 16 joined the script, to keep it short)
SPARSE_WIDE = dict(d=128, ns=(4096,), tree="sparse", density=0.02,
                   rho_min=0.25, rho_max=0.45, reps=8, glasso_steps=300)
#: reps of the width sweep when its solve alone passes SPARSE_SOLVE_LIMIT_S
SPARSE_WIDE_CUT_REPS = 4
SPARSE_SOLVE_LIMIT_S = 120.0
#: (batch, d) of the eigh calls whose time phase 13 logs: the width
#: sweep's d at three batches, and both sides of d = 32
EIGH_SHAPES = ((16, 128), (48, 128), (96, 128), (128, 32), (128, 33))
#: tests/test_faults.py's sparse plan
SPARSE_FAULTS = dict(d=8, ns=(64,), reps=6, seed0=3, tree="sparse")
SPARSE_FAULT_PLAN = dict(dropout=0.3, machines=4, seed=8)


def _sparse_strategies(methods):
    from repro_torch.core import Strategy

    table = {"sign": Strategy("sign", structure="sparse", lam=SPARSE_LAM),
             "R2": Strategy("persymbol", rate=2, structure="sparse",
                            lam=SPARSE_LAM),
             "R4": Strategy("persymbol", rate=4, structure="sparse",
                            lam=SPARSE_LAM),
             "original": Strategy("original", structure="sparse",
                                  lam=SPARSE_LAM)}
    return tuple(table[m] for m in methods)


def sparse_card_vs_cpu(plan, card, host, dev, what):
    """Hold a sparse sweep's card results to its CPU results: fault
    telemetry, buckets and reads equal; a metric (or a path's per-lam
    curve or selection count) may differ only as
    experiments.sparse_sweep_faults allows: the point, solved alone on
    each device, gives exactly what that device's sweep gave it, and the
    card's supports part from the CPU's only at entries within
    glasso.THRESHOLD_BAND of the threshold (or at tied EBIC picks).
    Returns the points solved again, as (label, n, entries parted)."""
    from repro_torch.core.experiments import sparse_sweep_faults

    _same_results(card, host, what, fields=("buckets", "host_syncs",
                                            "faults"), comm=False)
    parted, faults = sparse_sweep_faults(plan, card, host, device=dev,
                                         ref_device="cpu")
    expect(not faults, f"{what}: {faults}")
    return parted


def check_sparse_kernels(plan, dev, what):
    """The kernels of a phase-13 plan against their plain versions at the
    shapes its sweep gives them: at each point, the sparse sampler's
    (reps, n_bucket, d) draws; quantize_fused at each per-symbol rate bit
    for bit, and every strategy's Gram through the kernels against the
    torch backend on the same payload (sign Grams bit for bit, code Grams
    within code_tolerance). Returns the largest code_corr error."""
    import torch
    from repro_torch.core import estimators, experiments, sampler
    from repro_torch.core.gram import GramEngine
    from repro_torch.core.quantizers import codebook_tensors
    from repro_torch.kernels import quantize_fused, ref

    chols, _, keys = experiments._sparse_plan_setup(
        *experiments._sparse_setup_key(plan), str(torch.device(dev)))
    kernel, plain = GramEngine(backend="kernel"), GramEngine(backend="torch")
    worst = 0.0
    for n in plan.ns:
        x = sampler.sample_ggm_rows_batch(keys, plan.bucket_for(n), chols)
        shape = f"b={plan.reps} n={x.shape[1]} d={plan.d}"
        for s in plan.strategies:
            if s.method == "original":
                continue
            if s.method == "persymbol":
                bounds, _ = codebook_tensors(s.rate, dev)
                expect(torch.equal(quantize_fused(x, s.rate),
                                   ref.encode_ref(x, bounds)),
                       f"{what}: quantize_fused R={s.rate} at {shape}")
            p = estimators.strategy_payload(x, s, n_valid=n)
            got = estimators.payload_gram(p, s, n_valid=n, engine=kernel)
            want = estimators.payload_gram(p, s, n_valid=n, engine=plain)
            if s.method == "sign":
                expect(torch.equal(got, want),
                       f"{what}: sign_corr at {shape}")
                continue
            err = (got - want).abs()
            expect(bool((err <= code_tolerance(x.shape[1], want)).all()),
                   f"{what}: code_corr R={s.rate} at {shape}: max |err| "
                   f"{float(err.max())}")
            worst = max(worst, float(err.max()))
    log(f"phase 13 {what}: at ns={plan.ns} (b={plan.reps}, d={plan.d}) "
        f"quantize_fused and sign_corr equal their plain versions, "
        f"code_corr within code_tolerance (max |err| {worst})")
    return worst


def profiled_copies(fn):
    """:func:`profiled` with the device->host copies split into those
    made inside torch.linalg.eigh (its solver status check), the solver's
    all-done polls (the other scalar reads) and the rest (the read-back)."""
    out, wall, busy, dtoh, prof = _profile(fn)
    eigh = polls = 0
    for e in prof.events():
        if e.name != "aten::_local_scalar_dense":
            continue
        p, inside = e.cpu_parent, False
        while p is not None and not inside:
            inside = "eigh" in p.name
            p = p.cpu_parent
        eigh += inside
        polls += not inside
    return out, wall, busy, {"dtoh": dtoh, "eigh": eigh, "polls": polls,
                             "read_back": dtoh - eigh - polls}


def sparse_sweeps(dev, total):
    """Part 1: the example's sweep at d = 16 three ways (fixed lam, an
    EBIC path, a StARS path): cold and warm seconds, warm trials/s, the
    device->host copies of a warm sweep split by cause, the idle share,
    and card == CPU under the near-threshold rule."""
    import dataclasses

    import torch
    from repro_torch.core.experiments import (TrialPlan, clear_compile_caches,
                                              run_trials)
    from repro_torch.core.path import PathPlan

    fixed = TrialPlan(strategies=_sparse_strategies(
        ("sign", "R2", "R4", "original")), **SPARSE_SWEEP)
    plans = {"fixed": fixed,
             "ebic": dataclasses.replace(fixed, path=PathPlan(**SPARSE_PATH)),
             "stars": dataclasses.replace(fixed, path=PathPlan(
                 select="stars", **SPARSE_PATH))}
    check_sparse_kernels(fixed, dev, "sparse d=16 kernels")
    for name, plan in plans.items():
        clear_compile_caches()
        (card, cold), counts = counted(total, lambda: timed(
            lambda: run_trials(plan, device=dev)))
        warm, _ = counted(total, lambda: run_trials(plan, device=dev))
        (prof, wall, busy, copies), _ = counted(
            total, lambda: profiled_copies(lambda: run_trials(plan,
                                                              device=dev)))
        host, t_cpu = timed(lambda: run_trials(plan, device="cpu"))
        what = f"sparse d=16 {name}"
        expect(card.host_syncs == warm.host_syncs == prof.host_syncs == 1,
               f"{what}: host_syncs {card.host_syncs}")
        expect(copies["read_back"] == 1, f"{what}: device->host copies "
               f"{copies} leave {copies['read_back']} for the read-back")
        expect(name != "fixed" or copies["polls"] == 0,
               f"{what}: the fixed-lam solve polled {copies['polls']} times")
        for res in (warm, prof):
            _same_results(res, card, f"{what} rerun vs cold",
                          fields=METRIC_FIELDS + ("buckets", "path"),
                          comm=False)
        parted = sparse_card_vs_cpu(plan, card, host, dev, f"{what} card "
                                    f"vs CPU")
        log(f"phase 13 {what}: {plan.trials} trials, cold {cold:.4f} s, warm "
            f"{warm.seconds:.4f} s ({warm.trials_per_s:.1f} trials/s); "
            f"profiled wall {wall:.4f} s, device busy {busy:.2f} ms, idle "
            f"{100 * (1 - busy / 1e3 / wall):.1f}%, device->host copies "
            f"{json.dumps(copies)}; result reads {card.host_syncs}; CPU "
            f"{t_cpu:.3f} s; card == CPU"
            f"{' but at the threshold (label, n, entries): ' + json.dumps(parted) if parted else ''}"
            f"; launches={json.dumps(counts)}")
        log(f"phase 13 {what} edge_f1={json.dumps(card.edge_f1)}")
        if card.path is not None:
            log(f"phase 13 {what} iters={json.dumps(card.path['iters'])} "
                f"selected_hist={json.dumps(card.path['selected_hist'])}")
        del card, warm, prof, host
        torch.cuda.empty_cache()


def split_sweep(plan, dev):
    """run_trials(plan) with its sparse stages wrapped, each synchronised
    before and after: (result, seconds by stage) — the sampler, the corr
    stage without it (the Gram kernels), the solve (glasso, support and
    metric sums), and the rest of run_trials' own seconds (the read-back
    and the stacking around it)."""
    from repro_torch.core import experiments, sampler
    from repro_torch.core.experiments import run_trials

    split = dict(sample=0.0, corr=0.0, solve=0.0)
    undo = []

    def wrap(owner, name, key):
        orig = getattr(owner, name)

        def wrapper(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            sync()
            split[key] += time.perf_counter() - t0
            return out

        setattr(owner, name, wrapper)
        undo.append((owner, name, orig))

    wrap(sampler, "sample_ggm_rows_batch", "sample")
    wrap(experiments, "_stacked_corr", "corr")
    wrap(experiments, "_sparse_metric_sums", "solve")
    try:
        res = run_trials(plan, device=dev)
    finally:
        for owner, name, orig in reversed(undo):
            setattr(owner, name, orig)
    split["corr"] -= split["sample"]  # the corr stage calls the sampler
    split["read_back"] = res.seconds - sum(split.values())
    return res, split


def eigh_per_step(dev, b, d, reps):
    """torch.linalg.eigh of a (b, d, d) f32 batch like the solver's: its
    CUDA-event ms and the cuSOLVER kernels the profiler names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(b, d, d, generator=gen, device=dev)
    z = (a + a.transpose(1, 2)) / 2
    ms = event_ms(lambda: torch.linalg.eigh(z), reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.linalg.eigh(z)
        sync()
    names = sorted({e.name for e in prof.events()
                    if "CUDA" in str(getattr(e, "device_type", ""))
                    and "emcpy" not in e.name and "emset" not in e.name})
    return ms, names or ["the profiler recorded no device events"]


def sparse_width(dev, total):
    """Part 2: d = 128 at n = 4096 (sign, R4, original; 8 reps, 300
    steps, fixed lam): the kernels at its shapes, run_trials with its
    stage split, eigh's time a step and its cuSOLVER kernels, peak memory,
    and the timed sweep's card results == the CPU's."""
    import dataclasses

    import torch
    from repro_torch.core.experiments import TrialPlan, run_trials

    plan = TrialPlan(strategies=_sparse_strategies(("sign", "R4",
                                                    "original")),
                     **SPARSE_WIDE)
    check_sparse_kernels(plan, dev, "sparse d=128 kernels")
    torch.cuda.reset_peak_memory_stats()
    (card, split), counts = counted(total, lambda: split_sweep(plan, dev))
    peak = torch.cuda.max_memory_allocated()
    if split["solve"] > SPARSE_SOLVE_LIMIT_S:
        log(f"phase 13 width: the solve took {split['solve']:.1f} s > "
            f"{SPARSE_SOLVE_LIMIT_S} s at reps={plan.reps}: reps cut to "
            f"{SPARSE_WIDE_CUT_REPS}")
        plan = dataclasses.replace(plan, reps=SPARSE_WIDE_CUT_REPS)
        torch.cuda.reset_peak_memory_stats()
        (card, split), more = counted(total, lambda: split_sweep(plan, dev))
        peak = torch.cuda.max_memory_allocated()
        counts = {k: counts[k] + more[k] for k in counts}
    host, t_cpu = timed(lambda: run_trials(plan, device="cpu"))
    parted = sparse_card_vs_cpu(plan, card, host, dev, "sparse d=128 card "
                                "vs CPU")
    b = len(plan.strategies) * plan.reps
    ms, kernels = eigh_per_step(dev, b, plan.d, reps=5)
    steps = plan.glasso_steps * len(plan.ns)
    log(f"phase 13 width d={plan.d} n={plan.ns} reps={plan.reps} "
        f"({plan.trials} trials): run_trials {card.seconds:.3f} s "
        f"({card.trials_per_s:.2f} trials/s); stage split, s (each stage "
        f"synchronised): " + " ".join(f"{k}={v:.4f}" for k, v in
                                      split.items())
        + f"; eigh of ({b}, {plan.d}, {plan.d}) f32 {ms:.4f} ms a step "
        f"({steps} steps: {ms * steps / 1e3:.2f} s), cuSOLVER kernels "
        f"{json.dumps(kernels)}; peak_bytes={peak}; card == CPU (CPU "
        f"{t_cpu:.2f} s)"
        f"{' but at the threshold (label, n, entries): ' + json.dumps(parted) if parted else ''}"
        f"; launches={json.dumps(counts)}")
    log(f"phase 13 width edge_f1={json.dumps(card.edge_f1)} precision="
        f"{json.dumps(card.precision)} recall={json.dumps(card.recall)}")
    # the fixed-lam d = 16 sweep's solve: 3 points x 4 strategies x 32 reps
    lanes = len(SPARSE_SWEEP["ns"]) * 4 * SPARSE_SWEEP["reps"]
    ms16, kernels16 = eigh_per_step(dev, lanes, SPARSE_SWEEP["d"], reps=20)
    log(f"phase 13 eigh of ({lanes}, 16, 16) f32 {ms16:.4f} ms a step, "
        f"cuSOLVER kernels {json.dumps(kernels16)}")
    # torch's dispatch: how eigh's time scales with the batch and where
    # it leaves the batched tridiagonal solver (sytrd + stedc)
    scaling = {}
    for b, d in EIGH_SHAPES:
        ms, names = eigh_per_step(dev, b, d, reps=5)
        family = ("sytrd+stedc" if any("stedc" in k for k in names) else
                  "Jacobi" if any("rotate" in k for k in names) else "other")
        scaling[f"({b}, {d}, {d})"] = (round(ms, 4), family)
    log(f"phase 13 eigh ms a call and cuSOLVER family by shape: "
        f"{json.dumps(scaling)}")


def sparse_faults(dev, total):
    """Part 3: tests/test_faults.py's sparse plan on the card and the CPU
    (fault telemetry bit-identical, metrics by the near-threshold rule),
    and a zero-fault plan at d = 16 bit-identical to none on the card."""
    import dataclasses

    import torch
    from repro_torch.core import experiments
    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan, fault_trial_keys
    from repro_torch.core.gram import GramEngine

    plan = TrialPlan(strategies=(dataclasses.replace(
        _sparse_strategies(("sign",))[0], lam=0.1),),
        faults=FaultPlan(**SPARSE_FAULT_PLAN), **SPARSE_FAULTS)
    card, counts = counted(total, lambda: run_trials(plan, device=dev))
    host = run_trials(plan, device="cpu")
    expect(card.faults == host.faults and card.faults is not None,
           f"sparse faults: telemetry card {card.faults} vs CPU "
           f"{host.faults}")
    parted = sparse_card_vs_cpu(plan, card, host, dev, "sparse faults card "
                                "vs CPU")
    none = TrialPlan(strategies=_sparse_strategies(
        ("sign", "R2", "R4", "original")), **SPARSE_SWEEP)
    zero = dataclasses.replace(none, faults=FaultPlan(machines=4, retries=1))
    n = none.ns[0]
    chols, _, keys = experiments._sparse_plan_setup(
        *experiments._sparse_setup_key(none), str(torch.device(dev)))
    engine = GramEngine()
    c = experiments._stacked_corr(keys, chols, n, none.strategies,
                                  none.bucket_for(n), engine)
    cz, tele = experiments._stacked_corr(
        keys, chols, n, none.strategies, none.bucket_for(n), engine,
        zero.faults, fault_trial_keys(zero.faults, none.reps, device=dev))
    expect(torch.equal(c, cz) and not bool(tele.any()),
           "the zero-fault sparse statistics differ from no plan's")
    a, _ = counted(total, lambda: run_trials(none, device=dev))
    b, _ = counted(total, lambda: run_trials(zero, device=dev))
    _same_results(b, a, "sparse zero-fault vs no faults",
                  fields=METRIC_FIELDS + ("buckets", "host_syncs"),
                  comm=False)
    log(f"phase 13 sparse faults (d={plan.d}, reps={plan.reps}, "
        f"{json.dumps(SPARSE_FAULT_PLAN)}): card == CPU in TrialResult."
        f"faults ({json.dumps(card.faults)}) and metrics"
        f"{' but at the threshold: ' + json.dumps(parted) if parted else ''}"
        f"; zero-fault == no faults bit for bit at d=16 (statistics and "
        f"results); launches={json.dumps(counts)}")


def sparse_plane(dev, total):
    """Phase 13: the sparse plane on the card, parts 1-3 above."""
    t0 = time.perf_counter()
    for part in (sparse_sweeps, sparse_width, sparse_faults):
        t = time.perf_counter()
        part(dev, total)
        log(f"phase 13 {part.__name__} took {time.perf_counter() - t:.1f} s")
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: the channel plane
# ---------------------------------------------------------------------------

#: benchmarks/channels.py, uncut: d = 16 over 4 machines, three ns, 32 reps,
#: seed0 = 7, B = 6 * 512 * 16 at cap 4, pristine and its faulty scenario
CHANNELS = dict(d=16, ns=(128, 512, 2048), reps=32, seed0=7)
CHANNEL_MACHINES, CHANNEL_CAP = 4, 4
CHANNEL_BUDGET = 6 * 512 * 16
CHANNEL_FAULTS = dict(dropout=0.15, straggle=0.3, straggle_frac=0.5,
                      machines=4, seed=1)
#: benchmarks/bigd.py's width over 16 machines; B = 24 * 8192 * 64 gives
#: every machine the cap at n = 2048 and (2 x 8, 1 x 8) at n = 8192
CHANNEL_WIDE = dict(d=1024, ns=(2048, 8192), reps=32)
WIDE_MACHINES = 16
WIDE_BUDGET = 24 * 8192 * 64
WIDE_RATES = {2048: (4,) * 16, 8192: (2,) * 8 + (1,) * 8}
#: the width's card-vs-CPU cut (TRIALS_FAULTS_CUT's): B = 24 * 1024 * 4
WIDE_CUT = dict(d=64, ns=(1024,), reps=8, seed0=7)
WIDE_CUT_BUDGET = 24 * 1024 * 4
#: (b, n, d, n_valid) of the kernels' checks at the phase's own shapes
CHANNEL_KERNEL_SHAPE = (32, 8192, 1024, 8000)
#: learn_structure at full width: sign@mac8 at PRODUCTION, and a budget
#: over 16 machines at n = 2^18 whose B gives (2 x 8, 1 x 8)
MAIN_MAC_MACHINES = 8
MAIN_BUDGET_MACHINES = 16
MAIN_BUDGET = 24 * CUT_N * (D // MAIN_BUDGET_MACHINES)
MAIN_BUDGET_RATES = (2,) * 8 + (1,) * 8


def _channel_strategies(machines, budget):
    """(sign, R4, sign over a MAC of ``machines``, R4 capped under a
    budget of ``budget`` bits over ``machines``)."""
    from repro_torch.core import BudgetChannel, MACChannel, Strategy

    return (Strategy("sign"), Strategy("persymbol", rate=CHANNEL_CAP),
            Strategy("sign", channel=MACChannel(machines)),
            Strategy("persymbol", rate=CHANNEL_CAP, channel=BudgetChannel(
                budget_bits=budget, machines=machines)))


def check_channel_kernels(dev, reps):
    """The two kernels of the channel plane against their plain versions
    at its shapes (b = 32 trials, n = 8192, d = 1024): ``sign_corr`` on
    MAC-masked codes (an interior block dropped whole, one truncated off
    the 128-sample stage, stragglers' prefixes, the padded tail), and
    ``quantize_fused`` at R = 1..4, the budget encode's four launches.
    Returns {kernel: channel record}."""
    import torch
    from repro_torch.core import MACChannel, Strategy, estimators, sampler
    from repro_torch.core.experiments import (TrialPlan, stacked_trees,
                                              trial_keys)
    from repro_torch.core.faults import FaultPlan, fault_trial_keys
    from repro_torch.core.quantizers import codebook_tensors
    from repro_torch.kernels import quantize_fused, ref, sign_corr

    b, n, d, n_valid = CHANNEL_KERNEL_SHAPE
    shape = f"b={b} n={n} d={d}"
    plan = TrialPlan(d=d, ns=(n,), reps=b)
    parents, rhos, _ = stacked_trees(plan, device=dev)
    x = sampler.sample_tree_ggm_rows_batch(trial_keys(plan, device=dev), n,
                                           parents, rhos)
    s = Strategy("sign", channel=MACChannel(WIDE_MACHINES))
    fp = FaultPlan(**MIXED_FAULTS)
    fkeys = fault_trial_keys(fp, b, device=dev)
    _, flip, _ = fp.draw_batch(fkeys, n, n_valid, d)
    delivered = fp.draw_rowblock_batch(fkeys, n, n_valid, WIDE_MACHINES)
    delivered[:, 3] = 0
    delivered[:, 5] = delivered[:, 5].clamp(max=200)
    rows = n // WIDE_MACHINES
    u = estimators.mac_sign_codes(x, s, delivered=delivered, flip=flip)
    expect(not bool(u[:, 3 * rows:4 * rows].any())
           and not bool(u[:, 5 * rows + 200:6 * rows].any())
           and not bool(u[:, n_valid:].any()),
           "the MAC mask left undelivered rows in the codes")
    expect(torch.equal(sign_corr(u), ref.sign_corr_ref(u)),
           f"sign_corr on MAC-masked codes at {shape}")
    lossless = estimators.mac_sign_codes(x, s, n_valid=n_valid)
    expect(torch.equal(sign_corr(lossless), ref.sign_corr_ref(lossless)),
           f"sign_corr on lossless MAC codes at {shape}")
    del lossless
    for rate in range(1, CHANNEL_CAP + 1):
        bounds, _ = codebook_tensors(rate, dev)
        expect(torch.equal(quantize_fused(x, rate), ref.encode_ref(x, bounds)),
               f"quantize_fused R={rate} at {shape}")
    log(f"phase 14 kernels at {shape}: sign_corr on MAC-masked codes "
        f"(block 3 dropped, block 5 cut at row 200, faults' prefixes, tail "
        f"from n_valid={n_valid}) and lossless ones, quantize_fused R=1.."
        f"{CHANNEL_CAP} equal their plain versions")

    out = {}
    uf = u.to(torch.float32)
    ut = uf.transpose(1, 2).contiguous()
    ops = 2 * b * n * d * d
    rec = make_record("phase 14 channel", "sign_corr", "", "", shape + " MAC",
                      event_ms(lambda: sign_corr(u), reps),
                      event_ms(lambda: ref.sign_corr_ref(u), reps),
                      event_ms(lambda: torch.bmm(ut, uf), reps),
                      u.numel() + b * d * d * 4, ops, INT8_TENSOR_OPS_PER_S,
                      0.0)
    out["sign_corr"] = rec
    del u, uf, ut
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    for rate in range(1, CHANNEL_CAP + 1):
        bounds, _ = codebook_tensors(rate, dev)
        times["ms"].append(event_ms(lambda: quantize_fused(x, rate), reps))
        times["plain_ms"].append(event_ms(lambda: ref.encode_ref(x, bounds),
                                          reps))
        times["library_ms"].append(event_ms(
            lambda: torch.bucketize(x, bounds), reps))
    log("phase 14 quantize_fused R=1..4 at " + shape + ", ms a launch: "
        + json.dumps(times))
    levels = sum((1 << r) - 1 + (1 << r) for r in range(1, CHANNEL_CAP + 1))
    out["quantize_fused"] = make_record(
        "phase 14 channel", "quantize_fused", "", "",
        shape + f" R=1..{CHANNEL_CAP} (the budget encode's launches)",
        sum(times["ms"]), sum(times["plain_ms"]), sum(times["library_ms"]),
        CHANNEL_CAP * x.numel() * 5 + levels * 4,
        sum(range(1, CHANNEL_CAP + 1)) * x.numel(), F32_OPS_PER_S, 0.0)
    del x
    torch.cuda.empty_cache()
    return {k: {f: r[f] for f in ("shape", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}
            for k, r in out.items()}


def channel_bench(dev, total):
    """Part (a): benchmarks/channels.py's plan, uncut, its legacy
    (gather-only), pristine and faulty sweeps on the card and the CPU, and
    the bench's five checks."""
    import dataclasses

    from repro_torch.core.experiments import TrialPlan, clear_compile_caches
    from repro_torch.core.faults import FaultPlan

    strategies = _channel_strategies(CHANNEL_MACHINES, CHANNEL_BUDGET)
    pristine = TrialPlan(strategies=strategies, **CHANNELS)
    plans = {"legacy": dataclasses.replace(pristine,
                                           strategies=strategies[:1]),
             "pristine": pristine,
             "faulty": dataclasses.replace(
                 pristine, faults=FaultPlan(**CHANNEL_FAULTS))}
    res = {}
    for name, plan in plans.items():
        clear_compile_caches()
        res[name] = sweep_card_and_cpu(plan, dev, total,
                                       f"phase 14 channels d=16 {name}")
    mac, bgt = strategies[2].label, strategies[3].label
    metrics = ("error_rate", "edit_distance", "edge_f1")
    checks = {
        "gather_bit_identical_to_legacy": all(
            getattr(res["pristine"], f)["sign"]
            == getattr(res["legacy"], f)["sign"] for f in metrics),
        # one host read and one device->host copy: sweep_card_and_cpu
        "mac_one_sync": all(r.host_syncs == 1 for r in res.values()),
        "budget_bits_leq_B": all(
            sum(c.machine_bits) == c.logical_bits <= CHANNEL_BUDGET
            for r in (res["pristine"], res["faulty"]) for c in r.comm[bgt]),
        "mac_lossless_matches_gather": all(
            getattr(res["pristine"], f)[mac]
            == getattr(res["pristine"], f)["sign"] for f in metrics),
        "faulty_finite": all(v == v for vs in res["faulty"].error_rate.values()
                             for v in vs),
    }
    expect(all(checks.values()), f"benchmarks/channels.py checks {checks}")
    ledgers = {lab: [(c.rates, c.machine_bits) for c in res["pristine"].comm[
        lab]] for lab in (mac, bgt)}
    log(f"phase 14 channels d=16 checks {json.dumps(checks)}; ledgers "
        f"(rates, machine_bits) {json.dumps(ledgers)}; faults "
        f"{json.dumps(res['faulty'].faults)}")


def _budget_vs_r4(plan, dev, engine):
    """The d = 1024 plan's first point, where every machine has the cap:
    the budget's Gram (decoded f32 values, an f32 product) within
    code_tolerance of R4's (code_corr), and every trial whose two trees
    differ a tie. Returns (max |Gram difference|, ties)."""
    import torch
    from repro_torch.core import estimators, experiments, sampler
    from repro_torch.core.chow_liu import boruvka_mst_batch

    n = plan.ns[0]
    n_pad = plan.bucket_for(n)
    r4, bgt = plan.strategies[1], plan.strategies[3]
    parents, rhos, adj, keys = experiments._plan_setup(
        *experiments._setup_key(plan), str(torch.device(dev)))
    x = sampler.sample_tree_ggm_rows_batch(keys, n_pad, parents, rhos)
    rates = experiments._rates_operand((bgt,), n, plan.d, dev)[0]
    expect(bool((rates == r4.rate).all()), f"the budget at n={n} does not "
           f"give every machine the cap")
    g_r4 = estimators.payload_gram(estimators.strategy_payload(
        x, r4, n_valid=n), r4, n_valid=n, engine=engine)
    g_bgt = engine.gram_batch(estimators.budget_operand(
        estimators.budget_payload(x, bgt, rates, n_valid=n), bgt, rates))
    del x
    err = (g_bgt - g_r4).abs()
    expect(bool((err <= code_tolerance(n, g_r4)).all()),
           f"budget vs R4 Grams at n={n}: max |difference| "
           f"{float(err.max())}")
    max_err = float(err.max())
    del g_r4, g_bgt, err
    w = experiments._stacked_weights(
        keys, parents, rhos, n, (r4, bgt), n_pad, engine,
        rates=experiments._rates_operand((r4, bgt), n, plan.d, dev))
    t = boruvka_mst_batch(w.flatten(0, 1), early_exit=False).view(w.shape)
    ham = ((t != adj[None]).sum(dim=(2, 3)) // 2).cpu().numpy()
    ties = trace_ties(w[1].double().cpu(), t[1].cpu(), w[0].double().cpu(),
                      t[0].cpu(), plan.d, f"budget vs R4 at n={n}",
                      (bgt.label, n))
    return max_err, ham, ties


def _channel_split(plan, dev):
    """run_trials' device path on a pristine channel plan stage by stage,
    each stage synchronised: (S, len(ns), 3) mean metrics and seconds by
    stage (the Gram of every strategy under "gram", the estimate tails
    under "estimate")."""
    import numpy as np
    import torch
    from repro_torch.core import estimators as E
    from repro_torch.core import experiments, sampler
    from repro_torch.core.gram import GramEngine

    parents, rhos, adj_true, keys = experiments._plan_setup(
        *experiments._setup_key(plan), str(torch.device(dev)))
    engine = plan.budget_engine(GramEngine(), device=dev)
    chunk = plan.metrics_chunk()
    split = dict.fromkeys(("sample", "gather_encode", "mac_encode_mask",
                           "budget_encode", "budget_decode", "gram",
                           "estimate", "boruvka", "read_back"), 0.0)

    def stage(key, fn):
        out, t = timed(fn)
        split[key] += t
        return out

    sums = []
    for n in plan.ns:
        n_pad = plan.bucket_for(n)
        x = stage("sample", lambda: sampler.sample_tree_ggm_rows_batch(
            keys, n_pad, parents, rhos))
        rates = experiments._rates_operand(plan.strategies, n, plan.d, dev)
        w = []
        for i, s in enumerate(plan.strategies):
            if s.channel.kind == "mac":
                u = stage("mac_encode_mask",
                          lambda: E.mac_sign_codes(x, s, n_valid=n))
                g = stage("gram", lambda: engine.gram_batch(u))
                del u
                w.append(stage("estimate", lambda: E.mac_estimate(
                    g, s, E.mac_effective_count(s, n_pad, n_valid=n,
                                                device=dev))))
            elif s.channel.kind == "budget":
                r = rates[i]
                c = stage("budget_encode",
                          lambda: E.budget_payload(x, s, r, n_valid=n))
                v = stage("budget_decode", lambda: E.budget_operand(c, s, r))
                del c
                g = stage("gram", lambda: engine.gram_batch(v))
                del v
                w.append(stage("estimate", lambda: E.weights_from_gram(
                    g, E.budget_counts(r, n_pad, n_valid=n, device=dev), s)))
            else:
                p = stage("gather_encode",
                          lambda: E.strategy_payload(x, s, n_valid=n))
                g = stage("gram", lambda: E.payload_gram(
                    p, s, n_valid=n, engine=engine))
                del p
                w.append(stage("estimate", lambda: E.weights_from_gram(
                    g, torch.as_tensor(n, dtype=torch.float32,
                                       device=g.device), s)))
            del g
        del x
        sums.append(stage("boruvka", lambda: experiments._metric_sums(
            torch.stack(w), adj_true, chunk)))
        del w
    m = stage("read_back", lambda: torch.stack(sums, dim=1).cpu())
    return m.numpy() / np.float32(plan.reps), split


def channel_width(dev, total):
    """Part (b): the channel strategies at d = 1024 over 16 machines,
    pristine and under MIXED_FAULTS: cold and warm seconds, trials/s, the
    idle share, peak memory and a stage split; lossless MAC == gather
    sign and a zero-fault plan == none, bit for bit; the logged
    allocation; the budget at full rate against R4; and card == CPU at
    the d = 64 cut."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import experiments
    from repro_torch.core.experiments import (TrialPlan, clear_compile_caches,
                                              run_trials)
    from repro_torch.core.faults import FaultPlan, fault_trial_keys
    from repro_torch.core.gram import GramEngine

    strategies = _channel_strategies(WIDE_MACHINES, WIDE_BUDGET)
    sign, r4, mac, bgt = (s.label for s in strategies)
    pristine = TrialPlan(strategies=strategies, **CHANNEL_WIDE)
    plans = {"pristine": pristine, "mixed": dataclasses.replace(
        pristine, faults=FaultPlan(**MIXED_FAULTS))}
    trials = sum(p.trials for p in plans.values())
    clear_compile_caches()
    torch.cuda.empty_cache()
    cold, launches = {}, {}
    for name, plan in plans.items():
        (res, t), counts = counted(total, lambda: timed(
            lambda: run_trials(plan, device=dev)))
        cold[name] = (res, t)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for k in ("sign_corr", "code_corr", "quantize_fused"):
        expect(launches[k] > 0, f"the d=1024 channel sweeps launched no {k}")
    torch.cuda.reset_peak_memory_stats()
    warm = {name: counted(total, lambda: run_trials(plan, device=dev))[0]
            for name, plan in plans.items()}
    peak = torch.cuda.max_memory_allocated()
    wall = busy = 0.0
    for name, plan in plans.items():
        (p, t, b, dtoh), _ = counted(
            total, lambda: profiled(lambda: run_trials(plan, device=dev)))
        wall, busy = wall + t, busy + b
        expect(dtoh == 1, f"a warm d=1024 {name} channel sweep made {dtoh} "
               f"device->host copies")
        expect(cold[name][0].host_syncs == 1, "a d=1024 channel sweep read "
               "the host twice")
        _same_results(warm[name], cold[name][0], f"d=1024 {name} warm vs cold")
        _same_results(p, cold[name][0], f"d=1024 {name} profiled vs cold")
    res = cold["pristine"][0]
    for f in ("error_rate", "edit_distance", "edge_f1"):
        expect(getattr(res, f)[mac] == getattr(res, f)[sign],
               f"lossless MAC {f} differs from gather sign's at d=1024")
    for n, c in zip(pristine.ns, res.comm[bgt]):
        expect(c.rates == WIDE_RATES[n], f"the budget's allocation at n={n} "
               f"is {c.rates}, not {WIDE_RATES[n]}")
        expect(sum(c.machine_bits) == c.logical_bits <= WIDE_BUDGET,
               f"the budget's ledger at n={n}: {c}")
    cold_s = sum(t for _, t in cold.values())
    warm_s = sum(w.seconds for w in warm.values())
    log(f"phase 14 channels d={pristine.d} ({trials} trials: "
        f"{len(strategies)} strategies, ns={pristine.ns}, reps={pristine.reps}, pristine + "
        f"mixed faults): cold {cold_s:.3f} s ({trials / cold_s:.1f} "
        f"trials/s, setup included), warm {warm_s:.3f} s "
        f"({trials / warm_s:.1f} trials/s); profiled warm wall {wall:.3f} s,"
        f" device busy {busy:.1f} ms, idle "
        f"{100 * (1 - busy / 1e3 / wall):.1f}%; peak_bytes={peak}; "
        f"tiling={json.dumps(res.tiling)} launches={json.dumps(launches)}")
    for name, (r, _) in cold.items():
        log(f"phase 14 d={pristine.d} {name} error_rate="
            f"{json.dumps(r.error_rate)} "
            f"edit_distance={json.dumps(r.edit_distance)}"
            + (f" faults={json.dumps(r.faults)}" if r.faults else ""))
    log(f"phase 14 d={pristine.d} budget ledgers (rates, machine_bits): "
        f"{json.dumps([(c.rates, c.machine_bits) for c in res.comm[bgt]])}")

    # weights: lossless MAC == gather sign; a zero-fault plan == none
    n = pristine.ns[-1]
    n_pad = pristine.bucket_for(n)
    parents, rhos, _, keys = experiments._plan_setup(
        *experiments._setup_key(pristine), str(torch.device(dev)))
    engine = pristine.budget_engine(GramEngine(), device=dev)
    rates = experiments._rates_operand(strategies, n, pristine.d, dev)
    w = experiments._stacked_weights(keys, parents, rhos, n, strategies,
                                     n_pad, engine, rates=rates)
    expect(torch.equal(w[2], w[0]), "lossless MAC weights differ from "
           "gather sign's at d=1024")
    zero = FaultPlan(machines=WIDE_MACHINES, retries=1)
    wz, tele = experiments._stacked_weights(
        keys, parents, rhos, n, strategies, n_pad, engine, zero,
        fault_trial_keys(zero, pristine.reps, device=dev), rates)
    expect(torch.equal(wz, w) and not bool(tele.any()),
           "the zero-fault plan's channel weights differ from no plan's")
    del w, wz
    zero_r, _ = counted(total, lambda: run_trials(
        dataclasses.replace(pristine, faults=zero), device=dev))
    _same_results(zero_r, res, "zero-fault vs no faults at d=1024",
                  fields=("error_rate", "edit_distance", "edge_f1",
                          "buckets", "host_syncs"), comm=False)
    err, ham, ties = _budget_vs_r4(pristine, dev, engine)
    for k, lab in ((0, r4), (1, bgt)):
        expect(res.edit_distance[lab][0] == float(
            np.float32(ham[k].sum()) / np.float32(pristine.reps)),
            f"recomputed {lab} trees at n={pristine.ns[0]} do not give the "
            f"sweep's edit distance")
    log(f"phase 14 d={pristine.d} lossless MAC == gather sign and "
        f"zero-fault == no faults bit for bit (weights and results); budget at n="
        f"{pristine.ns[0]} (every machine at R={CHANNEL_CAP}) vs R4: max "
        f"|Gram difference| {err} (code_tolerance), metrics "
        + ("equal" if not ties else "equal but for ties (label, n, trial, "
           "gap, max |dw|): " + json.dumps(ties)))

    (m, split), _ = counted(total, lambda: _channel_split(pristine, dev))
    for i, s in enumerate(strategies):
        expect(list(map(float, m[i, :, 0])) == res.error_rate[s.label]
               and list(map(float, m[i, :, 1])) == res.edit_distance[s.label],
               f"the staged d=1024 channel sweep disagrees with run_trials "
               f"({s.label})")
    log(f"phase 14 d={pristine.d} pristine stage split, s (each stage "
        "synchronised): " + " ".join(f"{k}={v:.4f}" for k, v in split.items()))

    cut = TrialPlan(strategies=_channel_strategies(WIDE_MACHINES,
                                                   WIDE_CUT_BUDGET),
                    faults=FaultPlan(**MIXED_FAULTS), **WIDE_CUT)
    card, _ = counted(total, lambda: run_trials(cut, device=dev))
    host = run_trials(cut, device="cpu")
    bgt_cut = cut.strategies[3].label
    cut_ties = card_vs_cpu_sweep(cut, card, host, dev,
                                 "the d=64 channel cut card vs CPU")
    log(f"phase 14 channels cut (d={cut.d}, reps={cut.reps}, ns={cut.ns}, "
        f"{WIDE_MACHINES} machines, B={WIDE_CUT_BUDGET}): card == CPU in "
        f"TrialResult.faults and CommReports, and in metrics"
        f"{' but for ties: ' + json.dumps(cut_ties) if cut_ties else ''}; "
        f"rates={json.dumps([c.rates for c in card.comm[bgt_cut]])}"
        f" faults={json.dumps(card.faults)}")


def channel_main_path(dev, total, main_edges):
    """Part (d): learn_structure at full width over the channels:
    sign@mac8 at PRODUCTION gives phase 4's gather sign edges exactly,
    and a budget over 16 machines at d = 4096, n = 2^18 with its
    allocation, edit distance, time, peak memory and stage split."""
    import torch
    from repro_torch.configs import PRODUCTION
    from repro_torch.core import BudgetChannel, MACChannel, Strategy
    from repro_torch.core import estimators as E
    from repro_torch.core.chow_liu import (adjacency_to_edges, boruvka_mst,
                                           learn_structure)
    from repro_torch.core.gram import GramEngine
    from repro_torch.core.trees import is_tree, tree_edit_distance
    from repro_torch.data import GGMDataset

    ds = GGMDataset(d=D, seed=PRODUCTION.seed)
    truth, _ = ds.structure()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x = ds.sample(MAIN_N, device=dev)
    s = Strategy(method=PRODUCTION.method,
                 channel=MACChannel(MAIN_MAC_MACHINES))
    (est, t_mac), counts = counted(total, lambda: timed(
        lambda: learn_structure(x, strategy=s)))
    del x
    peak = torch.cuda.max_memory_allocated()
    expect(counts["sign_corr"] > 0, f"{s.label} at PRODUCTION launched no "
           f"sign_corr")
    expect(est == main_edges, f"{s.label} at PRODUCTION: the edge list is "
           f"not phase 4's gather sign edge list")
    log(f"phase 14 PRODUCTION d={D} n={MAIN_N} {s.label}: learn_structure_s="
        f"{t_mac:.4f} edges == phase 4's gather sign edges; edit_distance="
        f"{tree_edit_distance(est, truth)} peak_bytes={peak} "
        f"launches={json.dumps(counts)}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x = ds.sample(CUT_N, batch_seed=1, device=dev)
    sb = Strategy("persymbol", rate=CHANNEL_CAP, channel=BudgetChannel(
        budget_bits=MAIN_BUDGET, machines=MAIN_BUDGET_MACHINES))
    expect(sb.channel.allocate(CUT_N, D, sb.rate) == MAIN_BUDGET_RATES,
           f"the budget's allocation at d={D} n={CUT_N} is "
           f"{sb.channel.allocate(CUT_N, D, sb.rate)}")
    (est, t_bgt), counts = counted(total, lambda: timed(
        lambda: learn_structure(x, strategy=sb)))
    peak = torch.cuda.max_memory_allocated()
    expect(counts["quantize_fused"] == sb.rate, f"{sb.label} launched "
           f"quantize_fused {counts['quantize_fused']} times, not {sb.rate}")
    expect(is_tree(D, est), f"{sb.label}: not a spanning tree")
    # the same run stage by stage
    rates = sb.channel.column_rates(CUT_N, D, sb.rate)
    codes, t_enc = timed(lambda: E.budget_payload(x, sb, rates))
    del x
    vals, t_dec = timed(lambda: E.budget_operand(codes, sb, rates))
    del codes
    gram, t_gram = timed(lambda: GramEngine().gram(vals))
    del vals
    w, t_w = timed(lambda: E.weights_from_gram(
        gram, E.budget_counts(rates, CUT_N, device=dev), sb))
    adj, t_mst = timed(lambda: boruvka_mst(w))
    expect(adjacency_to_edges(adj) == est,
           f"the staged {sb.label} run disagrees with learn_structure")
    del gram, w, adj
    log(f"phase 14 d={D} n={CUT_N} {sb.label} over "
        f"{MAIN_BUDGET_MACHINES} machines, rates {MAIN_BUDGET_RATES}: "
        f"learn_structure_s={t_bgt:.4f} encode_s={t_enc:.4f} "
        f"decode_s={t_dec:.4f} gram_s={t_gram:.4f} weights_s={t_w:.4f} "
        f"mwst_s={t_mst:.4f} edit_distance={tree_edit_distance(est, truth)} "
        f"peak_bytes={peak} launches={json.dumps(counts)}")
    torch.cuda.empty_cache()


def channel_plane(dev, total, records, main_edges, reps):
    """Phase 14: the channel plane on the card: its two kernels at its
    shapes, then parts (a), (b) and (d) above. Adds each kernel's channel
    record to ``records`` and the phase's launches to ``total``."""
    t0 = time.perf_counter()
    kernels = check_channel_kernels(dev, reps)
    for r in records:
        if r["name"] in kernels:
            r["channel"] = kernels[r["name"]]
    mine = {k: 0 for k in total}
    for part in (channel_bench, channel_width):
        t = time.perf_counter()
        part(dev, mine)
        log(f"phase 14 {part.__name__} took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    channel_main_path(dev, mine, main_edges)
    log(f"phase 14 channel_main_path took {time.perf_counter() - t:.1f} s")
    for k in ("sign_corr", "code_corr", "quantize_fused"):
        expect(mine[k] > 0, f"phase 14 launched no {k}")
    for k, v in mine.items():
        total[k] += v
    log(f"phase 14 launches={json.dumps(mine)}; took "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 15: the mesh and wire plane
# ---------------------------------------------------------------------------

#: part (c): ranks on the one card, joined by gloo, which moves CUDA
#: tensors through the host (its transport); the kernels run on the card
WIRE_RANKS = 4
WIRE_BACKEND = "cuda:gloo,cpu:gloo"
#: tests/test_channels.py's _PARITY plan, and Fig. 3's strategies under
#: the rowblock placement at d = 64
WIRE_PARITY = dict(d=16, ns=(100, 400), reps=8, seed0=5)
WIRE_PARITY_FAULTS = dict(machines=4, dropout=0.25, straggle=0.3, seed=11)
WIRE_ROWBLOCK = dict(d=64, ns=(100, 400), reps=8)


def _wire_plans():
    """Part (c)'s plans: _PARITY pristine and faulty, Fig. 3 rowblock."""
    import dataclasses

    from repro_torch.core import (FIG3_STRATEGIES, BudgetChannel, FaultPlan,
                                  MACChannel, Strategy, TrialPlan)

    parity = TrialPlan(strategies=(
        Strategy("sign"), Strategy("sign", channel=MACChannel(4)),
        Strategy("persymbol", rate=4, channel=BudgetChannel(
            budget_bits=4 * 100 * 16, machines=4))), **WIRE_PARITY)
    return {"parity": parity,
            "parity-faults": dataclasses.replace(
                parity, ns=(100,), faults=FaultPlan(**WIRE_PARITY_FAULTS)),
            "fig3-rowblock": TrialPlan(strategies=tuple(
                dataclasses.replace(s, placement="rowblock")
                for s in FIG3_STRATEGIES), **WIRE_ROWBLOCK)}


def _same_as_mesh_less(got, alone, what, ranks, wire_plan=None):
    """A mesh sweep against the mesh-less one on the same device: every
    result field bit for bit, and the reports but for the collectives,
    which a wire mesh (``wire_plan``, the sweep's plan) counts: 2 under
    rowblock, else 1."""
    import dataclasses

    _same_results(got, alone, what, fields=TRIAL_FIELDS + (
        "precision", "recall", "path"), comm=False)
    expect(got.mesh_devices == ranks and got.host_syncs == 1,
           f"{what}: mesh_devices {got.mesh_devices}, host_syncs "
           f"{got.host_syncs}")
    for s in (wire_plan or alone.plan).strategies:
        want = 0 if wire_plan is None else 1 + (s.placement == "rowblock")
        for r, a in zip(got.comm[s.label], alone.comm[s.label]):
            expect(dataclasses.replace(r, collectives=0) == a,
                   f"{what}: {s.label}'s report {r} is not {a}")
            expect(r.collectives == want, f"{what}: {s.label} reports "
                   f"{r.collectives} collectives, not {want}")


def _first_collectives(mesh, dev):
    """One small all-gather over the model axis and sum over the data axis:
    NCCL's first-call set-up, timed apart from the runs."""
    import torch
    from repro_torch.comm.collectives import all_gather, psum

    t = torch.ones(8, device=dev)
    all_gather(t, mesh.get_group("model"), 0)
    psum(t, mesh.get_group("data"))
    return mesh


def wire_main_path(dev, total, main_edges):
    """Part (a): PRODUCTION over a one-rank NCCL mesh (make_host_mesh(1, 1):
    NCCL on an in-memory store, no launcher). distributed_learn_structure
    gives phase 4's edges; distributed_weights equals strategy_weights bit
    for bit, replicated and rowblock (the rectangular sign_corr); at the
    cut n the packed sign wire is equal too and R = 4's Grams within
    code_tolerance (its trees through trace_ties). Logs the NCCL set-up,
    wall seconds, peak bytes and the wire's own ms (the all-gather of the
    payload) beside learn_structure's."""
    import torch
    from repro_torch.configs import PRODUCTION
    from repro_torch.core import estimators as E
    from repro_torch.core.chow_liu import (adjacency_to_edges, boruvka_mst,
                                           learn_structure)
    from repro_torch.core.distributed import (WirePlan,
                                              distributed_learn_structure,
                                              distributed_weights)
    from repro_torch.core.strategy import Strategy
    from repro_torch.data import GGMDataset
    from repro_torch.launch.mesh import make_host_mesh

    mesh, t_setup = timed(lambda: _first_collectives(
        make_host_mesh(1, 1, device=dev), dev))
    log(f"phase 15 (a) NCCL one-rank mesh set-up (process group on an "
        f"in-memory store, the DeviceMesh, a first all-gather and sum): "
        f"{t_setup:.4f} s")
    ds = GGMDataset(d=D, seed=PRODUCTION.seed)
    torch.cuda.empty_cache()
    x = ds.sample(MAIN_N, device=dev)
    s = Strategy(method=PRODUCTION.method)
    torch.cuda.reset_peak_memory_stats()
    (est, t_dist), counts = counted(total, lambda: timed(
        lambda: distributed_learn_structure(x, mesh, strategy=s)))
    peak = torch.cuda.max_memory_allocated()
    expect(counts["sign_corr"] > 0, "the one-rank PRODUCTION run launched "
           "no sign_corr")
    expect(est == main_edges, "distributed_learn_structure at PRODUCTION: "
           "the edge list is not phase 4's")
    _, t_single = timed(lambda: learn_structure(x, strategy=s))
    plan = WirePlan(s, mesh=mesh)
    payload = plan.encode(x)
    wire_ms = event_ms(lambda: plan.wire(payload), 3)
    del payload
    same = []
    for placement in ("replicated", "rowblock"):
        sp = Strategy(method=PRODUCTION.method, placement=placement)
        got, counts_p = counted(total, lambda: distributed_weights(
            x, mesh, strategy=sp))
        expect(counts_p["sign_corr"] > 0, f"{placement}: no sign_corr")
        expect(torch.equal(got, E.strategy_weights(x, sp)),
               f"distributed_weights ({placement}) at PRODUCTION differs "
               f"from strategy_weights")
        if placement == "rowblock":
            expect(adjacency_to_edges(boruvka_mst(got)) == main_edges,
                   "rowblock at PRODUCTION: not phase 4's edges")
        del got
        same.append(placement)
    del x
    log(f"phase 15 (a) PRODUCTION d={D} n={MAIN_N} sign/int8 over a "
        f"one-rank NCCL mesh: distributed_learn_structure_s={t_dist:.4f} "
        f"learn_structure_s={t_single:.4f} wire_ms={wire_ms:.4f} (the "
        f"all-gather of the {MAIN_N * D} byte payload) peak_bytes={peak}; "
        f"edges == phase 4's; weights bit-identical to strategy_weights "
        f"({', '.join(same)}); launches={json.dumps(counts)}")

    torch.cuda.empty_cache()
    x = ds.sample(CUT_N, batch_seed=1, device=dev)
    for fields in (dict(method="sign", wire="packed"),
                   dict(method="persymbol", rate=4)):
        for placement in ("replicated", "rowblock"):
            sp = Strategy(placement=placement, **fields)
            what = f"phase 15 (a) d={D} n={CUT_N} {sp.label}/{sp.wire} " \
                   f"{placement}"
            wp = WirePlan(sp, mesh=mesh)
            (w_d, t_d), counts_c = counted(total, lambda: timed(
                lambda: distributed_weights(x, mesh, strategy=sp)))
            w_s = E.strategy_weights(x, sp)
            ties = []
            if sp.method == "sign":
                expect(torch.equal(w_d, w_s), f"{what}: weights differ")
            else:
                own = wp.encode(x)
                g_d = wp._assemble_gram(wp.wire(own), own_payload=own,
                                        data_sharded=True)
                del own
                g_s = E.payload_gram(E.strategy_payload(x, sp), sp)
                err = (g_d - g_s).abs()
                expect(bool((err <= code_tolerance(CUT_N, g_s)).all()),
                       f"{what}: Grams differ by {float(err.max())}")
                del g_d, g_s
                t_a, t_b = boruvka_mst(w_d), boruvka_mst(w_s)
                ties = trace_ties(w_d[None].double().cpu(), t_a[None].cpu(),
                                  w_s[None].double().cpu(), t_b[None].cpu(),
                                  D, what)
            log(f"{what}: distributed_weights_s={t_d:.4f} "
                f"{'bit-identical' if not ties and torch.equal(w_d, w_s) else 'within code_tolerance'}"
                f"{' but for ties ' + json.dumps(ties) if ties else ''}; "
                f"launches={json.dumps(counts_c)}")
            del w_d, w_s
    del x
    torch.cuda.empty_cache()


def wire_trials(dev, total):
    """Part (b): run_trials over one-rank NCCL meshes — make_trial_mesh(1)
    and make_trial_mesh(1, model=1) — on phase 12's d = 1024 plans, phase
    14's d = 1024 channel plan (pristine, MIXED_FAULTS) and phase 13's
    d = 16 sparse plan (fixed lam, EBIC): each equal to its mesh-less run
    on the card bit for bit; warm trials/s beside the mesh-less run's."""
    import dataclasses

    from repro_torch.core import FIG3_STRATEGIES
    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.path import PathPlan
    from repro_torch.launch.mesh import make_trial_mesh

    channels = TrialPlan(strategies=_channel_strategies(
        WIDE_MACHINES, WIDE_BUDGET), **CHANNEL_WIDE)
    sparse = TrialPlan(strategies=_sparse_strategies(
        ("sign", "R2", "R4", "original")), **SPARSE_SWEEP)
    plans = {
        "d=1024 FIG3": TrialPlan(strategies=FIG3_STRATEGIES, **TRIALS_BIGD),
        "d=1024 packed": TrialPlan(strategies=_packed_strategies(),
                                   **TRIALS_BIGD),
        "channels d=1024": channels,
        "channels d=1024 mixed": dataclasses.replace(
            channels, faults=FaultPlan(**MIXED_FAULTS)),
        "sparse d=16 fixed": sparse,
        "sparse d=16 ebic": dataclasses.replace(
            sparse, path=PathPlan(**SPARSE_PATH)),
    }
    meshes = {"data": make_trial_mesh(1, device=dev),
              "wire": make_trial_mesh(1, model=1, device=dev)}
    launches = {}
    for name, plan in plans.items():
        alone = run_trials(plan, device=dev)
        warm = {"mesh-less": run_trials(plan, device=dev)}
        _same_as_mesh_less(warm["mesh-less"], alone, f"phase 15 (b) {name} "
                           f"mesh-less rerun", 1)
        for m, mesh in meshes.items():
            for run in ("cold", "warm"):
                got, counts = counted(total, lambda: run_trials(
                    plan, mesh=mesh, device=dev))
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                _same_as_mesh_less(got, alone, f"phase 15 (b) {name} {m} "
                                   f"mesh {run}", 1,
                                   plan if m == "wire" else None)
            warm[m] = got
        log(f"phase 15 (b) {name} ({plan.trials} trials): == mesh-less bit "
            f"for bit; warm s (trials/s): " + ", ".join(
                f"{k} {r.seconds:.4f} ({r.trials_per_s:.1f})"
                for k, r in warm.items()))
    for k in ("sign_corr", "sign_corr_packed", "code_corr",
              "quantize_fused"):
        expect(launches[k] > 0, f"phase 15 (b) launched no {k}")
    log(f"phase 15 (b) launches={json.dumps(launches)}")


def _wire_rank(rank, world, store, out_dir, dev):
    """One rank of part (c), on ``dev`` (cuda:0 for every rank): the plans
    over a (2, 2) wire mesh of ``world`` gloo ranks; writes its results
    and launch counts."""
    import pickle

    import torch
    from repro_torch.core.experiments import run_trials
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.mesh import init_rank, make_trial_mesh

    on_card = dev.startswith("cuda")
    init_rank(rank, world, store, device=dev,
              backend=WIRE_BACKEND if on_card else "gloo")
    if not on_card:
        torch.set_num_threads(1)
    mesh = make_trial_mesh(2, model=2, device=dev)
    reset_launches()
    res = {name: run_trials(plan, mesh=mesh, device=dev)
           for name, plan in _wire_plans().items()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((res, launches()), f)
    torch.distributed.destroy_process_group()


def wire_ranks_on_one_card(dev, total):
    """Part (c): WIRE_RANKS processes on the one card
    (torch.multiprocessing.spawn, a FileStore under build/, gloo on CUDA
    tensors) run _PARITY pristine and faulty and Fig. 3 rowblock at d = 64
    over make_trial_mesh(2, model=2). Every rank's results equal the
    mesh-less card run bit for bit (reports but for the collectives), and
    the mesh-less card run equals the CPU's but for ties
    (card_vs_cpu_sweep)."""
    import pickle
    import shutil

    import torch.multiprocessing as mp
    from repro_torch.core.experiments import run_trials

    work = os.path.join(ROOT, "build", "chip_smoke_wire")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    rank_dev = "cuda:0" if str(dev).startswith("cuda") else "cpu"
    mp.spawn(_wire_rank, args=(WIRE_RANKS, os.path.join(work, "store"),
                               work, rank_dev), nprocs=WIRE_RANKS)
    t_spawn = time.perf_counter() - t0
    ranks = []
    for r in range(WIRE_RANKS):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(work)
    launches = {}
    for _, counts in ranks:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
            total[k] += v
    for k in ("sign_corr", "code_corr", "quantize_fused"):
        expect(launches[k] > 0, f"phase 15 (c) launched no {k}")
    for name, plan in _wire_plans().items():
        alone = run_trials(plan, device=dev)
        for r, (res, _) in enumerate(ranks):
            _same_as_mesh_less(res[name], alone, f"phase 15 (c) {name} rank "
                               f"{r}", WIRE_RANKS, plan)
        host = run_trials(plan, device="cpu")
        ties = card_vs_cpu_sweep(plan, alone, host, dev,
                                 f"phase 15 (c) {name} card vs CPU")
        log(f"phase 15 (c) {name}: {WIRE_RANKS} ranks == mesh-less card "
            f"bit for bit; card == CPU"
            f"{' but for ties ' + json.dumps(ties) if ties else ''}; "
            f"rank 0 {ranks[0][0][name].seconds:.4f} s")
    log(f"phase 15 (c) {WIRE_RANKS} gloo ranks on one card over a (2, 2) "
        f"wire mesh: spawn to end {t_spawn:.1f} s; launches (all ranks)="
        f"{json.dumps(launches)}")


def wire_plane(dev, total, main_edges):
    """Phase 15: parts (a), (b) and (c) above; adds the phase's launches
    to ``total``."""
    t0 = time.perf_counter()
    mine = {k: 0 for k in total}
    for part, args in ((wire_main_path, (main_edges,)), (wire_trials, ()),
                       (wire_ranks_on_one_card, ())):
        t = time.perf_counter()
        part(dev, mine, *args)
        log(f"phase 15 {part.__name__} took {time.perf_counter() - t:.1f} s")
    for k, v in mine.items():
        total[k] += v
    import torch.distributed as dist

    dist.destroy_process_group()  # the one-rank NCCL group of (a) and (b)
    log(f"phase 15 launches={json.dumps(mine)}; took "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 16: LM training
# ---------------------------------------------------------------------------

#: (b): stablelm-3b at full width, bf16 parameters, f32 moments
TRAIN_ARCH = "stablelm-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 6, 2
#: (a): stablelm-3b's attention (MHA, Dh 80) and a GQA one (32/8, Dh 128)
GRAD_LAYOUTS = ((32, 32, 80), (32, 8, 128))
GRAD_B, GRAD_S, GRAD_WINDOW = 2, 1024, 256
#: (a): max |dq, dk, dv of the kernel route - autograd through the plain
#: version| over max |plain|. f32: the kernel's output (within
#: ATTN_F32_ATOL of the plain one) enters D = rowsum(dO * O); bf16: the
#: kernel rounds P to bf16 before PV, and each gradient is rounded to bf16
#: (measured on the H100: at most 3.7e-6 and 6.1e-3)
GRAD_F32_REL = 2e-5
GRAD_BF16_REL = 2 ** -5
#: (c): the reduced config in f32, card (kernel) against CPU (plain):
#: loss and grad norm within TRAIN_RTOL a step; each parameter's
#: difference within TRAIN_PARAM_REL of its update's norm (AdamW's early
#: updates are ~lr * sign(g), so an element whose tiny gradient differs in
#: sign moves 2 lr the other way: an elementwise bound would test that)
#: (measured on the H100: 6e-7 and 9.4e-5)
TRAIN_CMP = dict(batch=2, seq=128, steps=3, warmup=1, lr=1e-3)
TRAIN_RTOL = 1e-5
TRAIN_PARAM_REL = 1e-3


def _grad_route(fn, q, k, v, do, window):
    import torch

    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*ts, causal=True, window=window)
    return (out.detach(), *torch.autograd.grad(out, ts, do))


def check_attention_grad(dev, gen):
    """(a) flash_prefill's autograd.Function (the kernel forward, the
    chunked PyTorch backward) against autograd through the plain version,
    on the card: output and dq, dk, dv. Then the backward's time at the
    training step's shape beside the forward kernel's and SDPA's forward +
    backward. Launches here are comparisons: not counted."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill, ref
    from repro_torch.kernels.flash_prefill import flash_prefill_backward

    worst = {}
    for hq, hkv, dh in GRAD_LAYOUTS:
        for window in (0, GRAD_WINDOW):
            for dtype in (torch.float32, torch.bfloat16):
                def rnd(h):
                    return torch.randn((GRAD_B, GRAD_S, h, dh), generator=gen,
                                       device=dev).to(dtype)

                q, k, v, do = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
                got = _grad_route(flash_prefill, q, k, v, do, window)
                want = _grad_route(ref.flash_prefill_ref, q, k, v, do, window)
                what = (f"phase 16(a) {hq}/{hkv} heads Dh {dh} window "
                        f"{window} {str(dtype)[6:]}")
                out_err = _attn_close(got[0], want[0], what)
                tol = GRAD_F32_REL if dtype == torch.float32 \
                    else GRAD_BF16_REL
                rels = []
                for name, g, w in zip("qkv", got[1:], want[1:]):
                    w32 = w.float()
                    rel = float((g.float() - w32).abs().max()
                                / w32.abs().max())
                    expect(g.dtype == dtype and bool(torch.isfinite(g).all())
                           and rel <= tol, f"{what}: d{name} differs by "
                           f"{rel} of its max (tolerance {tol})")
                    rels.append(rel)
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), *rels)
                log(f"{what}: out max |err| {out_err:.3e}; dq, dk, dv max "
                    f"|err| / max |g|: " + ", ".join(f"{r:.3e}" for r in rels))
    log(f"phase 16(a) gradient route == autograd through the plain version "
        f"(B={GRAD_B}, S={GRAD_S}, causal, window 0 and {GRAD_WINDOW}); "
        f"worst relative error f32 {worst['float32']:.3e} (tolerance "
        f"{GRAD_F32_REL}), bf16 {worst['bfloat16']:.3e} (tolerance "
        f"{GRAD_BF16_REL})")

    # the training step's attention: stablelm-3b, B=4, S=2048, bf16
    from repro_torch.models.arch import get_arch

    cfg = get_arch(TRAIN_ARCH)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    out = flash_prefill(q, k, v)
    fwd = event_ms(lambda: flash_prefill(q, k, v), 3)
    bwd = event_ms(lambda: flash_prefill_backward(q, k, v, out, do), 3)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def sdpa():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        return torch.autograd.grad(o, (qs, ks, vs), do.transpose(1, 2))

    sdpa_ms = event_ms(sdpa, 3)
    log(f"phase 16(a) attention at the step's shape (B={TRAIN_BATCH}, "
        f"S={TRAIN_SEQ}, {cfg.n_heads} heads, Dh {cfg.hd}, bf16, causal): "
        f"flash_prefill forward {fwd:.4f} ms, backward (PyTorch, f32) "
        f"{bwd:.4f} ms; SDPA forward + backward {sdpa_ms:.4f} ms (library, "
        f"timed only)")
    del q, k, v, do, out, qs, ks, vs
    torch.cuda.empty_cache()
    return bwd


def _step_split(model, optimizer, batch, attn_bwd_ms):
    """Event times of one more step at the trainer's shape and of its
    parts: the forward with the loss, the blocks' forward alone (what the
    recompute runs), the attention backward (n_layers x its time at one
    layer), clip + AdamW; the rest of the step is the other backward. And
    one profiled step: device busy share and time by kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import clip_by_global_norm, constant

    cfg = model.cfg
    step = make_train_step(cfg, InputShape("cli", "train", TRAIN_SEQ,
                                           TRAIN_BATCH), constant(0.0))
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def forward():
        h, _ = model(batch["tokens"])
        return model.lm_loss(h, batch["labels"], batch["mask"])

    def blocks():
        with torch.no_grad():
            return model(batch["tokens"])

    grads = torch.autograd.grad(forward(), params)

    def opt():
        g, _ = clip_by_global_norm(grads, 1.0)
        optimizer.step(0.0, g)

    parts = {"step": event_ms(lambda: step(model, optimizer, batch), 2),
             "forward": event_ms(forward, 2),
             "recompute": event_ms(blocks, 2),
             "attention_backward": attn_bwd_ms * cfg.n_layers,
             "optimizer": event_ms(opt, 2)}
    del grads
    parts["other_backward"] = parts["step"] - sum(
        v for k, v in parts.items() if k != "step")
    log("phase 16(b) a step's split, ms (CUDA events, each part alone): "
        + " ".join(f"{k}={v:.1f}" for k, v in parts.items()))
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, optimizer, batch)
        sync()
        wall = time.perf_counter() - t0
    groups: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t and "CUDA" in str(getattr(e, "device_type", "")):
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + t / 1e3
    busy = sum(groups.values())
    expect(busy > 0, "the profiler saw no device time in a train step")
    log(f"phase 16(b) profiled step: wall {wall * 1e3:.1f} ms, device "
        f"{busy:.1f} ms (busy {busy / wall / 1e3:.3f}): " + " ".join(
            f"{g}={t:.1f}ms" for g, t in sorted(groups.items(),
                                                key=lambda kv: -kv[1])))
    return parts


def train_full_width(dev, total, attn_bwd_ms):
    """(b) launch.train.main for stablelm-3b at full width in bf16."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.train import main as train_main

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    snaps = {}

    def on_step(step, model, optimizer, metrics):
        if step < 2:
            snaps[step] = model.layers[0].mixer.wq.detach()[:64].clone()

    argv = ["--arch", TRAIN_ARCH, "--param-dtype", "bf16", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
            str(TRAIN_STEPS), "--warmup", str(TRAIN_WARMUP), "--seed", "0",
            "--log-every", "1", "--device", dev]
    reset_launches()
    t0 = time.perf_counter()
    res = train_main(argv, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = launches()
    for k, n in counts.items():
        total[k] += n
    peak = torch.cuda.max_memory_allocated()
    model, cfg = res.model, res.model.cfg
    expect(model.dtype == torch.bfloat16, "the trainer's params are not bf16")
    expect(all(map(math.isfinite, res.losses + res.grad_norms)),
           f"a loss or grad norm is not finite: {res.losses} "
           f"{res.grad_norms}")
    expect(res.lrs[0] == 0.0, "the first step's learning rate is not 0")
    expect(not torch.equal(snaps[0], snaps[1]),
           "the parameters did not move in step 2")
    expect(res.losses[-1] < res.losses[0], f"the loss did not fall: "
           f"{res.losses}")
    want = cfg.n_layers * 2 * TRAIN_STEPS
    expect(counts["flash_prefill"] > 0, "the trainer launched no "
           "flash_prefill")
    note = "" if counts["flash_prefill"] == want else \
        f" (NOT {want} = {cfg.n_layers} x 2 x {TRAIN_STEPS})"
    toks = TRAIN_BATCH * TRAIN_SEQ
    warm = res.step_s[1:]
    log(f"phase 16(b) train {cfg.name} (full width: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, Dh "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) bf16 params "
        f"{model.param_count()} f32 moments; batch {TRAIN_BATCH} seq "
        f"{TRAIN_SEQ} {TRAIN_STEPS} steps warm-up {TRAIN_WARMUP}: first "
        f"step {res.step_s[0]:.4f} s, warm steps "
        f"{[round(s, 4) for s in warm]} s (median "
        f"{statistics.median(warm):.4f} s, {toks / statistics.median(warm):.1f}"
        f" tok/s); data waits {[round(s, 3) for s in res.data_s]} s; run "
        f"{wall:.1f} s; peak_bytes={peak}; flash_prefill launches "
        f"{counts['flash_prefill']}{note}")
    log(f"phase 16(b) losses {res.losses} grad norms {res.grad_norms} lrs "
        f"{res.lrs}; final loss {res.final_loss:.4f}, unigram entropy bound "
        f"{res.entropy_bound:.3f} nats")
    # the split's batch: uniform ids (the split times shapes, not data)
    ids = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(TRAIN_STEPS))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:],
             "mask": torch.ones((TRAIN_BATCH, TRAIN_SEQ), device=dev)}
    _step_split(model, res.optimizer, batch, attn_bwd_ms)
    del res, model, snaps, batch
    torch.cuda.empty_cache()


def train_card_vs_cpu(dev, arch=TRAIN_ARCH, cmp=None, phase="phase 16(c)"):
    """(c) ``arch``'s reduced config in f32 from the same params, card
    (kernel) against CPU (plain), step by step (``cmp``: TRAIN_CMP's
    keys). A vision or encoder-decoder model's steps take the trainer's
    stub embeddings (``train.step_embeds``: the same on both devices) and
    a text stream shortened by P, as ``launch/train.py`` feeds them."""
    import copy

    import torch
    from repro_torch.data import TokenStream, token_batches
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import step_embeds
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamW, linear_warmup_cosine

    c = cmp or TRAIN_CMP
    cfg = get_arch(arch).reduced()
    cpu = Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    card = copy.deepcopy(cpu).to(dev)
    stream = TokenStream(cfg.vocab, c["seq"] - (cfg.modality_tokens or 0),
                         c["batch"], seed=0)
    runs = {}
    for where, model in (("card", card), ("cpu", cpu)):
        model.requires_grad_(True)
        opt = AdamW(model.parameters())
        step = make_train_step(cfg, InputShape("cli", "train", c["seq"],
                                               c["batch"]),
                               linear_warmup_cosine(c["lr"], c["warmup"],
                                                    c["steps"]))
        runs[where] = [
            {k: float(v) for k, v in step(model, opt, {**b, **step_embeds(
                cfg, 0, i, c["batch"], c["seq"], model.device)}).items()}
            for i, b in enumerate(token_batches(stream, device=model.device,
                                                stop=c["steps"]))]
    for i, (a, b) in enumerate(zip(runs["card"], runs["cpu"])):
        expect(a["lr"] == b["lr"], f"{phase} step {i}: lr differs")
        for k in ("loss", "grad_norm"):
            expect(abs(a[k] - b[k]) <= TRAIN_RTOL * abs(b[k]),
                   f"{phase} step {i}: {k} card {a[k]} CPU {b[k]}")
    worst_rel = worst_abs = 0.0
    for (n, pc), (_, ph) in zip(card.named_parameters(),
                                cpu.named_parameters()):
        d = (pc.detach().cpu() - ph.detach())
        upd = (ph.detach() - init[n]).norm()
        rel = float(d.norm() / upd.clamp_min(1e-30))
        worst_rel, worst_abs = max(worst_rel, rel), max(
            worst_abs, float(d.abs().max()))
        expect(rel <= TRAIN_PARAM_REL, f"{phase} {n}: card - CPU is "
               f"{rel} of the update's norm")
    log(f"{phase} train card == CPU ({cfg.name} reduced, f32, "
        f"{c['steps']} steps, lr {c['lr']}): losses card "
        f"{[r['loss'] for r in runs['card']]} CPU "
        f"{[r['loss'] for r in runs['cpu']]}; grad norms card "
        f"{[r['grad_norm'] for r in runs['card']]} CPU "
        f"{[r['grad_norm'] for r in runs['cpu']]}; params: worst |card - "
        f"CPU| / |update| {worst_rel:.3e} (tolerance {TRAIN_PARAM_REL}), "
        f"max |card - CPU| {worst_abs:.3e}")


class _Preempted(Exception):
    pass


def train_resume(dev):
    """(d) 4 steps straight, and 2 steps + checkpoint + a new process's
    resume + 2 steps, on the reduced config: parameters and moments bit
    for bit."""
    import shutil

    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.train import train

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    kw = dict(reduced=True, steps=4, batch=2, seq=128, warmup=1, lr=1e-3,
              device=dev, log_every=100)
    reset_launches()
    straight = train(TRAIN_ARCH, **kw)

    def preempt(step, *_):
        if step == 1:
            raise _Preempted

    try:
        train(TRAIN_ARCH, ckpt_dir=work, ckpt_every=2, on_step=preempt, **kw)
        expect(False, "phase 16(d): the run was not preempted")
    except _Preempted:
        pass
    resumed = train(TRAIN_ARCH, ckpt_dir=work, ckpt_every=2, **kw)
    n = launches()["flash_prefill"]
    expect(resumed.start == 2, "phase 16(d) did not resume from step 2")
    expect(resumed.losses == straight.losses[2:], f"phase 16(d): resumed "
           f"losses {resumed.losses} vs {straight.losses[2:]}")
    a = list(straight.model.named_parameters())
    b = list(resumed.model.named_parameters())
    for (name, x), (_, y) in zip(a, b):
        expect(torch.equal(x, y), f"phase 16(d): {name} differs after resume")
    ma = straight.optimizer.state_tree(a)["moments"]
    mb = resumed.optimizer.state_tree(b)["moments"]
    for m in ma:
        for name in ma[m]:
            expect(torch.equal(ma[m][name], mb[m][name]),
                   f"phase 16(d): {m} of {name} differs after resume")
    expect(resumed.optimizer.step_count == 4, "phase 16(d): step count")
    log(f"phase 16(d) resume: 4 straight steps == 2 + checkpoint + resume + "
        f"2, parameters and moments bit for bit (losses "
        f"{straight.losses}); flash_prefill launches {n}")
    shutil.rmtree(work, ignore_errors=True)


def train_plane(dev, total, gen):
    t0 = time.perf_counter()
    attn_bwd_ms = check_attention_grad(dev, gen)
    train_full_width(dev, total, attn_bwd_ms)
    train_card_vs_cpu(dev)
    train_resume(dev)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 17: the Gram autotune cache
# ---------------------------------------------------------------------------

#: (path, n) tuned at the main path's shapes, d = D
AUTOTUNE_POINTS = (("int8", MAIN_N), ("packed", CUT_N), ("code", CUT_N))


def gram_autotune(dev, total):
    """Tune the three kernel paths at the main path's buckets, with the
    cache file under build/; a warm tune runs no sweep, a fresh in-memory
    cache reloads from the file; the winners' Grams against the default
    engine's; run_trials with an autotuning engine on phase 12's d = 1024
    plan equals the untuned sweep."""
    import shutil

    import torch
    from repro_torch.core import FIG3_STRATEGIES
    from repro_torch.core import gram as gm
    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.quantizers import PerSymbolQuantizer

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_autotune")
    shutil.rmtree(work, ignore_errors=True)
    os.environ[gm.AUTOTUNE_CACHE_ENV] = os.path.join(work,
                                                     "gram_autotune.json")
    os.environ.pop(gm.AUTOTUNE_ENV, None)
    gm.clear_autotune_cache()
    eng = gm.GramEngine(autotune=True, device=dev)
    c0 = gm.autotune_sweep_count()
    wins = {}
    for path, n in AUTOTUNE_POINTS:
        (win, t), _ = counted(total, lambda: timed(
            lambda: eng.tune(path, n, D)))
        rec = gm.autotune_sweep_log()[-1]
        wins[path] = win
        log(f"phase 17 tune {path} n={n} d={D} ({rec['key']}): winner "
            f"d_tile={win.d_tile} n_chunk={win.n_chunk} in {t:.3f} s; "
            f"candidates (d_tile/n_chunk: best of 2 ms) " + ", ".join(
                f"{c.d_tile}/{c.n_chunk}: {s * 1e3:.4f}"
                for c, s in rec["times"]))
    expect(gm.autotune_sweep_count() == c0 + 3, "phase 17: not one sweep "
           "a point")
    for path, n in AUTOTUNE_POINTS:
        expect(eng.tune(path, n, D) == wins[path], "phase 17: warm winner")
    expect(gm.autotune_sweep_count() == c0 + 3, "phase 17: a warm tune swept")
    gm.clear_autotune_cache()
    for path, n in AUTOTUNE_POINTS:
        expect(eng.tune(path, n, D) == wins[path], "phase 17: reloaded "
               "winner differs")
    expect(gm.autotune_sweep_count() == c0 + 3,
           "phase 17: reloading the file swept")
    log(f"phase 17 warm tunes and a reload from "
        f"{os.path.relpath(gm.autotune_cache_path(), ROOT)} ran no sweep")

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    plain = gm.GramEngine(device=dev)
    u = _signs(gen, (MAIN_N, D), dev)
    expect(torch.equal(counted(total, lambda: eng.gram(u))[0], plain.gram(u)),
           "phase 17: the tuned int8 Gram differs from the default's")
    del u
    p = _packed(gen, (D, CUT_N), dev)
    expect(torch.equal(counted(total, lambda: eng.packed_sign_gram(
        p, CUT_N))[0], plain.packed_sign_gram(p, CUT_N)),
        "phase 17: the tuned packed Gram differs from the default's")
    del p
    codes = _codes(gen, (CUT_N, D), 4, dev)
    cb = torch.as_tensor(PerSymbolQuantizer(4).centroids_np, device=dev)
    got, want = counted(total, lambda: eng.code_gram(codes, cb))[0], \
        plain.code_gram(codes, cb)
    err = (got - want).abs()
    expect(bool((err <= code_tolerance(CUT_N, want)).all()),
           f"phase 17: the tuned code Gram is off by {float(err.max())}")
    log(f"phase 17 tuned Grams at the main path's shapes: int8 (n={MAIN_N}) "
        f"and packed (n={CUT_N}) bit-identical to the default config's; "
        f"code R=4 (n={CUT_N}) max |diff| {float(err.max())} "
        f"(bit-identical: {bool(torch.equal(got, want))})")
    del codes, got, want, err
    torch.cuda.empty_cache()

    plan = TrialPlan(strategies=FIG3_STRATEGIES, **TRIALS_BIGD)
    n0 = gm.autotune_sweep_count()
    (tuned, t), counts = counted(total, lambda: timed(lambda: run_trials(
        plan, engine=gm.GramEngine(autotune=True, device=dev), device=dev)))
    swept = gm.autotune_sweep_count() - n0
    untuned = run_trials(plan, device=dev)
    _same_results(tuned, untuned, "phase 17 autotuned vs untuned d=1024 sweep")
    keys = [r for r in gm.autotune_sweep_log()[-swept:]] if swept else []
    log(f"phase 17 run_trials(engine=GramEngine(autotune=True)) on phase "
        f"12's d=1024 plan ({plan.trials} trials): {t:.3f} s with {swept} "
        f"sweeps, equal to the untuned sweep bit for bit; winners " +
        ", ".join(f"{r['key']}: {r['winner'].d_tile}/{r['winner'].n_chunk}"
                  for r in keys) + f"; launches={json.dumps(counts)}")
    shutil.rmtree(work, ignore_errors=True)
    os.environ.pop(gm.AUTOTUNE_CACHE_ENV, None)
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 18: MoE and Mamba2 serving
# ---------------------------------------------------------------------------

MOE_ARCH, SSM_ARCH = "qwen2-moe-a2.7b", "mamba2-370m"
#: (name, arch, capacity factor or None) of the reduced models held card
#: against CPU; at 1.25 qwen2-moe's 4 real experts of 16 overflow at 80
#: tokens, so its prefill drops assignments (and jamba's does)
MOE_CMP = (("qwen2-moe cap 64", MOE_ARCH, 64.0),
           ("qwen2-moe cap 1.25", MOE_ARCH, None),
           ("mamba2", SSM_ARCH, None),
           ("jamba", "jamba-1.5-large-398b", None))
MOE_CMP_BATCH, MOE_CMP_PROMPT, MOE_CMP_STEPS = 2, 40, 8
#: card vs CPU |logit| bound; jamba's 12 Mamba2 layers sit at the f32 SSD
#: scan's noise floor (on the CPU the port is ~9.2e-5 on these logits from
#: itself with the whole scan in f64; tests/test_torch_hybrid.py holds it
#: to repro at the same bound)
MOE_CMP_ATOL = {"jamba": 1e-3}
#: a router top-k near-tie: the k-th and (k+1)-th f32 probabilities
#: within this of each other
ROUTER_TIE = 1e-6


def moe_hooks(model, fn):
    """A forward hook calling fn(moe, its input) on every MoE layer of
    ``model``; returns the handles."""
    return [blk.ff.register_forward_hook(lambda m, inp, out: fn(m, inp[0]))
            for blk in model.layers if blk.spec.ff == "moe"]


def decode_bytes(model, batch, prompt, gen_len):
    """(weight bytes, KV bytes) one decode step reads at least, the mean
    over the run's steps: every parameter but the embedding table (a step
    gathers B rows of it) and every MoE expert (the step's dispatch runs
    all E_pad of them), and the K/V entries an attention layer reads
    (``prompt + i + 1`` of them at step i)."""
    import torch

    cfg = model.cfg
    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if n != "embed")
    n_attn = sum(blk.spec.mixer == "attn" for blk in model.layers)
    item = torch.finfo(model.dtype).bits // 8
    mean_len = prompt + 1 + (gen_len - 2) / 2
    kv = 2 * n_attn * batch * cfg.n_kv_heads * cfg.hd * item * mean_len
    return weights, kv


def nth_calls(wanted, clone=False):
    """Patch ``repro_torch.models.layers``' attention wrappers with spies
    that keep the arguments of the calls ``wanted`` names ({wrapper: call
    indices}, counted from 0 per wrapper) and pass every call on; returns
    (the patches to enter, {(wrapper, index): (args, kw)}). ``clone``
    keeps copies of the tensor arguments (a cache that later steps
    write)."""
    from unittest import mock

    from repro_torch.models import layers

    seen: dict = {}

    def spy(name, real):
        count = [0]

        def call(*args, **kw):
            if count[0] in wanted[name]:
                seen[(name, count[0])] = (tuple(
                    a.clone() if clone and hasattr(a, "clone") else a
                    for a in args), kw)
            count[0] += 1
            return real(*args, **kw)
        return call

    return [mock.patch.object(layers, n, spy(n, getattr(layers, n)))
            for n in wanted], seen


def moe_attention_on_its_path(model, prompts, gen_len):
    """``flash_prefill`` and ``decode_attention`` held to their plain
    versions (``_attn_close``) on the q/k/v and the cache that the model's
    first attention layer hands them: a prefill of ``prompts`` into a
    cache of ``prompt + gen_len`` slots, then one decode step at position
    ``prompt``. Returns {kernel: (shapes, max |error|)}."""
    import contextlib

    from repro_torch.kernels import decode_attention, flash_prefill, ref

    b, s = prompts.shape
    patches, seen = nth_calls({"flash_prefill": {0},
                               "decode_attention": {0}})
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        logits, cache = model.prefill(prompts, max_len=s + gen_len)
        model.decode_step(cache, logits[:, -1].argmax(-1, keepdim=True), s)
    out = {}
    (q, k, v), kw = seen[("flash_prefill", 0)]
    err = _attn_close(flash_prefill(q, k, v, **kw),
                      ref.flash_prefill_ref(q, k, v, **kw),
                      f"phase 18 (a) flash_prefill on {MOE_ARCH}'s path")
    out["flash_prefill"] = (f"q/k/v {tuple(q.shape)} {q.dtype} {kw}", err)
    (q, k, v, n_valid), kw = seen[("decode_attention", 0)]
    err = _attn_close(decode_attention(q, k, v, n_valid, **kw),
                      ref.decode_attention_ref(q, k, v, n_valid, **kw),
                      f"phase 18 (a) decode_attention on {MOE_ARCH}'s path")
    out["decode_attention"] = (f"q {tuple(q.shape)}, cache {tuple(k.shape)} "
                               f"{k.dtype}, n_valid {n_valid}", err)
    return out


def expert_loads(model, prompts):
    """The assignments each MoE layer's experts receive in a prefill of
    ``prompts`` (layers, E_pad), before the capacity drops any: hooks
    rerun each layer's routing on its input."""
    import torch
    from repro_torch.models.layers import moe_slots

    loads = []

    def load(m, x):
        t, e = x.shape[0] * x.shape[1], m.cfg.padded_experts
        _, ids, _ = m.route(x.reshape(t, -1))
        loads.append(moe_slots(ids, e, t * m.cfg.moe_top_k)[1])

    hooks = moe_hooks(model, load)
    model.prefill(prompts)
    for h in hooks:
        h.remove()
    return torch.stack(loads)


def serve_moe(dev, batch, prompt, gen_len, total):
    """Phase 18 (a): qwen2-moe-a2.7b at full width in bf16, served like
    phase 7; both attention kernels held to their plain versions on the
    model's own q/k/v and cache; the assignments its prefill drops at
    capacity 1.25 and each layer's expert loads (hooks that rerun each
    MoE layer's routing and capacity on its input, in a prefill of their
    own); its profile with the expert products' time; the decode step
    beside its byte bound."""
    import torch
    from repro_torch.models.layers import moe_capacity

    model, prompts, res, counts, _ = serve_at_width(
        dev, MOE_ARCH, batch, prompt, gen_len, "phase 18 (a)")
    for k in ("flash_prefill", "decode_attention"):
        total[k] += counts[k]
    checked = moe_attention_on_its_path(model, prompts, gen_len)
    log("phase 18 (a) attention kernels on the model's first attention "
        "layer, against their plain versions: " + "; ".join(
            f"{k} {shape}: max |kernel - plain| {err}"
            for k, (shape, err) in checked.items()))
    cfg, t = model.cfg, batch * prompt
    e_pad, cap = cfg.padded_experts, moe_capacity(cfg, t, cfg.padded_experts)
    loads = expert_loads(model, prompts)
    n_assign = t * cfg.moe_top_k * loads.shape[0]
    n_drop = int((loads - cap).clamp(min=0).sum())
    expect(int(loads.sum()) == n_assign and
           int(loads[:, cfg.moe_experts:].sum()) == 0,
           "phase 18 (a) the router assigned tokens to a padding expert")
    mean = t * cfg.moe_top_k / cfg.moe_experts
    real = loads[:, :cfg.moe_experts]
    log(f"phase 18 (a) prefill drops {n_drop} of {n_assign} token-expert "
        f"assignments ({n_drop / n_assign:.5f}) over {loads.shape[0]} MoE "
        f"layers at capacity factor {cfg.moe_capacity_factor} ({t} tokens, "
        f"top-{cfg.moe_top_k} of {cfg.moe_experts} experts padded to "
        f"{e_pad}: {cap} slots an expert, {cap / mean:.4f} times a real "
        f"expert's mean load {mean:.2f}; a decode step's {batch} tokens "
        f"fill at most {batch} of its {moe_capacity(cfg, batch, e_pad)})")
    log("phase 18 (a) expert loads by layer (max, min over the real "
        "experts; experts over capacity; dropped): " + json.dumps(
            [[int(r.max()), int(r.min()), int((r > cap).sum()),
              int((r - cap).clamp(min=0).sum())] for r in real]))
    step_s = res.decode_s / (gen_len - 1)
    weights, kv = decode_bytes(model, batch, prompt, gen_len)
    bound_ms = (weights + kv) / HBM_BYTES_PER_S * 1e3
    experts = sum(blk.ff.exp_wgate.nbytes + blk.ff.exp_wi.nbytes
                  + blk.ff.exp_w_down.nbytes for blk in model.layers
                  if blk.spec.ff == "moe")
    log(f"phase 18 (a) decode step {step_s * 1e3:.3f} ms beside its byte "
        f"bound {bound_ms:.3f} ms ({step_s * 1e3 / bound_ms:.2f}x): experts "
        f"{experts / 1e9:.3f} GB + other weights "
        f"{(weights - experts) / 1e9:.3f} GB + K/V {kv / 1e9:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; active params a token "
        f"{model.active_param_count()} of {model.param_count()}")
    # the MoE's expert products are the model's only batched matmuls
    profile_serving(model, prompts, res.prefill_s, step_s,
                    phase="phase 18 (a)",
                    ops={"aten::bmm": "expert products (aten::bmm)"})
    del model, res, prompts
    torch.cuda.empty_cache()


def serve_ssm(dev, batch, prompt, gen_len):
    """Phase 18 (b): mamba2-370m at full width in bf16, served like phase
    7: attention-free, so no attention kernel launches."""
    import torch
    from repro_torch.kernels.flash_prefill import largest_divisor
    from repro_torch.models.layers import ssd_chunk

    model, prompts, res, _, _ = serve_at_width(
        dev, SSM_ARCH, batch, prompt, gen_len, "phase 18 (b)")
    cfg = model.cfg
    chunk = largest_divisor(prompt, ssd_chunk(batch, prompt, cfg.ssm_heads))
    weights, _ = decode_bytes(model, batch, prompt, gen_len)
    step_s = res.decode_s / (gen_len - 1)
    log(f"phase 18 (b) SSD chunk length {chunk} ({prompt // chunk} chunks "
        f"a layer, {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}); decode step {step_s * 1e3:.3f} ms beside its "
        f"weight bytes' bound {weights / HBM_BYTES_PER_S * 1e3:.4f} ms")
    profile_serving(model, prompts, res.prefill_s, step_s,
                    phase="phase 18 (b)")
    del model, res, prompts
    torch.cuda.empty_cache()


def record_routes(model, calls):
    """Hooks appending, for each MoE call of ``model``, (layer, each
    token's experts in ascending order (T, k), each token's gap between
    its k-th and (k+1)-th router probability (T,)) to ``calls``, on the
    CPU."""
    import torch

    def hook(layer):
        def rec(m, inp, out):
            x = inp[0]
            _, ids, probs = m.route(x.reshape(-1, x.shape[-1]))
            top = torch.topk(probs, m.cfg.moe_top_k + 1, dim=-1).values
            calls.append((layer, ids.sort(-1).values.cpu(),
                          (top[:, -2] - top[:, -1]).cpu()))
        return rec

    return [blk.ff.register_forward_hook(hook(i))
            for i, blk in enumerate(model.layers) if blk.spec.ff == "moe"]


def first_parting(host, card):
    """The first MoE call, in call order, at which the card routed a token
    to other experts than the CPU: (layer, [(token, CPU top-k gap)]), or
    None. A later call's partings may follow from this one's."""
    for (layer, ids, gap), (_, ids_card, _) in zip(host, card):
        tokens = (ids != ids_card).any(-1).nonzero().flatten().tolist()
        if tokens:
            return layer, [(t, float(gap[t])) for t in tokens]
    return None


def greedy_card_vs_cpu(dev, cfg, name, phase, atol, embeds=None,
                       b=MOE_CMP_BATCH, s=MOE_CMP_PROMPT,
                       steps=MOE_CMP_STEPS):
    """``cfg`` in f32, the same weights on the card and the CPU, a prefill
    of ``b`` x ``s`` tokens (after ``embeds(cpu model, b, s)``, the
    modality stub's inputs, when given) and ``steps`` greedy decode steps:
    every MoE call routes every token to the same experts, ids are equal
    and logits within ``atol``. A step is excused only where the first MoE
    call at which the two route a token differently does so at router
    near-ties (top-k gap under ROUTER_TIE) alone; it is logged with its
    layer and tokens, and the card takes the CPU's cache before the next
    step, so that every later step is compared from equal states. Both
    devices always step on the CPU's token. Returns (max |logit error|,
    assignments the prefill dropped, the smallest router top-k gap or
    None, the near-ties)."""
    import copy

    import torch
    from repro_torch.models.transformer import Transformer

    gen = torch.Generator().manual_seed(0)
    cpu = Transformer(cfg, device="cpu", dtype=torch.float32, generator=gen)
    card = copy.deepcopy(cpu).to(dev)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    emb = embeds(cpu, b, s) if embeds else {}
    emb_card = {k: v.to(dev) for k, v in emb.items()}
    pos = s + (emb["modal_embeds"].shape[1] if "modal_embeds" in emb else 0)
    dropped, on_cpu, on_card = [], [], []
    hooks = moe_hooks(cpu, lambda m, x: dropped.append(int(m.dropped(x))))
    hooks += record_routes(cpu, on_cpu) + record_routes(card, on_card)
    worst, gaps, ties = 0.0, [], []
    lc, cc = cpu.prefill(tokens, max_len=pos + steps, **emb)
    lg, cg = card.prefill(tokens.to(dev), max_len=pos + steps, **emb_card)
    drops = sum(dropped)
    for i in range(steps + 1):
        expect(len(on_cpu) == len(on_card), f"{phase} {name} step "
               f"{i}: {len(on_cpu)} MoE calls on the CPU, "
               f"{len(on_card)} on the card")
        gaps += [float(g.min()) for _, _, g in on_cpu]
        err = float((lg.cpu() - lc).abs().max())
        tok = lc[:, -1].argmax(-1, keepdim=True)
        same = torch.equal(lg[:, -1].argmax(-1, keepdim=True).cpu(), tok)
        parting = first_parting(on_cpu, on_card)
        on_cpu.clear()
        on_card.clear()
        if parting is None:
            expect(err <= atol and same, f"{phase} {name} step "
                   f"{i}: max |logit error| {err} (bound {atol}), ids "
                   f"equal {same}, with the same routing")
            worst = max(worst, err)
        else:
            layer, parted = parting
            expect(all(g < ROUTER_TIE for _, g in parted),
                   f"{phase} {name} step {i}: layer {layer} routes "
                   f"(token, top-k gap) {parted} differently on the card "
                   f"and on the CPU, not all at near-ties")
            ties.append((i, layer, parted, err, same))
            log(f"{phase} {name} step {i}: layer {layer} routes "
                f"(token, top-k gap) {parted} differently at router "
                f"near-ties: |logit error| {err}, ids equal {same}; the "
                f"card takes the CPU's cache")
            cg = [{k: t.to(dev) for k, t in c.items()} for c in cc]
        if i < steps:
            lc, cc = cpu.decode_step(cc, tok, pos + i)
            lg, cg = card.decode_step(cg, tok.to(dev), pos + i)
    for h in hooks:
        h.remove()
    return worst, drops, min(gaps, default=None), ties


def moe_card_vs_cpu(dev):
    """Phase 18 (c): MOE_CMP's reduced models in f32, the same weights on
    the card and the CPU (``greedy_card_vs_cpu``): a prefill and
    MOE_CMP_STEPS greedy decode steps route every token to the same
    experts and give equal ids and logits within 1e-4 (MOE_CMP_ATOL),
    router near-ties excused and logged."""
    import dataclasses

    from repro_torch.models.arch import get_arch

    b, s, steps = MOE_CMP_BATCH, MOE_CMP_PROMPT, MOE_CMP_STEPS
    for name, arch, cap in MOE_CMP:
        cfg = get_arch(arch).reduced()
        if cap is not None:
            cfg = dataclasses.replace(cfg, moe_capacity_factor=cap)
        atol = MOE_CMP_ATOL.get(name, 1e-4)
        worst, drops, gap, ties = greedy_card_vs_cpu(
            dev, cfg, name, "phase 18 (c)", atol)
        expect((drops > 0) == ("cap 64" not in name and arch != SSM_ARCH),
               f"phase 18 (c) {name}: the prefill dropped {drops} "
               f"assignments")
        log(f"phase 18 (c) {name} card == CPU over a prefill + {steps} "
            f"greedy steps (f32, batch {b}, prompt {s}, {cfg.n_layers} "
            f"layers, d_model {cfg.d_model}): max |logit error| {worst} "
            f"(bound {atol}); prefill drops {drops}; smallest router top-k "
            f"gap {gap}; near-ties {ties}")


def moe_mamba_serving(dev, total):
    """Phase 18: (a) qwen2-moe-a2.7b and (b) mamba2-370m at full width in
    bf16, (c) the reduced MoE, SSM and hybrid models card against CPU."""
    t0 = time.perf_counter()
    serve_moe(dev, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, total)
    t1 = time.perf_counter()
    serve_ssm(dev, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)
    t2 = time.perf_counter()
    moe_card_vs_cpu(dev)
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f}, "
        f"(b) {t2 - t1:.1f}, (c) {time.perf_counter() - t2:.1f})")


# ---------------------------------------------------------------------------
# Phase 19: the modality stubs and the encoder-decoder stack
# ---------------------------------------------------------------------------

#: (tag, arch, decoder layers or 0 for all) served at full width in bf16.
#: llama4-scout's 48 layers hold 107.8e9 parameters (215.5 GB in bf16),
#: more than one card's 80 GB: it is cut to 8 layers (39.4 GB), whole
#: widths kept
STUB_SERVE = (("(a)", "llava-next-mistral-7b", 0),
              ("(b)", "seamless-m4t-large-v2", 0),
              ("(c)", "llama4-scout-17b-a16e", 8))
#: parameters each serves (llama4-scout at its 8-layer cut)
STUB_PARAMS = {"llava-next-mistral-7b": 7_241_732_096,
               "seamless-m4t-large-v2": 2_034_886_656,
               "llama4-scout-17b-a16e": 19_687_756_800}
#: {arch: (kernel, index of the call among that kernel's calls in a
#: prefill and one decode step (a function of the model), what the call
#: is)} of the attention calls phase 19 (d) holds and times: the slice's
#: own operands. A seamless prefill runs its encoder layers first, then
#: decoder layer 0's self- and cross-attention; its decode step layer 0's
#: self, then cross decode
STUB_KERNEL_CALLS = {
    "llava-next-mistral-7b": (
        ("flash_prefill", lambda m: 0, "decoder layer 0 over the patch "
         "prefix + prompt, causal"),),
    "seamless-m4t-large-v2": (
        ("flash_prefill", lambda m: 0, "encoder layer 0, bidirectional"),
        ("flash_prefill", lambda m: len(m.enc_layers) + 1, "decoder layer "
         "0's cross-attention over the encoder's memory"),
        ("decode_attention", lambda m: 1, "decoder layer 0's cross decode "
         "over the cross cache, every slot valid"))}
STUB_CMP = ("llava-next-mistral-7b", "seamless-m4t-large-v2",
            "llama4-scout-17b-a16e")
STUB_TRAIN = ("seamless-m4t-large-v2", "llava-next-mistral-7b")
STUB_TRAIN_CMP = dict(batch=2, seq=128, steps=1, warmup=0, lr=1e-3)


def stub_kernel_cases(model, prompts, embeds, gen_len, calls, phase):
    """Phase 19 (d): each of ``calls`` (STUB_KERNEL_CALLS' entries) held to
    its plain version (``_attn_close``) on the operands ``model``'s prefill
    and first decode step hand it, and timed beside its plain version and
    scaled_dot_product_attention on them (the prefill kernel by CUDA
    events, the decode kernel by device time). Returns {kernel: [record
    subsets]}."""
    import contextlib

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, flash_prefill, ref

    calls = [(kernel, index(model), what) for kernel, index, what in calls]
    wanted: dict = {}
    for kernel, i, _ in calls:
        wanted.setdefault(kernel, set()).add(i)
    patches, seen = nth_calls(wanted)
    s = prompts.shape[1] + (embeds["modal_embeds"].shape[1]
                            if "modal_embeds" in embeds else 0)
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        logits, cache = model.prefill(prompts, max_len=s + gen_len, **embeds)
        model.decode_step(cache, logits[:, -1].argmax(-1, keepdim=True), s)
    del logits, cache
    out: dict = {}
    for kernel, i, what in calls:
        args, kw = seen[(kernel, i)]
        if kernel == "flash_prefill":
            q, k, v = args
            causal = kw["causal"]
            b, sq, hq, dh = q.shape
            skv, hkv = k.shape[1], k.shape[2]
            got = flash_prefill(q, k, v, **kw)
            err = _attn_close(got, ref.flash_prefill_ref(q, k, v, **kw),
                              f"{phase} flash_prefill on {what}")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            _attn_close(got, lib().transpose(1, 2), f"{phase} flash_prefill "
                        f"on {what} against scaled_dot_product_attention")
            times = [event_ms(fn, 5) for fn in (
                lambda: flash_prefill(q, k, v, **kw),
                lambda: ref.flash_prefill_ref(q, k, v, **kw), lib)]
            pairs = sq * (sq + 1) // 2 if causal else sq * skv
            flop = 4 * b * hq * dh * pairs
            nbytes = q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel())
            shape = (f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} Dh={dh} "
                     f"{str(q.dtype)[6:]} causal={causal}")
        else:
            q, k, v, n = args
            b, hq, dh = q.shape
            hkv, sbuf = k.shape[1], k.shape[2]
            expect(n == sbuf, f"{phase} the cross decode reads {n} of "
                   f"{sbuf} slots")
            got = decode_attention(q, k, v, n, **kw)
            err = _attn_close(got, ref.decode_attention_ref(q, k, v, n, **kw),
                              f"{phase} decode_attention on {what}")
            q4 = q.unsqueeze(2)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k, v, enable_gqa=True)
            _attn_close(got, lib().squeeze(2), f"{phase} decode_attention "
                        f"on {what} against scaled_dot_product_attention")
            times = [device_ms(fn, 100) for fn in (
                lambda: decode_attention(q, k, v, n, **kw),
                lambda: ref.decode_attention_ref(q, k, v, n, **kw), lib)]
            flop = 4 * b * hq * n * dh
            nbytes = q.element_size() * (2 * b * hkv * n * dh + 2 * q.numel())
            shape = (f"B={b} Hq={hq} Hkv={hkv} Sm={sbuf} n_valid={n} Dh={dh} "
                     f"{str(q.dtype)[6:]} (device time)")
        rec = make_record(f"{phase} {model.cfg.name}", kernel, "", "",
                          shape, *times, nbytes, flop,
                          BF16_TENSOR_OPS_PER_S, err)
        out.setdefault(kernel, []).append(
            {"arch": model.cfg.name, "call": what, "flop": flop,
             "bytes": nbytes, **{
                 f: rec[f] for f in ("shape", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "max_abs_err")}})
    return out


def serve_stub(dev, tag, arch, layers, total):
    """Phase 19 (a)-(c): ``arch`` served at full width in bf16 like phase
    7 (``serve_at_width``: batch 8, 2048-token prompts, 32 greedy tokens,
    after the stub's embeddings), its parameter count held to
    STUB_PARAMS, (d) its attention calls of STUB_KERNEL_CALLS held and
    timed, and its prefill and decode steps profiled by kernel group.
    Returns phase 19 (d)'s records."""
    import torch

    phase = f"phase 19 {tag}"
    model, prompts, res, counts, embeds = serve_at_width(
        dev, arch, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, phase,
        layers=layers)
    for k in ("flash_prefill", "decode_attention"):
        total[k] += counts[k]
    cfg = model.cfg
    expect(model.param_count() == STUB_PARAMS[arch], f"{phase} {arch} has "
           f"{model.param_count()} parameters, not {STUB_PARAMS[arch]}")
    if layers:
        log(f"{phase} {arch} cut to {layers} decoder layers (all widths "
            f"kept): the whole model does not fit one card's memory; "
            f"active params a token {model.active_param_count()} of "
            f"{model.param_count()} ({cfg.moe_top_k} of "
            f"{cfg.padded_experts} experts + the shared one)")
    out = stub_kernel_cases(model, prompts, embeds, SERVE_GEN,
                            STUB_KERNEL_CALLS.get(arch, ()), phase + " (d)")
    ops = {"aten::bmm": "expert products (aten::bmm)"} \
        if cfg.moe_experts else None
    profile_serving(model, prompts, res.prefill_s,
                    res.decode_s / (SERVE_GEN - 1), phase=phase, ops=ops,
                    embeds=embeds)
    del model, res, prompts, embeds
    torch.cuda.empty_cache()
    return out


def stub_card_vs_cpu(dev):
    """Phase 19 (e): the three reduced models in f32 on the same weights
    and stub embeddings, card against CPU (``greedy_card_vs_cpu``): a
    prefill and 8 greedy steps with equal ids and logits within 1e-4
    (llama4-scout's router near-ties excused as phase 18's are); then one
    train step of reduced seamless and llava (phase 16 (c)'s bounds)."""
    from repro_torch.launch.serve import random_embeds
    from repro_torch.models.arch import get_arch

    for arch in STUB_CMP:
        cfg = get_arch(arch).reduced()
        worst, drops, gap, ties = greedy_card_vs_cpu(
            dev, cfg, arch, "phase 19 (e)", 1e-4, embeds=random_embeds)
        log(f"phase 19 (e) {arch} card == CPU over a prefill + "
            f"{MOE_CMP_STEPS} greedy steps (f32, batch {MOE_CMP_BATCH}, "
            f"prompt {MOE_CMP_PROMPT}, P {cfg.modality_tokens}, "
            f"{cfg.n_layers} + {cfg.encoder_layers} encoder layers, "
            f"d_model {cfg.d_model}): max |logit error| {worst} (bound "
            f"1e-4); prefill drops {drops}; smallest router top-k gap "
            f"{gap}; near-ties {ties}")
    for arch in STUB_TRAIN:
        train_card_vs_cpu(dev, arch, STUB_TRAIN_CMP, "phase 19 (e)")


def stub_serving(dev, total):
    """Phase 19: (a) llava-next-mistral-7b and (b) seamless-m4t-large-v2 at
    full size, (c) llama4-scout-17b-a16e at full width cut to 8 layers,
    each in bf16 with (d) the new attention routes held on their own
    operands; (e) the reduced models card against CPU. Returns (d)'s
    records by kernel."""
    t0 = time.perf_counter()
    records: dict = {}
    parts = []
    for tag, arch, layers in STUB_SERVE:
        t = time.perf_counter()
        for k, recs in serve_stub(dev, tag, arch, layers, total).items():
            records.setdefault(k, []).extend(recs)
        parts.append(f"{tag} {time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    stub_card_vs_cpu(dev)
    parts.append(f"(e) {time.perf_counter() - t:.1f}")
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s ({', '.join(parts)})")
    return records


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


# ---------------------------------------------------------------------------
# Phase 20: the LM mesh
# ---------------------------------------------------------------------------

#: (a): over a one-rank NCCL mesh at phase 7's shape
MESH_ONE = (SERVE_ARCH, MOE_ARCH)
#: (b): llama4-scout at full width, its decoder cut to 2 layers, in bf16
MESH_SCOUT, MESH_SCOUT_LAYERS = "llama4-scout-17b-a16e", 2
MESH_SCOUT_BATCH, MESH_SCOUT_PROMPT, MESH_SCOUT_STEPS = 2, 256, 8
MESH_RANKS, MESH_SHAPES = 4, ((1, 4), (2, 2))
#: (b): a card rank's bf16 logits within this many bf16 ulps (2^-8) of
#: the largest logit of the mesh-less card run: the row-parallel partial
#: products are rounded to bf16 before their all-reduce sums them
MESH_BF16_ULPS = 16
#: (b): a router top-k gap within one bf16 ulp of a probability of 1
#: (2^-8) is a near-tie in bf16 (ROUTER_TIE is f32's): a route that parts
#: from the mesh-less run's must part there (phase 18 (c)'s rule). The
#: first partings seen sat at gaps of 8.4e-5 to 1.8e-3 (PERF.md §6)
MESH_ROUTER_TIE = 2.0 ** -8
#: (b): at most this many of the scout's 9 steps may be excused (two were,
#: over each mesh, in every run that reached the check)
MESH_MAX_EXCUSED = 2
#: (b): reduced models in f32, card ranks against CPU ranks
MESH_REDUCED = (("qwen2-moe", MOE_ARCH, {}, {}),
                ("jamba", "jamba-1.5-large-398b", {}, {}),
                # n_kv_heads % 4 != 0: over (1, 4) each rank keeps the K/V
                # head its Q head reads
                ("granite kv2", SERVE_ARCH, {"n_kv_heads": 2}, {}),
                ("qwen2-moe ep2d cap 64", MOE_ARCH,
                 {"moe_capacity_factor": 64.0}, {"ep2d": True}))
#: (b): (batch, prompt, steps) of the reduced runs and the models each
#: runs: phase 18 (c)'s shape, where the tolerances were set, and jamba
#: at 4 x 64 x 8, where its card ranks read 1.014e-3 from the CPU ranks
#: (PERF.md §6); each shape draws every model's prompts in turn
MESH_REDUCED_SHAPES = (
    ((MOE_CMP_BATCH, MOE_CMP_PROMPT, MOE_CMP_STEPS),
     tuple(name for name, *_ in MESH_REDUCED)),
    ((4, 64, 8), ("jamba",)))
#: (b): card ranks against CPU ranks, max |logit difference| (1e-4 for
#: the others). Jamba's is rounding, not a fault (``mesh_drift``, PERF.md
#: §6): with its Mamba2 mixers in f64 the sharded first mixer equals
#: the mesh-less one; in f32 a card rank's narrower GEMMs round otherwise
#: than the whole ones, so the card ranks sit from the mesh-less card run
#: about as far as that run sits from the CPU (4.6e-4 and 5.3e-4 at
#: 4 x 64 x 8), and the two add. The bound is twice the largest mesh-less
#: card - CPU reading of reduced jamba, 7.5e-4 (at 2 x 128 x 8; 5.3e-4
#: at 4 x 64 x 8, 2.0e-4 at 2 x 40 x 8)
MESH_REDUCED_ATOL = {"jamba": 2 * 7.5e-4}
#: (c): reduced stablelm-3b, f32, two ranks
MESH_TRAIN_SHAPES = ((2, 1), (1, 2))
MESH_TRAIN = dict(batch=4, seq=128, steps=3, warmup=1, lr=1e-3)
#: (e): the compressed collectives' operand, one row a rank
MESH_GRAD_N = 1 << 16


def mesh_greedy(model, prompts, emb, steps, forced=None, ref=None,
                trace=False):
    """A prefill and ``steps`` greedy decode steps of ``model`` on the
    global batch ``prompts`` (on a mesh the model runs its rows and each
    step's ids are gathered for the next): (logits of each step
    (steps + 1, B, V) f32 on the host, argmax ids (B, steps + 1), dropped
    assignments over the run, and with ``trace`` or ``ref`` a record).
    Each step feeds ``forced[:, i]`` when given (both runs of a
    comparison step on the same tokens), else its own argmax.

    ``trace``: the record holds each step's MoE routes (every token's
    experts sorted (T, k), its top-k gap (T,), whether the capacity kept
    each of its assignments (T, k), the tokens of a row being S apart)
    and the cache after it, on the host. ``ref`` (such a record of a
    mesh-less run, the whole batch) applies phase 18 (c)'s rule: a step
    whose routes part from the reference's is excused when every token
    of the first MoE call that parts sits at a router near-tie (a top-k
    gap within MESH_ROUTER_TIE; later calls' partings may follow from
    it), and the rank then takes the reference's cache (its rows and
    heads) before the next step. The record lists each excused step, its
    first partings and the rows whose routes or kept assignments part in
    any of its calls."""
    import torch
    from repro_torch.models.layers import moe_capacity, moe_slots

    sh = model.shard
    b = prompts.shape[0]
    batch = model.batch_shard(b)
    axes = () if batch is None else batch.axes

    def whole(x, dim=0):
        return sh.batch_cat(x, axes, dim) if axes else x

    dropped, calls = [], []

    def on_moe(m, args, kwargs, out):
        x = args[0]
        decode = kwargs.get("decode", False)
        dropped.append(m.dropped(x, decode, kwargs.get("batch")))
        if trace or ref is not None:
            expect(m._branch(decode) in ("single", "ep"), "a traced MoE "
                   "call takes the expert-parallel branch")
            t, e = x.shape[0] * x.shape[1], m.cfg.padded_experts
            _, ids, probs = m.route(x.reshape(t, -1))
            top = torch.topk(probs, m.cfg.moe_top_k + 1, dim=-1).values
            gap = top[:, -2] - top[:, -1]
            cap = moe_capacity(m.cfg, t, e)
            kept = (moe_slots(ids, e, cap)[0] < e * cap).view(t, -1)
            order = ids.sort(-1)
            kept = kept.gather(1, order.indices)
            calls.append((len(calls), whole(order.values).cpu(),
                          whole(gap).cpu(), whole(kept).cpu(), x.shape[1]))

    hooks = [blk.ff.register_forward_hook(on_moe, with_kwargs=True)
             for blk in model.layers if blk.spec.ff == "moe"]
    s = prompts.shape[1] + (emb["modal_embeds"].shape[1]
                            if "modal_embeds" in emb else 0)
    record = {"routes": [], "caches": [], "excused": []}
    rows = slice(None) if batch is None else batch.rows

    def end_step(i, cache):
        step_calls = list(calls)
        calls.clear()
        if trace:
            record["routes"].append(step_calls)
            record["caches"].append([{k: v.cpu() for k, v in c.items()}
                                     for c in cache])
        if ref is None:
            return cache
        want = ref["routes"][i]
        expect(len(want) == len(step_calls), f"step {i}: "
               f"{len(step_calls)} MoE calls, the reference {len(want)}")
        first, parted_rows = [], set()
        for (layer, ids, _, kept, per_row), (_, wids, wgap, wkept, _) in \
                zip(step_calls, want):
            # a kept assignment differs only where the call's routes do
            routed = (ids != wids).any(-1)
            tokens = (routed | (kept != wkept).any(-1)).nonzero().flatten()
            parted_rows |= {t // per_row for t in tokens.tolist()}
            if routed.any() and not first:   # the first parting call
                first = [(layer, t, float(wgap[t]))
                         for t in routed.nonzero().flatten().tolist()]
        if not first:
            return cache
        expect(all(g <= MESH_ROUTER_TIE for _, _, g in first), f"step {i}: "
               f"routes part from the reference's away from a near-tie: "
               f"(call, token, top-k gap) {first[:8]} (tie "
               f"{MESH_ROUTER_TIE})")
        record["excused"].append((i, first, sorted(parted_rows)))
        return [_rank_cache(model, c, rows) for c in ref["caches"][i]]

    logits, cache = model.prefill(prompts, max_len=s + steps, **emb)
    cache = end_step(0, cache)
    out, ids = [logits[:, -1].float()], []
    for i in range(steps + 1):
        ids.append(whole(logits[:, -1].argmax(-1, keepdim=True)))
        if i < steps:
            tok = ids[-1] if forced is None else forced[:, i:i + 1]
            logits, cache = model.decode_step(cache, tok, s + i)
            cache = end_step(i + 1, cache)
            out.append(logits[:, -1].float())
    for h in hooks:
        h.remove()
    lg, ids = whole(torch.stack(out), 1), torch.cat(ids, 1)
    drops = int(sum(dropped)) if dropped else 0
    if trace or ref is not None:
        return lg.cpu(), ids.cpu(), drops, record
    return lg.cpu(), ids.cpu(), drops


def _rank_cache(model, layer_cache, rows):
    """A mesh-less run's cache entry of one layer (host tensors) as this
    rank holds it: its batch rows and its K/V heads (or SSM channels)."""
    sh, dev = model.shard, model.device
    out = {}
    for k, v in layer_cache.items():
        v = v[rows]
        if sh is not None and k in ("k", "v", "xk", "xv") and sh.msize > 1:
            hkv = model.layers[0].mixer.hkv_loc
            if v.shape[2] != hkv:
                v = v[:, :, sh.mrank * hkv:(sh.mrank + 1) * hkv]
        out[k] = v.to(dev).contiguous()
    return out


def lm_mesh_one_rank(dev, total):
    """(a) granite-8b and qwen2-moe-a2.7b at full width in bf16 at phase
    7's shape, mesh-less and over a one-rank NCCL mesh (qwen2-moe through
    the expert-parallel branch: the model axis divides its experts): ids
    and every step's logits equal bit for bit (a one-rank all-reduce adds
    nothing); launches counted by kind; prefill and decode tok/s of each."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import build, random_embeds, random_prompts

    mesh = make_host_mesh(1, 1, device=dev)
    b, s, n = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    for arch in MESH_ONE:
        runs = {}
        for where in ("mesh-less", "(1, 1) mesh"):
            torch.cuda.empty_cache()
            model = build(arch, seed=0, device=dev, dtype=torch.bfloat16,
                          mesh=None if where == "mesh-less" else mesh)
            prompts = random_prompts(model, b, s)
            emb = random_embeds(model, b, s)
            mesh_greedy(model, prompts[:, :64], {}, 1)       # warm-up
            walls = []
            for _ in range(2):   # the second run's wall: both warm
                sync()
                t0 = time.perf_counter()
                (lg, ids, drops), counts = counted(total, lambda: mesh_greedy(
                    model, prompts, emb, n - 1))
                sync()
                walls.append(time.perf_counter() - t0)
            runs[where] = (lg, ids, drops, counts, walls[-1])
            if where != "mesh-less":
                moe = [blk.ff for blk in model.layers
                       if blk.spec.ff == "moe"]
                expect(all(m.use_ep for m in moe), f"phase 20 (a) {arch}: "
                       f"the MoE did not take the expert-parallel branch")
            del model
        (la, ia, da, ca, ta), (lb, ib, db, cb, tb) = runs.values()
        expect(torch.equal(ia, ib), f"phase 20 (a) {arch}: the one-rank "
               f"mesh's ids differ from the mesh-less run's")
        expect(torch.equal(la, lb), f"phase 20 (a) {arch}: the one-rank "
               f"mesh's logits differ from the mesh-less run's (max "
               f"{float((la - lb).abs().max())})")
        expect(da == db, f"phase 20 (a) {arch}: drops {da} vs {db}")
        for k in ("flash_prefill", "decode_attention"):
            expect(cb[k] > 0 and cb[k] == ca[k], f"phase 20 (a) {arch}: "
                   f"{k} launched {cb[k]} times over the mesh, {ca[k]} "
                   f"without")
        log(f"phase 20 (a) {arch} full width bf16 batch={b} prompt={s} "
            f"gen={n}: one-rank NCCL mesh == mesh-less, ids and logits bit "
            f"for bit; dropped={db}; wall s (prefill + {n - 1} decode "
            f"steps) mesh-less {ta:.4f} mesh {tb:.4f}; launches mesh="
            f"{json.dumps(cb)}")
        del runs
    import torch.distributed as dist

    dist.destroy_process_group()


def _reduced_cfg(arch, repl):
    import dataclasses

    from repro_torch.models.arch import get_arch

    return dataclasses.replace(get_arch(arch).reduced(), **repl)


def _mesh_serve_rank(rank, world, store, out_dir, dev, plan):
    """One rank of (b) and (e) on ``dev`` (cuda:0 for every rank, gloo on
    CUDA tensors; or the CPU), by ``plan`` (the configs and sizes, so a
    rank needs no registry): the scout over each of its shapes on the
    tokens of the mesh-less run (when ``plan["scout"]``), the reduced
    models, and the compressed collectives; writes its results and launch
    counts."""
    import contextlib
    import pickle

    import torch
    from repro_torch import interop
    from repro_torch.comm import (compressed_pmean, error_feedback_apply,
                                  error_feedback_init, quantize_tensor)
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.mesh import (init_rank, make_host_mesh,
                                         make_trial_mesh)
    from repro_torch.launch.serve import random_embeds, random_prompts
    from repro_torch.models.transformer import Transformer

    on_card = dev.startswith("cuda")
    init_rank(rank, world, store, device=dev,
              backend=WIRE_BACKEND if on_card else "gloo")
    if not on_card:
        torch.set_num_threads(1)
    reset_launches()
    res, spied = {}, {}

    def spy(key, run):
        """``run()``; on rank 0 on the card, with the first flash_prefill
        and decode_attention call of it kept (copies) under ``key``."""
        if rank or not on_card:
            return run()
        patches, seen = nth_calls({"flash_prefill": {0},
                                   "decode_attention": {0}}, clone=True)
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            out = run()
        spied[key] = seen
        return out

    if plan["scout"] is not None:
        cfg, b, s, n, forced, records = plan["scout"]
        forced = forced.to(dev)
        for shape in plan["shapes"]:
            mesh = make_host_mesh(*shape, device=dev)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            model = Transformer(cfg, device=dev, dtype=torch.bfloat16,
                                generator=torch.Generator(device=dev)
                                .manual_seed(0), mesh=mesh)
            held = sum(p.numel() for p in model.parameters())
            # the bytes the parameters' storages hold, beside their own:
            # a slice that kept its full leaf's storage alive shows here
            stored = (sum({p.untyped_storage().data_ptr():
                           p.untyped_storage().nbytes()
                           for p in model.parameters()}.values()),
                      sum(p.numel() * p.element_size()
                          for p in model.parameters()))
            t0 = time.perf_counter()
            lg, ids, drops, record = spy(("scout", shape), lambda: mesh_greedy(
                model, random_prompts(model, b, s), random_embeds(
                    model, b, s), n, forced, ref=records[shape[0]]))
            if on_card:
                torch.cuda.synchronize()
            res["scout", shape] = (
                lg, ids, drops, held, model.param_count(),
                time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() if on_card else 0,
                record["excused"], stored)
            del model
    for name, cfg, layout, rshape, prompts in _reduced_runs(plan):
        prompts = prompts.to(dev)
        # the same f32 weights on the card and the CPU: drawn on the CPU
        tree = interop.lm_params_to_numpy(Transformer(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
        for shape in plan["shapes"]:
            if layout.get("ep2d") and shape[0] == 1:
                continue
            mesh = make_host_mesh(*shape, device=dev)
            model = interop.lm_params_from_numpy(cfg, tree, device=dev,
                                                 mesh=mesh, **layout)
            res[name, shape, rshape] = spy(
                (name, shape, rshape),
                lambda: mesh_greedy(model, prompts, {}, rshape[2]))
            del model
    data = make_trial_mesh(world, device=dev)
    g = torch.from_numpy(plan["grads"][rank]).to(dev)
    group = data.get_group("data")
    codes, _ = quantize_tensor(g, 4)
    pm = compressed_pmean(g, group, 6)
    ef = error_feedback_init({"g": torch.zeros_like(g)})
    acc = torch.zeros_like(g)
    for _ in range(8):
        got, ef = error_feedback_apply({"g": g}, ef, group, 3)
        acc += got["g"]
    one, _ = error_feedback_apply({"g": g}, {"g": torch.zeros_like(g)},
                                  group, 3)
    res["compressed"] = (codes.cpu(), pm.cpu(), (acc / 8).cpu(),
                         one["g"].cpu())
    counts = launches()     # before the checks below launch the kernels
    res["attention"] = {key: _attention_on_operands(seen)
                        for key, seen in spied.items()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((res, counts), f)
    torch.distributed.destroy_process_group()


def _attention_on_operands(seen):
    """``flash_prefill`` and ``decode_attention`` on the operands
    ``nth_calls`` kept, held to their plain versions (``_attn_close``):
    {kernel: (the operands' shapes, max |kernel - plain|)}."""
    from repro_torch.kernels import decode_attention, flash_prefill, ref

    out = {}
    (q, k, v), kw = seen[("flash_prefill", 0)]
    err = _attn_close(flash_prefill(q, k, v, **kw),
                      ref.flash_prefill_ref(q, k, v, **kw),
                      f"phase 20 (b) flash_prefill on a rank's heads")
    out["flash_prefill"] = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} "
                            f"{q.dtype} {kw}", err)
    (q, k, v, n_valid), kw = seen[("decode_attention", 0)]
    err = _attn_close(decode_attention(q, k, v, n_valid, **kw),
                      ref.decode_attention_ref(q, k, v, n_valid, **kw),
                      f"phase 20 (b) decode_attention on a rank's heads")
    out["decode_attention"] = (f"q {tuple(q.shape)}, cache "
                               f"{tuple(k.shape)} {k.dtype}, n_valid "
                               f"{n_valid}", err)
    return out


def _reduced_runs(plan):
    """[(name, cfg, layout, (batch, prompt, steps), prompts)] of the
    reduced runs: each shape of ``plan["reduced_shapes"]`` draws every
    model's prompts in turn from a generator seeded 7 (phase 18 (c)'s
    draws at its shape) and runs the models it names."""
    import torch

    out = []
    for shape, names in plan["reduced_shapes"]:
        gen = torch.Generator().manual_seed(7)
        for name, cfg, layout in plan["reduced"]:
            prompts = torch.randint(0, cfg.vocab, shape[:2], generator=gen)
            if name in names:
                out.append((name, cfg, layout, shape, prompts))
    return out


def _reduced_alone(dev, plan):
    """{(name, shape): max |logit| difference of the mesh-less card and
    CPU runs} of the reduced runs on the ranks' weights and prompts."""
    import torch
    from repro_torch import interop
    from repro_torch.models.transformer import Transformer

    out = {}
    for name, cfg, _, shape, prompts in _reduced_runs(plan):
        n = shape[2]
        cpu = Transformer(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        card = interop.lm_params_from_numpy(
            cfg, interop.lm_params_to_numpy(cpu), device=dev)
        lg_h, _, _ = mesh_greedy(cpu, prompts, {}, n)
        lg_c, _, _ = mesh_greedy(card, prompts.to(dev), {}, n,
                                 lg_h.argmax(-1).t()[:, :n].to(dev))
        out[name, shape] = float((lg_c - lg_h)[..., :cfg.vocab].abs().max())
    return out


#: shapes (batch, prompt, steps) of :func:`mesh_noise`'s readings, longer
#: than phase 20 (b)'s reduced runs (ROADMAP §3)
MESH_NOISE_SHAPES = ((2, 128, 8), (4, 64, 8))


def mesh_noise(shapes=MESH_NOISE_SHAPES, dev="cuda"):
    """Reduced jamba in f32 at each of ``shapes``, its prompts drawn after
    qwen2-moe's as phase 20 (b) draws them: max |logit difference| (real
    vocabulary, every step) of the card and the CPU without a mesh; of
    MESH_RANKS gloo ranks on the card and on the CPU over each of
    MESH_SHAPES; and over (1, 4) (no data shards: the mesh-less math in
    another order of sums) of the ranks and the mesh-less run on one
    device. A reading beside phase 20 (b)'s check, which holds the ranks
    at phase 18 (c)'s shape. On a card:

      python3 -c 'import chip_smoke as c; c.mesh_noise()'
    """
    import subprocess

    import torch
    from repro_torch import interop
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Transformer

    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build_all()
    names = ("qwen2-moe", "jamba")
    reduced = [(n, _reduced_cfg(a, r), lay) for n, a, r, lay in MESH_REDUCED
               if n in names]
    work = os.path.join(ROOT, "build", "chip_smoke_noise")
    for shape in shapes:
        t0 = time.perf_counter()
        plan = {"shapes": MESH_SHAPES, "grads": _mesh_grads(),
                "reduced_shapes": ((shape, names),), "reduced": reduced,
                "scout": None}
        gen = torch.Generator().manual_seed(7)
        b, s, n = shape
        alone = {}
        for name, cfg, _ in reduced:
            prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen)
            cpu = Transformer(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
            card = interop.lm_params_from_numpy(
                cfg, interop.lm_params_to_numpy(cpu), device=dev)
            lg = mesh_greedy(cpu, prompts, {}, n)[0]
            alone[name] = (lg, mesh_greedy(
                card, prompts.to(dev), {}, n,
                lg.argmax(-1).t()[:, :n].to(dev))[0])
        ranks = {where: _spawn_ranks(_mesh_serve_rank, MESH_RANKS,
                                     os.path.join(work, where), rank_dev,
                                     plan)
                 for where, rank_dev in (
                     ("card", "cuda:0" if dev == "cuda" else "cpu"),
                     ("cpu", "cpu"))}
        v = reduced[1][1].vocab

        def diff(a, b):
            return float((a - b)[..., :v].abs().max())

        host, card = alone["jamba"]
        row = {"shape": shape, "mesh-less card - cpu": diff(card, host)}
        for mesh in MESH_SHAPES:
            got = {w: r[0][0]["jamba", mesh, shape]
                   for w, r in ranks.items()}
            row[f"{mesh} card - cpu"] = diff(got["card"][0], got["cpu"][0])
            row[f"{mesh} ids equal"] = bool(torch.equal(got["card"][1],
                                                        got["cpu"][1]))
            if mesh[0] == 1:
                row[f"{mesh} card ranks - mesh-less card"] = diff(
                    got["card"][0], card)
                row[f"{mesh} cpu ranks - mesh-less cpu"] = diff(
                    got["cpu"][0], host)
        row["s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


class _F64Torch:
    """``torch`` with ``float32`` read as ``float64``: the globals of
    :func:`mamba_in_f64`'s copies of the Mamba2 code."""

    def __getattr__(self, name):
        import torch

        return getattr(torch, "float64" if name == "float32" else name)


def mamba_in_f64(model):
    """Run ``model``'s Mamba2 mixers in f64: their weights cast, and their
    methods (and the scan, the conv and the norm they call) rebound to
    copies whose ``torch.float32`` is f64; a mixer takes its input in
    f64 and returns its output in the input's dtype (its cache stays
    f64). The other layers are unchanged."""
    import types

    import torch
    from repro_torch.models import layers

    g = dict(vars(layers), torch=_F64Torch())
    for name in ("ssd_scan", "causal_conv", "rmsnorm", "_rmsnorm"):
        fn = vars(layers)[name]
        g[name] = types.FunctionType(fn.__code__, g, name, fn.__defaults__,
                                     fn.__closure__)

    def rebound(m, name):
        fn = getattr(layers.Mamba2, name)
        return types.MethodType(types.FunctionType(
            fn.__code__, g, name, fn.__defaults__, fn.__closure__), m)

    for blk in model.layers:
        if blk.spec.mixer != "mamba":
            continue
        m = blk.mixer.to(torch.float64)
        for name in ("_split", "_norm", "_out"):
            setattr(m, name, rebound(m, name))
        fwd, dec = rebound(m, "forward"), rebound(m, "decode")

        def forward(x, fwd=fwd):
            out, cache = fwd(x.to(torch.float64))
            return out.to(x.dtype), cache

        def decode(x, cache, dec=dec):
            return dec(x.to(torch.float64), cache).to(x.dtype)

        m.forward, m.decode = forward, decode
    return model


def block_outputs(model, prompts, forced, steps):
    """A prefill of ``prompts`` and ``steps`` decode steps on ``forced``'s
    tokens (B, steps): each layer's mixer output and block output at each
    step ((steps + 1) x layers x 2 host tensors; a (1, M) mesh holds them
    whole on every rank) and the logits (steps + 1, B, V), f32 on the
    host."""
    import torch

    rows, step = [], {}

    def keep(layer, kind, x):
        step[layer, kind] = x.detach().float().cpu()

    hooks = []
    for i, blk in enumerate(model.layers):
        for kind, mod in (("mixer", blk.mixer), ("block", blk)):
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, i=i, kind=kind: keep(i, kind, out[0])))

            def decode(*a, i=i, kind=kind, dec=mod.decode, **kw):
                out = dec(*a, **kw)
                keep(i, kind, out)
                return out

            mod.decode = decode

    def end():
        rows.append([(step[i, "mixer"], step[i, "block"])
                     for i in range(len(model.layers))])
        step.clear()

    s = prompts.shape[1]
    logits, cache = model.prefill(prompts, max_len=s + steps)
    out = [logits[:, -1].float()]
    end()
    for i in range(steps):
        logits, cache = model.decode_step(cache, forced[:, i:i + 1], s + i)
        out.append(logits[:, -1].float())
        end()
    for h in hooks:
        h.remove()
    return rows, torch.stack(out).cpu()


def _drift_rank(rank, world, store, out_dir, dev, plan):
    """One rank of :func:`mesh_drift`: reduced jamba over a (1, world)
    mesh on ``plan``'s weights and tokens, f32 and with its Mamba2 mixers
    in f64; rank 0 writes both runs' block outputs."""
    import pickle

    import torch
    from repro_torch import interop
    from repro_torch.launch.mesh import init_rank, make_host_mesh

    on_card = dev.startswith("cuda")
    init_rank(rank, world, store, device=dev,
              backend=WIRE_BACKEND if on_card else "gloo")
    if not on_card:
        torch.set_num_threads(1)
    mesh = make_host_mesh(1, world, device=dev)
    res = {}
    with torch.no_grad():
        for f64 in (False, True):
            model = interop.lm_params_from_numpy(plan["cfg"], plan["tree"],
                                                 device=dev, mesh=mesh)
            if f64:
                mamba_in_f64(model)
            res[f64] = block_outputs(model, plan["prompts"].to(dev),
                                     plan["forced"].to(dev), plan["steps"])
            del model
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((res if rank == 0 else {}, {}), f)
    torch.distributed.destroy_process_group()


def mesh_drift(shape=(4, 64, 8), dev="cuda"):
    """Where reduced jamba's drift over a (1, MESH_RANKS) mesh starts: at
    ``shape`` (batch, prompt, steps; its prompts drawn as phase 20 (b)
    draws them, after qwen2-moe's), each block's output at every step on
    MESH_RANKS gloo ranks on the card and on the CPU and without a mesh
    on each, all on the mesh-less CPU run's greedy tokens; then again
    with the Mamba2 mixers in f64 (:func:`mamba_in_f64`), which tells
    rounding (the drift shrinks with the mixers' precision) from a wrong
    index or slice (it would not). Prints one JSON line per layer's mixer
    output and per block output (the largest |value| of the mesh-less CPU
    run, and the largest |difference| over steps: card ranks - mesh-less
    card, CPU ranks - mesh-less CPU, mesh-less card - CPU, card ranks -
    CPU ranks; f32 and f64 mixers), then the logits'. On a card:

      python3 -c 'import chip_smoke as c; c.mesh_drift()'
    """
    import torch
    from repro_torch import interop
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Transformer

    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build_all()
    t0 = time.perf_counter()
    b, s, n = shape
    gen = torch.Generator().manual_seed(7)
    torch.randint(0, _reduced_cfg(MOE_ARCH, {}).vocab, (b, s), generator=gen)
    cfg = _reduced_cfg("jamba-1.5-large-398b", {})
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    tree = interop.lm_params_to_numpy(Transformer(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    runs = {}
    with torch.no_grad():
        host = interop.lm_params_from_numpy(cfg, tree, device="cpu")
        logits, cache = host.prefill(prompts, max_len=s + n)
        tok = [logits[:, -1].argmax(-1, keepdim=True)]
        for i in range(n - 1):
            logits, cache = host.decode_step(cache, tok[-1], s + i)
            tok.append(logits[:, -1].argmax(-1, keepdim=True))
        forced = torch.cat(tok, 1)
        for where, d in (("cpu", "cpu"), ("card", dev)):
            for f64 in (False, True):
                model = interop.lm_params_from_numpy(cfg, tree, device=d)
                if f64:
                    mamba_in_f64(model)
                runs[where, "alone", f64] = block_outputs(
                    model, prompts.to(d), forced.to(d), n)
                del model
    plan = {"cfg": cfg, "tree": tree, "prompts": prompts, "forced": forced,
            "steps": n}
    work = os.path.join(ROOT, "build", "chip_smoke_drift")
    for where, d in (("card", "cuda:0" if dev == "cuda" else "cpu"),
                     ("cpu", "cpu")):
        res = _spawn_ranks(_drift_rank, MESH_RANKS,
                           os.path.join(work, where), d, plan)[0][0]
        for f64 in (False, True):
            runs[where, "ranks", f64] = res[f64]

    def diff(a, b, layer, kind):
        return max(float((x[layer][kind] - y[layer][kind]).abs().max())
                   for x, y in zip(a[0], b[0]))

    pairs = (("card ranks - card", ("card", "ranks"), ("card", "alone")),
             ("cpu ranks - cpu", ("cpu", "ranks"), ("cpu", "alone")),
             ("card - cpu", ("card", "alone"), ("cpu", "alone")),
             ("card ranks - cpu ranks", ("card", "ranks"), ("cpu", "ranks")))
    for layer, spec in enumerate(cfg.pattern * cfg.n_rep):
        for kind, what in enumerate((spec.mixer, f"block ({spec.ff})")):
            ref = runs["cpu", "alone", False][0]
            row = {"layer": layer, "out": what, "max |x|": max(
                float(r[layer][kind].abs().max()) for r in ref)}
            for f64 in (False, True):
                tag = "f64 mamba " if f64 else ""
                for name, a, c in pairs:
                    row[tag + name] = diff(runs[(*a, f64)], runs[(*c, f64)],
                                           layer, kind)
            print(json.dumps(row), flush=True)
    row = {"logits": shape}
    for f64 in (False, True):
        for name, a, c in pairs:
            row[("f64 mamba " if f64 else "") + name] = float(
                (runs[(*a, f64)][1] - runs[(*c, f64)][1])[..., :cfg.vocab]
                .abs().max())
    row["s"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)


def _mesh_grads():
    import numpy as np

    return np.random.default_rng(0).standard_normal(
        (MESH_RANKS, MESH_GRAD_N)).astype(np.float32)


def _spawn_ranks(fn, world, work, *args):
    """``world`` ranks of ``fn`` (spawned; a FileStore under ``work``):
    [(results, launches)] in rank order."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mp.spawn(fn, args=(world, os.path.join(work, "store"), work) + args,
             nprocs=world)
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(work)
    return out


def near_tie_partings(ref_logits, ids, want_ids, bound):
    """(row, step, the reference's top-2 gap) of every id that differs
    from the reference's; raises unless each gap is within ``bound``."""
    partings = []
    for r, i in (ids != want_ids).nonzero().tolist():
        top = ref_logits[i, r].topk(2).values
        gap = float(top[0] - top[1])
        expect(gap <= bound, f"an id differs at row {r} step {i} where the "
               f"reference's top-2 gap is {gap} > {bound}")
        partings.append((r, i, gap))
    return partings


def lm_mesh_ranks(dev, total):
    """(b) MESH_RANKS gloo ranks on the card: llama4-scout at full width
    cut to 2 layers in bf16 over (1, 4) and (2, 2) against the mesh-less
    card run on the same tokens (ids equal but at near-ties, logits within
    MESH_BF16_ULPS bf16 ulps of the largest logit); reduced qwen2-moe and
    jamba in f32 (and one ep2d decode) against the same ranks on the CPU
    (logits within 1e-4, jamba 1e-3, ids and drops equal). (e) on the same
    ranks: quantize_tensor's codes equal the CPU's bit for bit, and
    ``repro``'s bounds hold for compressed_pmean (rate 6) and
    error_feedback_apply (rate 3, 8 rounds)."""
    import torch
    from repro_torch.comm import quantize_tensor
    from repro_torch.launch.serve import build, random_embeds, random_prompts

    work = os.path.join(ROOT, "build", "chip_smoke_mesh")
    b, s, n = MESH_SCOUT_BATCH, MESH_SCOUT_PROMPT, MESH_SCOUT_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(MESH_SCOUT, seed=0, device=dev, dtype=torch.bfloat16,
                  layers=MESH_SCOUT_LAYERS)
    prompts, emb = random_prompts(model, b, s), random_embeds(model, b, s)
    t0 = time.perf_counter()
    ref, ref_ids, ref_drops = mesh_greedy(model, prompts, emb, n)
    sync()
    t_ref, peak_ref = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    # over D data shards the experts' capacity is per shard, by design:
    # the reference is the mesh-less model on each shard's rows, on the
    # same tokens (traced: routes and caches for the ranks)
    refs = {}
    for d in {shape[0] for shape in MESH_SHAPES}:
        k = b // d
        parts = [mesh_greedy(model, prompts[i * k:(i + 1) * k],
                             {key: v[i * k:(i + 1) * k]
                              for key, v in emb.items()}, n,
                             ref_ids[i * k:(i + 1) * k].to(dev), trace=True)
                 for i in range(d)]
        record = {"routes": [], "caches": []}
        for step in range(n + 1):
            record["routes"].append([
                (c[0][0], *(torch.cat([call[f] for call in c])
                            for f in (1, 2, 3)), c[0][4])
                for c in zip(*[p[3]["routes"][step] for p in parts])])
            record["caches"].append([
                {key: torch.cat([p[3]["caches"][step][j][key]
                                 for p in parts]) for key in c0}
                for j, c0 in enumerate(parts[0][3]["caches"][step])])
        refs[d] = (torch.cat([p[0] for p in parts], 1),
                   sum(p[2] for p in parts), record)
    full, scout_cfg = model.param_count(), model.cfg
    del model
    torch.cuda.empty_cache()
    plan = {"shapes": MESH_SHAPES, "grads": _mesh_grads(),
            "reduced_shapes": MESH_REDUCED_SHAPES,
            "reduced": [(name, _reduced_cfg(arch, repl), layout)
                        for name, arch, repl, layout in MESH_REDUCED],
            "scout": (scout_cfg, b, s, n, ref_ids,
                      {d: r[2] for d, r in refs.items()})}
    rank_dev = "cuda:0" if str(dev).startswith("cuda") else "cpu"
    t0 = time.perf_counter()
    card = _spawn_ranks(_mesh_serve_rank, MESH_RANKS,
                        os.path.join(work, "card"), rank_dev, plan)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = _spawn_ranks(_mesh_serve_rank, MESH_RANKS,
                        os.path.join(work, "cpu"), "cpu",
                        {**plan, "scout": None})
    t_host = time.perf_counter() - t0
    launches = {}
    for _, counts in card:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
            total[k] += v
    for k in ("flash_prefill", "decode_attention", "quantize_fused"):
        expect(launches[k] > 0, f"phase 20 (b) launched no {k}")
    vocab = scout_cfg.vocab
    bound = MESH_BF16_ULPS * 2.0 ** -8 * float(ref[..., :vocab].abs().max())
    for key, checked in card[0][0]["attention"].items():
        log(f"phase 20 (b) attention kernels on rank 0's first attention "
            f"layer, {key[0]} over {key[1]}, against their plain versions: "
            + "; ".join(f"{k} {shape}: max |kernel - plain| {err}"
                        for k, (shape, err) in checked.items()))
    expect(rank_dev == "cpu" or {k for k in card[0][0]["attention"]} >= {
        ("scout", shape) for shape in MESH_SHAPES} | {
        ("granite kv2", (1, 4), MESH_REDUCED_SHAPES[0][0])},
        "phase 20 (b): a run's attention "
        "operands were not checked")
    for shape in MESH_SHAPES:
        lg, ids, drops, held, params, secs, peak, excused, stored = \
            card[0][0]["scout", shape]
        expect(stored[0] == stored[1], f"phase 20 (b) scout {shape}: the "
               f"parameters' storages hold {stored[0]} bytes, the "
               f"parameters {stored[1]}")
        want, want_drops, _ = refs[shape[0]]
        for r in range(1, MESH_RANKS):
            expect(torch.equal(card[r][0]["scout", shape][1], ids),
                   f"phase 20 (b) scout {shape}: rank {r}'s ids differ")
        expect(len(excused) <= MESH_MAX_EXCUSED, f"phase 20 (b) scout "
               f"{shape}: {len(excused)} of {n + 1} steps part at router "
               f"near-ties (at most {MESH_MAX_EXCUSED})")
        # an excused step's logits are compared on the rows whose routes
        # and kept assignments did not part
        keep = torch.ones((n + 1, b), dtype=torch.bool)
        for i, _, parted in excused:
            keep[i, parted] = False
        lg, want = lg[..., :vocab], want[..., :vocab]
        err = float((lg - want).abs().amax(-1)[keep].max())
        expect(err <= bound, f"phase 20 (b) scout {shape}: logits differ "
               f"by {err} > {bound}")
        ties = near_tie_partings(want, torch.where(keep.t(), ids, want.argmax(
            -1).t()), want.argmax(-1).t(), bound)
        if excused:
            log(f"phase 20 (b) scout {shape}: steps routed differently at "
                f"router near-ties, excused (the ranks took the mesh-less "
                f"caches after them): (step, first parting tokens, their "
                f"largest top-k gap, rows parted) " + json.dumps([
                    (i, len(p), max(g for _, _, g in p), rows)
                    for i, p, rows in excused]))
        expect(params == full, f"phase 20 (b) {shape}: the mesh's model "
               f"has {params} parameters, not {full}")
        if shape == (1, 4):
            expect(held <= 0.3 * full, f"phase 20 (b) (1, 4): a rank holds "
                   f"{held} of {full} parameters")
        log(f"phase 20 (b) {MESH_SCOUT} full width, {MESH_SCOUT_LAYERS} "
            f"layers, bf16, batch={b} prompt={s} steps={n} over {shape} "
            f"({MESH_RANKS} gloo ranks on the card): max |logit - "
            f"mesh-less card| {err:.4e} (bound {bound:.4e} = "
            f"{MESH_BF16_ULPS} bf16 ulps of the largest logit); ids == "
            f"mesh-less{' but at near-ties ' + json.dumps(ties) if ties else ''}"
            f"{'' if shape[0] == 1 else ' (the mesh-less model on each data shard)'}"
            f" on {int(keep.sum())} of {(n + 1) * b} (step, row) pairs; "
            f"dropped {drops} (mesh-less {want_drops}); rank 0 holds {held} "
            f"of {params} parameters, peak_bytes {peak} (mesh-less "
            f"{peak_ref}); rank 0 wall s {secs:.4f} (mesh-less {t_ref:.4f})")
    alone = _reduced_alone(dev, plan)
    for name, _, _, _ in MESH_REDUCED:
        atol = MESH_REDUCED_ATOL.get(name, 1e-4)
        for key in [k for k in card[0][0] if k[0] == name]:
            lg, ids, drops = card[0][0][key]
            hl, hids, hdrops = host[0][0][key]
            for r in range(1, MESH_RANKS):
                expect(torch.equal(card[r][0][key][1], ids) and torch.equal(
                    host[r][0][key][1], hids), f"phase 20 (b) {key}: ranks "
                    f"disagree")
            expect(torch.equal(ids, hids), f"phase 20 (b) {key}: card ids "
                   f"differ from the CPU ranks'")
            err = float((lg - hl).abs().max())
            expect(err <= atol, f"phase 20 (b) {key}: card - CPU logits "
                   f"{err} > {atol}")
            expect(drops == hdrops, f"phase 20 (b) {key}: dropped card "
                   f"{drops} CPU {hdrops}")
            log(f"phase 20 (b) reduced {key[0]} f32 over {key[1]} at "
                f"batch x prompt x steps {key[2]}: card ranks == CPU ranks "
                f"(ids, dropped {drops}), max |logit diff| {err:.3e} "
                f"(tolerance {atol}; mesh-less card - CPU "
                f"{alone[name, key[2]]:.3e})")
    grads = _mesh_grads()
    want = grads.mean(0)
    for r, (res, _) in enumerate(card):
        codes, pm, ef, one = res["compressed"]
        expect(torch.equal(codes, quantize_tensor(
            torch.from_numpy(grads[r]), 4)[0]), f"phase 20 (e) rank {r}: "
            f"the card's codes differ from the CPU's")
    codes, pm, ef, one = card[0][0]["compressed"]
    rms = float(((pm.numpy() - want) ** 2).mean() ** 0.5
                / (want ** 2).mean() ** 0.5)
    rel = float(((ef.numpy() - want) ** 2).sum() ** 0.5
                / (want ** 2).sum() ** 0.5)
    rel1 = float(((one.numpy() - want) ** 2).sum() ** 0.5
                 / (want ** 2).sum() ** 0.5)
    expect(rms < 0.15, f"phase 20 (e) compressed_pmean error {rms}")
    expect(rel < 0.7 * rel1 and rel < 0.15, f"phase 20 (e) error feedback "
           f"{rel} vs one-shot {rel1}")
    log(f"phase 20 (e) {MESH_RANKS} gloo ranks on the card, n={MESH_GRAD_N} "
        f"a rank: quantize_tensor codes == CPU bit for bit (rate 4); "
        f"compressed_pmean rate 6 rel RMSE {rms:.4f} (< 0.15); error "
        f"feedback rate 3 x 8 rel {rel:.4f} vs one-shot {rel1:.4f}")
    log(f"phase 20 (b)+(e) spawn to end: card {t_card:.1f} s, CPU "
        f"{t_host:.1f} s; launches (card ranks)={json.dumps(launches)}")


def _mesh_train_rank(rank, world, store, out_dir, dev, c):
    """One rank of (c): reduced stablelm-3b over each of MESH_TRAIN_SHAPES
    (3 steps), the trainer's resume on (1, 2) and its checkpoint loaded on
    (2, 1)."""
    import contextlib
    import pickle

    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    from repro_torch.optim import AdamW

    on_card = dev.startswith("cuda")
    init_rank(rank, world, store, device=dev,
              backend=WIRE_BACKEND if on_card else "gloo")
    if not on_card:
        torch.set_num_threads(1)
    reset_launches()
    res = {}
    for shape in MESH_TRAIN_SHAPES:
        res[shape] = _train_steps(dev, make_host_mesh(*shape, device=dev), c)
    mesh = make_host_mesh(*MESH_TRAIN_SHAPES[1], device=dev)
    kw = dict(reduced=True, steps=4, batch=c["batch"], seq=c["seq"],
              lr=c["lr"], warmup=c["warmup"], device=dev, log_every=100,
              mesh=mesh)
    straight = ttrain.train(TRAIN_ARCH, **kw)
    ckpt = os.path.join(out_dir, "ckpt")

    def preempt(step, *_):
        if step == 1:
            raise _Preempted

    with contextlib.suppress(_Preempted):
        ttrain.train(TRAIN_ARCH, ckpt_dir=ckpt, ckpt_every=2,
                     on_step=preempt, **kw)
    resumed = ttrain.train(TRAIN_ARCH, ckpt_dir=ckpt, ckpt_every=2, **kw)
    pa = list(straight.model.named_parameters())
    pb = list(resumed.model.named_parameters())
    ma = straight.optimizer.state_tree(pa)["moments"]
    mb = resumed.optimizer.state_tree(pb)["moments"]
    res["resume"] = (resumed.start, resumed.losses == straight.losses[2:],
                     all(torch.equal(a, b) for (_, a), (_, b) in zip(pa, pb))
                     and all(torch.equal(ma[m][k], mb[m][k])
                             for m in ma for k in ma[m]))
    other = make_host_mesh(*MESH_TRAIN_SHAPES[0], device=dev)
    model = type(straight.model)(straight.model.cfg, device=dev, mesh=other,
                                 fsdp=True)
    opt = AdamW(model.parameters())
    ttrain.restore(model, opt, ckpt, 2)
    named = list(model.named_parameters())
    moved = {f"params/{k}": v.cpu() for k, v in
             model.full_named(dict(named)).items()}
    for m, t in opt.state_tree(named)["moments"].items():
        moved.update({f"opt/moments/{m}/{k}": v.cpu()
                      for k, v in model.full_named(t).items()})
    res["moved"] = (opt.step_count, len(moved), _saved_equal(
        os.path.join(ckpt, "step_00000002.npz"), moved))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((res, launches()), f)
    torch.distributed.destroy_process_group()


def _saved_equal(path, leaves) -> bool:
    """Whether every leaf of ``leaves`` ({checkpoint key: tensor}) equals
    the one the checkpoint at ``path`` holds, bit for bit."""
    import numpy as np
    import torch

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        saved = {rec["key"]: (z[f"leaf_{i}"], rec["dtype"])
                 for i, rec in enumerate(meta["leaves"])}
    for key, t in leaves.items():
        arr, dtype = saved[key]
        if dtype == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            arr = torch.from_numpy(arr)
        if not torch.equal(arr, t):
            return False
    return True


def _train_steps(dev, mesh, c):
    """``c``'s (MESH_TRAIN's) steps of reduced stablelm-3b from seed-0
    weights (on ``mesh`` if given, FSDP'd as the trainer does): (per-step
    metrics, the initial and the final full parameters on the host)."""
    import torch
    from repro_torch.data import TokenStream, token_batches
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamW, linear_warmup_cosine

    cfg = get_arch(TRAIN_ARCH).reduced()
    model = Transformer(cfg, device=dev, mesh=mesh, fsdp=mesh is not None,
                        generator=torch.Generator(device=dev).manual_seed(0))

    def full():
        return {k: v.detach().cpu().clone() for k, v in model.full_named(
            dict(model.named_parameters())).items()}

    init = full()
    model.requires_grad_(True)
    opt = AdamW(model.parameters())
    step = make_train_step(cfg, InputShape("cli", "train", c["seq"],
                                           c["batch"]),
                           linear_warmup_cosine(c["lr"], c["warmup"],
                                                c["steps"]))
    stream = TokenStream(cfg.vocab, c["seq"], c["batch"], seed=0)
    metrics = [{k: float(v) for k, v in step(model, opt, b).items()}
               for b in token_batches(stream, device=dev, stop=c["steps"])]
    return metrics, init, full()


def lm_mesh_train(dev, total):
    """(c) two gloo ranks on the card: reduced stablelm-3b's 3 steps over
    (2, 1) and (1, 2) held to the mesh-less card steps by phase 16 (c)'s
    rule (loss and grad norm within TRAIN_RTOL, each parameter's
    difference within TRAIN_PARAM_REL of its update's norm); the trainer's
    resume on (1, 2) equal to its straight run bit for bit; its step-2
    checkpoint, saved on (1, 2), loaded on (2, 1) gives back the saved
    leaves bit for bit."""
    import torch

    work = os.path.join(ROOT, "build", "chip_smoke_mesh_train")
    alone, init, final = _train_steps(dev, None, MESH_TRAIN)
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_mesh_train_rank, 2, work,
                         "cuda:0" if str(dev).startswith("cuda") else "cpu",
                         MESH_TRAIN)
    secs = time.perf_counter() - t0
    for _, counts in ranks:
        for k, v in counts.items():
            total[k] += v
    res = ranks[0][0]
    for shape in MESH_TRAIN_SHAPES:
        metrics, init_m, final_m = res[shape]
        for i, (a, b) in enumerate(zip(metrics, alone)):
            expect(a["lr"] == b["lr"], f"phase 20 (c) {shape} step {i}: lr")
            for k in ("loss", "grad_norm"):
                expect(abs(a[k] - b[k]) <= TRAIN_RTOL * abs(b[k]),
                       f"phase 20 (c) {shape} step {i}: {k} mesh {a[k]} "
                       f"mesh-less {b[k]}")
        worst = 0.0
        for name, w in final.items():
            expect(torch.equal(init_m[name], init[name]), f"phase 20 (c) "
                   f"{shape}: the sharded init of {name} is not the full "
                   f"init's slice")
            upd = (w - init[name]).norm().clamp_min(1e-30)
            rel = float((final_m[name] - w).norm() / upd)
            worst = max(worst, rel)
            expect(rel <= TRAIN_PARAM_REL, f"phase 20 (c) {shape} {name}: "
                   f"mesh - mesh-less is {rel} of the update's norm")
        log(f"phase 20 (c) reduced {TRAIN_ARCH} f32 over {shape} (2 gloo "
            f"ranks on the card), {MESH_TRAIN['steps']} steps: losses "
            f"{[m['loss'] for m in metrics]} (mesh-less "
            f"{[m['loss'] for m in alone]}); worst |mesh - mesh-less| / "
            f"|update| {worst:.3e} (tolerance {TRAIN_PARAM_REL})")
    start, same_losses, same_state = res["resume"]
    expect(start == 2 and same_losses and same_state, "phase 20 (c): the "
           "resumed run on (1, 2) is not the straight run bit for bit")
    count, n_leaves, equal = res["moved"]
    expect(count == 2 and equal, "phase 20 (c): the checkpoint saved on "
           "(1, 2) and loaded on (2, 1) does not give back its leaves")
    log(f"phase 20 (c) resume on (1, 2) == straight bit for bit; the "
        f"step-2 checkpoint saved on (1, 2) and loaded on (2, 1) gives "
        f"back its {n_leaves} parameter and moment leaves bit for bit; "
        f"spawn to end {secs:.1f} s")


def mesh_server(dev, total, workdir):
    """(d) the structure server with ``use_mesh=True`` (a one-card tenant
    mesh) on phase 11's sign trace: states equal the mesh-less server's
    bit for bit."""
    import shutil

    from repro_torch.serve import (ServeConfig, StructureServer,
                                   TrafficConfig, make_trace)

    shutil.rmtree(workdir, ignore_errors=True)
    trace = make_trace(TrafficConfig(**CRASH_TRAFFIC))
    srv = {}
    for mesh in (False, True):
        srv[mesh] = StructureServer(ServeConfig(**CRASH_SERVE,
                                                use_mesh=mesh),
                                    os.path.join(workdir, str(mesh)))
        counted(total, lambda: _drive(srv[mesh], trace))
    expect(srv[True].table.mesh is not None
           and srv[True].table.mesh.size == 1, "phase 20 (d): the tenant "
           "mesh is not one card")
    _equal_states(srv[False], srv[True], "phase 20 (d) tenant mesh")
    for v in srv.values():
        v.close()
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 20 (d) structure server (d={CRASH_SERVE['d']}) over a "
        f"one-card tenant mesh == mesh-less, state bit for bit")


def lm_mesh(dev, total):
    """Phase 20: parts (a)-(e) above; adds the phase's launches to
    ``total``."""
    t0 = time.perf_counter()
    mine = {k: 0 for k in total}
    for part, args in ((lm_mesh_one_rank, ()), (lm_mesh_ranks, ()),
                       (lm_mesh_train, ()),
                       (mesh_server, (os.path.join(ROOT, "build",
                                                   "chip_smoke_mesh_srv"),))):
        t = time.perf_counter()
        part(dev, mine, *args)
        log(f"phase 20 {part.__name__} took {time.perf_counter() - t:.1f} s")
    for k, v in mine.items():
        total[k] += v
    log(f"phase 20 launches={json.dumps(mine)}; took "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 21: the dry run
# ---------------------------------------------------------------------------

#: (a): the sweep's worker processes; the sweep needs only the host, so it
#: starts after phase 2 and runs beside phases 3-20
DRY_WORKERS = 2
#: (b): phase 7's prefill of granite-8b in bf16 on a (1, 1) mesh
DRY_PREFILL = ("prefill_2048", "prefill", SERVE_PROMPT, SERVE_BATCH)
#: (b): the dry run's peak within this share of the card's peak over the
#: prefill call
DRY_PEAK_MARGIN = 0.10


#: (a): the arch whose shapes are jobs of their own (its train step is
#: the sweep's longest, ~70 s a mesh on the CPU)
DRY_SPLIT = "jamba-1.5-large-398b"


class DrySweep:
    """Phase 21 (a): ``python -m repro_torch.launch.dryrun`` over every
    arch x shape, both production meshes, one arch a job (DRY_SPLIT one
    shape a job), in DRY_WORKERS subprocesses at a time (longest first),
    each with the card hidden (``CUDA_VISIBLE_DEVICES=""``: its fake
    process group never meets the script's NCCL groups, and it allocates
    nothing on the card) and the card's memory passed as
    ``--hbm-bytes``. Records go to ``build/dryrun_torch/``."""

    def __init__(self, hbm_bytes: float):
        import shutil
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.launch.dryrun import not_planned
        from repro_torch.launch.shapes import SHAPES
        from repro_torch.models.arch import get_arch, list_archs

        self.out = os.path.join(ROOT, "build", "dryrun_torch")
        shutil.rmtree(self.out, ignore_errors=True)
        self.hbm, self.procs, self.t0 = hbm_bytes, [], time.perf_counter()
        jobs = [(DRY_SPLIT, n) for n in SHAPES] + [
            (a, None) for a in list_archs() if a != DRY_SPLIT]
        # an arch the dry run names as not planned writes no record
        planned = [a for a in list_archs() if not not_planned(get_arch(a))]
        self.combos = len(planned) * len(SHAPES) * 2
        self.pool = ThreadPoolExecutor(DRY_WORKERS)
        self.jobs = [(j, self.pool.submit(self._run, *j)) for j in jobs]

    def _run(self, arch, shape):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, *(["--shape", shape] if shape else []), "--mesh", "both",
             "--hbm-bytes", str(self.hbm), "--out", self.out], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.procs.append(proc)
        out = proc.communicate()[0]
        return proc.returncode, out, time.perf_counter() - t0

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        self.pool.shutdown(wait=True, cancel_futures=True)

    def finish(self):
        """Wait for every job; log each record's row and those that do not
        fit the card. Returns the records."""
        from repro_torch.launch.dryrun import fmt_row

        t_wait = time.perf_counter()
        busy = 0.0
        for (arch, shape), fut in self.jobs:
            rc, out, secs = fut.result()
            busy += secs
            expect(rc == 0, f"phase 21 (a) dry run of {arch} {shape} "
                   f"failed:\n{out[-3000:]}")
        self.pool.shutdown()
        recs = []
        for name in sorted(os.listdir(self.out)):
            with open(os.path.join(self.out, name)) as f:
                recs.append(json.load(f))
        expect(len(recs) == self.combos, f"phase 21 (a): {len(recs)} "
               f"records for {self.combos} combinations")
        for r in recs:
            log("phase 21 (a) " + fmt_row(r))
        over = [r["name"] for r in recs if not r["memory"]["fits"]]
        log(f"phase 21 (a) {len(recs)} dry runs (every arch x shape x "
            f"production mesh, rank 0) in {time.perf_counter() - self.t0:.1f}"
            f" s from their start after phase 2 ({DRY_WORKERS} workers, "
            f"{busy:.1f} s of jobs; phase 21 waited "
            f"{time.perf_counter() - t_wait:.1f} s); {len(over)} do not fit "
            f"{self.hbm / 2**30:.2f} GiB: {', '.join(over)}")
        return recs


_DRY_PREFILL = """
import json
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import InputShape
from repro_torch.models.arch import get_arch
with dryrun.on_mesh((1, 1), ("data", "model")) as mesh:
    rec = dryrun.dry_run(get_arch({arch!r}), InputShape(*{shape!r}), mesh)
print(json.dumps(rec, default=str))
"""


def dry_vs_card(dev, total):
    """Phase 21 (b): granite-8b's bf16 prefill at phase 7's batch and prompt
    on a (1, 1) mesh, dry-run (a subprocess with the card hidden) and run
    once on the card over a one-rank NCCL mesh. The argument bytes equal
    the bytes of the parameters and prompts allocated; the dry peak is
    within DRY_PEAK_MARGIN of the card's peak over the call (the peak
    reset just before it; allocations older than the model set aside);
    the FLOPs counted on the card's tensors (``op_analysis.counting``: aten
    and the kernels' formulas) equal the dry run's."""
    import torch
    from repro_torch.launch import op_analysis, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import random_prompts
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer

    t0 = time.perf_counter()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _DRY_PREFILL.format(arch=SERVE_ARCH,
                                                   shape=DRY_PREFILL)],
        cwd=ROOT, env=env, capture_output=True, text=True)
    expect(proc.returncode == 0, f"phase 21 (b) dry run failed:\n"
           f"{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    t_dry = time.perf_counter() - t0
    cfg, shape = get_arch(SERVE_ARCH), InputShape(*DRY_PREFILL)
    mesh = make_host_mesh(1, 1, device=dev)
    torch.cuda.empty_cache()
    sync()
    before = torch.cuda.memory_allocated()
    model = Transformer(cfg, device=dev, dtype=torch.bfloat16, mesh=mesh,
                        generator=torch.Generator(device=dev).manual_seed(0),
                        **rec["meta"]["layout"])
    batch = {"tokens": random_prompts(model, shape.global_batch,
                                      shape.seq_len)}
    sync()
    allocated = torch.cuda.memory_allocated() - before
    args = list(model.parameters()) + list(batch.values())
    arg_bytes = sum(t.numel() * t.element_size() for t in args)
    want = rec["memory"]["argument_bytes"]
    expect(arg_bytes == want, f"phase 21 (b): the card's parameters and "
           f"prompts are {arg_bytes} bytes, the dry run's arguments {want}")
    # the caching allocator rounds each block up to 512 bytes
    expect(0 <= allocated - arg_bytes <= 512 * len(args), f"phase 21 (b): "
           f"{allocated} bytes allocated for {arg_bytes} of arguments")
    step = steps.make_prefill_step(cfg, shape)
    step(model, {"tokens": batch["tokens"][:, :64]})     # warm-up
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (out, _), secs = timed(lambda: counted(total, lambda: step(model, batch)))
    peak = torch.cuda.max_memory_allocated() - (base - arg_bytes)
    del out
    predicted = rec["memory"]["peak_bytes"]
    expect(abs(predicted - peak) <= DRY_PEAK_MARGIN * peak, f"phase 21 (b): "
           f"the dry run's peak {predicted} is not within "
           f"{DRY_PEAK_MARGIN:.0%} of the card's {peak}")
    with op_analysis.counting(args) as count:
        out = step(model, batch)
    del out
    cost = rec["cost"]
    for what, got, dry in (("aten", count.dot_flops, cost["dot_flops"]),
                           ("kernel", count.kernel_flops,
                            cost["kernel_flops"]),
                           ("total", count.flops, cost["flops_per_device"])):
        expect(got == dry, f"phase 21 (b): {what} FLOPs on the card "
               f"{got}, dry {dry}")
    del model, batch, args
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"phase 21 (b) {SERVE_ARCH} bf16 prefill batch={shape.global_batch} "
        f"prompt={shape.seq_len} on a (1, 1) mesh: argument bytes "
        f"{arg_bytes} == dry ({allocated} allocated); peak over the call "
        f"{peak} bytes, dry {predicted} ({(predicted - peak) / peak:+.4%}; "
        f"margin {DRY_PEAK_MARGIN:.0%}); FLOPs on the card {count.flops:.6e} "
        f"== dry (aten {count.dot_flops:.6e}, kernels "
        f"{count.kernel_flops:.6e}); the card's count of the bytes the call "
        f"made {count.peak_bytes}, dry "
        f"{predicted - rec['memory']['argument_bytes']}; prefill {secs:.4f} s"
        f"; dry run {t_dry:.1f} s (a subprocess)")


def dry_run_phase(dev, total, sweep):
    """Phase 21: (a) the sweep's records, (b) the dry run against the
    card."""
    t0 = time.perf_counter()
    sweep.finish()
    t = time.perf_counter()
    dry_vs_card(dev, total)
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s ((b) "
        f"{time.perf_counter() - t:.1f})")


def main() -> int:
    import torch

    t_start = time.perf_counter()
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

    # phase 21 (a) runs on the host beside phases 3-20
    sweep = DrySweep(float(torch.cuda.get_device_properties(0).total_memory))
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        records = check_kernels("cuda", gen, MAIN_N, CUT_N, CHECK_N, D, reps=3)
        fold = check_fold_kernels("cuda", gen, SERVE_SLOTS, SERVE_BLOCK_N,
                                  SERVE_D, reps=5)
        for r in records:
            if r["name"] in fold:
                r["fold"] = fold[r["name"]]
        total, main_edges = run_main_path("cuda", D, MAIN_N, CUT_N)
        card_vs_cpu("cuda", 256, 1 << 14)
        records += check_attention_kernels("cuda", gen, 5, SERVE_BATCH,
                                           SERVE_PROMPT, SERVE_GEN)
        for k, n in serve_lm("cuda", SERVE_BATCH, SERVE_PROMPT,
                             SERVE_GEN).items():
            total[k] += n
        lm_card_vs_cpu("cuda")
        t0 = time.perf_counter()
        stream_at_width("cuda", D, CUT_N, STREAM_MACHINES, total)
        work = os.path.join(ROOT, "build", "chip_smoke_serve")
        serve_structures("cuda", SERVE_TENANTS, SERVE_MACHINES, SERVE_D,
                         SERVE_BLOCK_N, SERVE_TICKS, work, total)
        serve_correctness("cuda", work, total)
        log(f"phases 9-11 took {time.perf_counter() - t0:.1f} s")
        trial_plane("cuda", total, records, reps=3)
        sparse_plane("cuda", total)
        channel_plane("cuda", total, records, main_edges, reps=3)
        wire_plane("cuda", total, main_edges)
        train_plane("cuda", total, gen)
        gram_autotune("cuda", total)
        moe_mamba_serving("cuda", total)
        stubs = stub_serving("cuda", total)
        for r in records:
            if r["name"] in stubs:
                r["stubs"] = stubs[r["name"]]
        lm_mesh("cuda", total)
        dry_run_phase("cuda", total, sweep)
    finally:
        sweep.stop()
    for r in records:
        r["launches"] = total[r["name"]]
        expect(r["launches"] > 0, f"the main path never launched "
               f"{r['name']}")
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")

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
