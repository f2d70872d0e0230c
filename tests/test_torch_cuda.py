"""The port's CUDA kernels against their plain versions, on the card.

These tests import neither ``jax`` nor ``repro``, so they run where the
port runs (the machine with the card has no JAX):

    python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card they skip. Each wrapper's launch count must rise by one
per call.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.quantizers import PerSymbolQuantizer, codebook_tensors
from repro_torch.kernels import ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card (run this file there, or python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randint(0, 2, (3, 1001, 37), generator=gen, device=cuda,
                      dtype=torch.int8) * 2 - 1
    before = kernels.launches()
    torch.testing.assert_close(kernels.sign_corr(u), ref.sign_corr_ref(u),
                               rtol=0, atol=0)
    bits = torch.randint(0, 256, (2, 37, 126), generator=gen, device=cuda,
                         dtype=torch.uint8)
    torch.testing.assert_close(kernels.sign_corr_packed(bits, 1008),
                               ref.sign_corr_packed_ref(bits, 1008),
                               rtol=0, atol=0)
    codes = torch.randint(-1, 16, (1001, 37), generator=gen, device=cuda,
                          dtype=torch.int8)
    cb = torch.as_tensor(PerSymbolQuantizer(4).centroids_np, device=cuda)
    want = ref.code_corr_ref(codes, cb)
    torch.testing.assert_close(kernels.code_corr(codes, cb), want,
                               rtol=1e-5, atol=1e-5 * 1001)
    x = torch.randn(100, 64, generator=gen, device=cuda)
    b, c = codebook_tensors(2, cuda)
    for g, w in zip(kernels.quantize_fused(x, 2, values=True, pack=True),
                    ref.quantize_fused_ref(x, b, c, 2, values=True,
                                           pack=True)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    after = kernels.launches()
    assert all(after[k] == before[k] + 1 for k in
               ("sign_corr", "sign_corr_packed", "code_corr", "quantize_fused"))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [2, 7])
def test_cuda_code_corr_matches_plain_version(cuda, rate):
    """The 3xTF32 tensor-core code_corr, batched x rectangular (rows on
    16-byte bounds, by TMA, and off them), with n off the 32-sample stage
    and the 128-sample partial, and on column slices at offsets off 16
    bytes; held to the f32 plain version as chip_smoke.py holds it."""
    gen = torch.Generator(device=cuda).manual_seed(rate)
    cb = torch.as_tensor(PerSymbolQuantizer(rate).centroids_np, device=cuda)

    def codes(*shape):
        return torch.randint(-1, 1 << rate, shape, generator=gen, device=cuda,
                             dtype=torch.int8)

    before = kernels.launches()["code_corr"]
    cases = [(codes(3, 1001, 20), codes(3, 1001, 37)),
             (codes(2, 999, 144), codes(2, 999, 272)),
             (codes(4133, 256), None)]
    wide = codes(1001, 300)
    cases.append((wide[:, 5:133], wide[:, 40:290]))
    for u, v in cases:
        n = u.shape[-2]
        torch.testing.assert_close(kernels.code_corr(u, cb, v),
                                   ref.code_corr_ref(u, cb, v),
                                   rtol=1e-5, atol=1e-5 * n)
    assert kernels.launches()["code_corr"] == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=0, atol=3e-5)),
    (torch.bfloat16, dict(rtol=2 ** -7, atol=1e-2))])
def test_cuda_attention_kernels_match_plain_versions(cuda, dtype, tol):
    """f32: sums in another order. bf16: the output is rounded once to
    bf16 (2^-8 relative) after f32 sums in another order, so one bf16 ulp
    may differ (``chip_smoke.py`` holds the kernels to the same)."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    before = kernels.launches()
    # Dh 80 fills one and a half 64-column atoms of the bf16 tensor-core
    # kernel's tiles, Dh 128 two (the serving models' head size)
    for dh in (80, 128):
        q, k, v = rnd(2, 100, 8, dh), rnd(2, 100, 2, dh), rnd(2, 100, 2, dh)
        for causal, window in ((True, 0), (True, 30), (False, 0)):
            torch.testing.assert_close(
                kernels.flash_prefill(q, k, v, causal=causal, window=window),
                ref.flash_prefill_ref(q, k, v, causal=causal, window=window),
                **tol)
    cache = rnd(2, 300, 2, 128)
    qd = rnd(2, 8, 128)
    for pos, window in ((1, None), (300, None), (170, 64)):
        kt = cache.transpose(1, 2)
        torch.testing.assert_close(
            kernels.decode_attention(qd, kt, kt, pos, window=window),
            ref.decode_attention_ref(qd, kt, kt, pos, window=window),
            **tol)
    after = kernels.launches()
    assert after["flash_prefill"] == before["flash_prefill"] + 6
    assert after["decode_attention"] == before["decode_attention"] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=0, atol=3e-5)),
    (torch.bfloat16, dict(rtol=2 ** -7, atol=1e-2))])
def test_cuda_decode_attention_split_edges(cuda, dtype, tol):
    """The split-KV decode_attention at its edges, held to its plain
    version as chip_smoke.py holds it: forced split counts of 1, 2, 7 and
    more than the range has tiles (empty splits), windows and pos = 1
    (splits without a valid entry), groups of 1, 4 and 48, every head
    size, rows off 16 bytes (element loads). The default count splits the
    serving shape's range, and two calls give identical bits (the combine
    runs in split order and leaves its counters at 0)."""
    from repro_torch.kernels.decode_attention import split_count
    from repro_torch.kernels.flash_prefill import HEAD_DIMS

    gen = torch.Generator(device=cuda).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    before = kernels.launches()["decode_attention"]
    calls = 0

    def check(q, k, v, pos, window, splits):
        nonlocal calls
        got = kernels.decode_attention(q, k, v, pos, window=window,
                                       splits=splits)
        calls += 1
        want = ref.decode_attention_ref(q, k, v, pos, window=window)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, **tol)
        return got

    # (B, Hq, Hkv, S, Dh, pos, window)
    for b, hq, hkv, s, dh, pos, window in [
            (2, 8, 8, 700, 64, 700, None),     # G = 1
            (2, 32, 8, 1000, 128, 1, None),    # G = 4, pos = 1
            (1, 48, 1, 777, 128, 500, None),   # G = 48
            (2, 8, 2, 900, 80, 880, 100),      # window: 2 tiles of 14
            (1, 8, 2, 300, 32, 300, 0)]:       # window 0: no entry at all
        kv = rnd(b, s, hkv, dh), rnd(b, s, hkv, dh)
        k, v = (t.transpose(1, 2) for t in kv)   # the model's cache layout
        q = rnd(b, hq, dh)
        for splits in (None, 1, 2, 7, 64):
            got = check(q, k, v, pos, window, splits)
            if window == 0:
                assert (got == 0).all()
    for dh in HEAD_DIMS:
        q, k, v = rnd(1, 8, dh), rnd(1, 2, 333, dh), rnd(1, 2, 333, dh)
        check(q, k, v, 333, None, None)
        check(q, k, v, 200, 50, 5)
    kv = rnd(1, 2, 333, 65)   # rows off 16 bytes: element loads
    check(rnd(1, 8, 64), kv[..., 1:], kv[..., :64], 300, 200, None)
    check(rnd(1, 8, 64), kv[..., 1:], kv[..., :64], 300, 200, 9)

    # the serving shape: more than one split, and the same bits twice
    q = rnd(8, 32, 128)
    kt, vt = (rnd(8, 2080, 8, 128).transpose(1, 2) for _ in range(2))
    assert split_count(q, kt, 2064) > 1
    first = check(q, kt, vt, 2064, None, None)
    assert torch.equal(first, kernels.decode_attention(q, kt, vt, 2064))
    calls += 1
    assert kernels.launches()["decode_attention"] == before + calls


@pytest.mark.cuda
def test_cuda_decode_attention_workspace_across_shapes(cuda):
    """Calls of several shapes on one stream share the wrapper's workspace:
    the serving shape (B = 8, 32/8 heads of 128, bf16), then B = 12 (more
    groups, fewer splits: its counters must not lie on the partials the
    first call left), B = 8 again, a forced 64 splits, then B = 16 and
    B = 12; each held to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=cuda).to(torch.bfloat16)

    for b, splits in ((8, None), (12, None), (8, None), (2, 64),
                      (16, None), (12, None), (8, 64), (12, None)):
        q = rnd(b, 32, 128)
        k, v = (rnd(b, 2080, 8, 128).transpose(1, 2) for _ in range(2))
        got = kernels.decode_attention(q, k, v, 2064, splits=splits)
        want = ref.decode_attention_ref(q, k, v, 2064)
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-2)


def _pm1(gen, *shape, device):
    return torch.randint(0, 2, shape, generator=gen, device=device,
                         dtype=torch.int8) * 2 - 1


@pytest.mark.cuda
def test_cuda_sign_corr_edges(cuda):
    """The int8 tensor-core sign_corr is bit-identical to its plain version
    at n off the 128-sample stage (1, 127, 129, 1000), on rows off 16
    bytes (d = 20, 37: the transpose reads global memory) and on them
    (d = 144, 256, 272: TMA), batched and rectangular, on column slices
    at offsets 5 and 3, and as GramEngine's d_tile = 100 blocks."""
    from repro_torch.core.gram import GramEngine

    gen = torch.Generator(device=cuda).manual_seed(2)
    before = kernels.launches()["sign_corr"]
    calls = 0

    def same(u, v=None):
        nonlocal calls
        got = kernels.sign_corr(u, v)
        calls += 1
        assert torch.equal(got, ref.sign_corr_ref(u, v))

    for n in (1, 127, 129, 1000):
        same(_pm1(gen, n, 144, device=cuda))
    for shape_l, shape_r in [((1000, 20), None), ((1000, 37), None),
                             ((3, 1000, 20), (3, 1000, 37)),
                             ((2, 999, 144), (2, 999, 272)),
                             ((4133, 256), None), ((300, 272), (300, 144))]:
        same(_pm1(gen, *shape_l, device=cuda),
             None if shape_r is None else _pm1(gen, *shape_r, device=cuda))
    wide = _pm1(gen, 1000, 45, device=cuda)
    same(wide[:, 5:25], wide[:, 3:40])
    big = _pm1(gen, 1001, 300, device=cuda)
    same(big[:, 16:272], big[:, 32:])  # slices on 16-byte bounds
    assert torch.equal(GramEngine(backend="kernel", d_tile=100).gram(big),
                       ref.sign_corr_ref(big))
    assert kernels.launches()["sign_corr"] > before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("d", [37, 256])
def test_cuda_sign_corr_all_ones_is_exactly_n(cuda, d):
    """All +1 at n = 2^20: every entry of the Gram is exactly n (int32
    sums over 8192 stages, by element loads at d = 37, by TMA at 256)."""
    n = 1 << 20
    u = torch.ones((n, d), dtype=torch.int8, device=cuda)
    g = kernels.sign_corr(u)
    assert g.shape == (d, d) and bool((g == n).all())


def _bytes(gen, *shape, device):
    return torch.randint(0, 256, shape, generator=gen, device=device,
                         dtype=torch.uint8)


@pytest.mark.cuda
def test_cuda_sign_corr_packed_edges(cuda):
    """The int8 tensor-core sign_corr_packed is bit-identical to its plain
    version with random bits beyond n (the unpack zeroes them), at n = 1,
    127, 129, 997 (byte widths 1, 16, 17, 125: off 16 bytes, so the
    wrapper pads them), on an aligned width, batched and rectangular, on
    byte-axis and row slices, with n past the wire's 8 nb samples, and as
    GramEngine's d_tile = 100 blocks."""
    from repro_torch.core.gram import GramEngine

    gen = torch.Generator(device=cuda).manual_seed(4)
    before = kernels.launches()["sign_corr_packed"]
    calls = 0

    def same(p, n, q=None):
        nonlocal calls
        got = kernels.sign_corr_packed(p, n, q)
        calls += 1
        assert torch.equal(got, ref.sign_corr_packed_ref(p, n, q)), n

    for n in (1, 127, 129, 997):
        nb = -(-n // 8)
        same(_bytes(gen, 144, nb, device=cuda), n)
        same(_bytes(gen, 3, 20, nb, device=cuda), n,
             _bytes(gen, 3, 37, nb, device=cuda))
    same(_bytes(gen, 2, 272, 256, device=cuda), 2040,
         _bytes(gen, 2, 144, 256, device=cuda))
    wide = _bytes(gen, 300, 80, device=cuda)
    same(wide[:, 3:70], 500)
    same(wide[5:133, 16:64], 380, wide[40:290, 16:64])
    same(wide, 8 * 80 + 100)
    assert torch.equal(
        GramEngine(backend="kernel", d_tile=100).packed_sign_gram(wide, 633),
        ref.sign_corr_packed_ref(wide, 633))
    assert kernels.launches()["sign_corr_packed"] > before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("d", [37, 256])
def test_cuda_sign_corr_packed_equal_signs_is_exactly_n(cuda, d):
    """Every feature holds the same random signs at n = 2^20 - 3 (8192
    stages), random bits past n: every entry of the Gram is exactly n."""
    n = (1 << 20) - 3
    gen = torch.Generator(device=cuda).manual_seed(d)
    row = _bytes(gen, 1, n // 8 + 1, device=cuda)
    p = row.repeat(d, 1)
    keep = (1 << n % 8) - 1  # the last byte's bits below n
    p[:, -1] = (p[:, -1] & keep) | (_bytes(gen, d, device=cuda)
                                     & (0xFF ^ keep))
    g = kernels.sign_corr_packed(p, n)
    assert g.shape == (d, d) and bool((g == n).all())


@pytest.mark.cuda
def test_cuda_quantize_fused_edges(cuda):
    """R = 1..7, codes, values and (R | 8) packed bytes bit-identical to
    the plain version: totals of 0..3 mod 4 over several tiles, views at
    an offset of 1, 2 and 3 elements (off 16 bytes), and calls of several
    sizes queued on one stream before any is read."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    big = torch.randn(40000, generator=gen, device=cuda)
    big[:6] = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0,
                            -0.0, 1e-40], device=cuda)
    before = kernels.launches()["quantize_fused"]
    calls, queued = 0, []
    for rate in range(1, 8):
        bounds, cents = codebook_tensors(rate, cuda)
        group = 8 // rate if 8 % rate == 0 else 1
        for off, total in ((0, 12296), (1, 12297), (2, 4098), (3, 16387),
                           (0, 7), (1, 24), (0, 1)):
            total -= total % group if 8 % rate == 0 else 0
            x = big[off:off + total].view(-1, group) if group > 1 else \
                big[off:off + total]
            pack = 8 % rate == 0 and total > 0
            got = kernels.quantize_fused(x, rate, values=True, pack=pack)
            calls += 1
            want = ref.quantize_fused_ref(x, bounds, cents, rate,
                                          values=True, pack=pack)
            queued.append((got, want))
    for got, want in queued:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert kernels.launches()["quantize_fused"] == before + calls


# -- the serving plane's batched grids ----------------------------------------

def _fold_slots(slots, block_n, d, seed):
    """Host batches as ``TenantTable`` pads a fold: ``used`` payloads of
    ragged row counts, the rest padding slots — sign codes (0 = pad or a
    masked entry), per-symbol R = 4 codes (-1 = pad) and packed bits
    (zero bytes) with their valid counts."""
    from repro_torch.core.quantizers import pack_codes

    gen = torch.Generator().manual_seed(seed)
    used = slots - slots // 4
    rows = torch.randint(1, block_n + 1, (used,), generator=gen)
    signs = torch.zeros((slots, block_n, d), dtype=torch.int8)
    codes = torch.full((slots, block_n, d), -1, dtype=torch.int8)
    bits = torch.zeros((slots, d, block_n), dtype=torch.uint8)
    n_valid = torch.zeros(slots, dtype=torch.int32)
    for i, n in enumerate(rows.tolist()):
        signs[i, :n] = torch.randint(-1, 2, (n, d), generator=gen,
                                     dtype=torch.int8)
        codes[i, :n] = torch.randint(0, 16, (n, d), generator=gen,
                                     dtype=torch.int8)
        bits[i, :, :n] = torch.randint(0, 2, (d, n), generator=gen,
                                       dtype=torch.uint8)
        n_valid[i] = n
    return signs, codes, pack_codes(bits, 1), n_valid, used


@pytest.mark.cuda
@pytest.mark.parametrize("block_n,d", [(24, 250), (24, 1024), (256, 250),
                                       (256, 1024)])
def test_cuda_fold_stages_match_cpu(cuda, block_n, d):
    """The server's fold stages at b = 64 payload slots on the card
    (sign_corr, sign_corr_packed, code_corr) against the same stages on
    the CPU: sign and packed bit for bit, padding slots exactly 0,
    per-symbol R = 4 within rtol=1e-5, atol=1e-5*block_n."""
    from repro_torch.core.gram import GramEngine
    from repro_torch.serve.table import codes_fold_stage, packed_fold_stage

    signs, codes, packed, n_valid, used = _fold_slots(64, block_n, d,
                                                      block_n + d)
    card, cpu = GramEngine(), GramEngine(device="cpu")
    before = kernels.launches()
    got = codes_fold_stage(signs.to(cuda), "sign", 1, card).cpu()
    assert torch.equal(got, codes_fold_stage(signs, "sign", 1, cpu))
    got = packed_fold_stage(packed.to(cuda), n_valid.to(cuda), block_n,
                            card).cpu()
    assert torch.equal(got, packed_fold_stage(packed, n_valid, block_n, cpu))
    assert bool((got[used:] == 0).all())
    got = codes_fold_stage(codes.to(cuda), "persymbol", 4, card).cpu()
    want = codes_fold_stage(codes, "persymbol", 4, cpu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * block_n)
    assert bool((got[used:] == 0).all())
    # the engine's c^2 * sign route at R = 1: {0, 1} codes, -1 padding
    r1 = torch.where(codes >= 0, codes % 2, -1).to(torch.int8)
    assert torch.equal(codes_fold_stage(r1.to(cuda), "persymbol", 1,
                                        card).cpu(),
                       codes_fold_stage(r1, "persymbol", 1, cpu))
    after = kernels.launches()
    assert after["sign_corr"] == before["sign_corr"] + 2
    assert after["sign_corr_packed"] == before["sign_corr_packed"] + 1
    assert after["code_corr"] == before["code_corr"] + 1


@pytest.mark.cuda
def test_cuda_gram_kernels_at_the_fold_shape(cuda):
    """sign_corr, sign_corr_packed and code_corr at the server's fold
    shape (b = 64, n = 256, d = 1024) held to their plain versions on the
    card, as chip_smoke.py's phase 3 holds them."""
    from repro_torch.core.quantizers import PerSymbolQuantizer

    signs, codes, packed, _, _ = _fold_slots(64, 256, 1024, 7)
    u, c, p = signs.to(cuda), codes.to(cuda), packed.to(cuda)
    assert torch.equal(kernels.sign_corr(u), ref.sign_corr_ref(u))
    assert torch.equal(kernels.sign_corr_packed(p, 256),
                       ref.sign_corr_packed_ref(p, 256))
    cb = torch.as_tensor(PerSymbolQuantizer(4).centroids_np, device=cuda)
    want = ref.code_corr_ref(c, cb)
    err = (kernels.code_corr(c, cb) - want).abs()
    assert bool((err <= 1e-5 * 256 + 1e-5 * want.abs()).all())


@pytest.mark.cuda
def test_cuda_streaming_packed_batch_n_valid_matches_cpu(cuda):
    """StreamingGram.update_packed_batch with a straggler, a dropout and
    odd prefixes: the card's Gram equals the CPU's bit for bit, in one
    sign_corr_packed launch."""
    from repro_torch.core import StreamingGram
    from repro_torch.core.gram import GramEngine
    from repro_torch.core.quantizers import pack_codes

    gen = torch.Generator().manual_seed(8)
    m, n, d = 8, 997, 250
    bits = torch.randint(0, 2, (m, d, n), generator=gen, dtype=torch.uint8)
    p = pack_codes(torch.nn.functional.pad(bits, (0, (-n) % 8)), 1)
    nv = [997, 0, 500, 13, 997, 996, 1, 800]
    before = kernels.launches()["sign_corr_packed"]
    a = StreamingGram(d, engine=GramEngine()).update_packed_batch(
        p.to(cuda), n, nv)
    assert kernels.launches()["sign_corr_packed"] == before + 1
    b = StreamingGram(d, engine=GramEngine(device="cpu")).update_packed_batch(
        p, n, nv)
    assert a.gram.device.type == "cuda" and a.n == b.n == sum(nv)
    assert torch.equal(a.gram.cpu(), b.gram)


@pytest.mark.cuda
def test_cuda_server_matches_cpu(cuda, tmp_path):
    """A small structure-server run on the card and on the CPU (d = 250,
    rows off 16 bytes): equal comparable_state and per-tick telemetry."""
    import numpy as np
    from repro_torch.core.gram import GramEngine
    from repro_torch.serve import (ServeConfig, StructureServer,
                                   TrafficConfig, make_trace)

    trace = make_trace(TrafficConfig(
        tenants=4, machines=3, ticks=6, n=24, d=250, p_duplicate=0.25,
        p_reorder=0.25, p_drop=0.1, seed=11))
    scfg = dict(tenants=4, machines=3, d=250, block_n=24, snapshot_every=3,
                reorder_ticks=2)
    runs = []
    for name, eng in (("card", GramEngine()),
                      ("cpu", GramEngine(device="cpu"))):
        srv = StructureServer(ServeConfig(**scfg, engine=eng),
                              str(tmp_path / name))
        tele = []
        for batch in trace + [[]] * 3:
            for p in batch:
                srv.submit(p)
            tick = srv.run_tick()
            tick.pop("fold_seconds")
            tele.append(tick)
        srv.force_resolve()
        runs.append((tele, srv.comparable_state()))
        srv.close()
    (t_card, s_card), (t_cpu, s_cpu) = runs
    assert t_card == t_cpu
    for k in s_card:
        assert np.array_equal(s_card[k], s_cpu[k]), k


@pytest.mark.cuda
def test_cuda_trial_plane_matches_cpu(cuda):
    """A small sweep (d = 20, the Fig. 3 width, every strategy and both
    wires) and a faulty one on the card and on the CPU: equal results,
    one host read, the four trial-plane kernels launched; a zero-fault
    plan equal to none on the card."""
    import dataclasses

    from repro_torch.core import FIG3_STRATEGIES, Strategy
    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan

    packed = (Strategy("sign", wire="packed"),
              Strategy("persymbol", rate=2, wire="packed"))
    faults = FaultPlan(dropout=0.2, straggle=0.3, bitflip=0.01, retries=1,
                       machines=4, seed=1)
    fields = ("error_rate", "edit_distance", "edge_f1", "buckets",
              "host_syncs", "faults")
    before = kernels.launches()
    for plan in (TrialPlan(d=20, ns=(100, 250), reps=6),
                 TrialPlan(d=20, ns=(100, 250), reps=6, strategies=packed),
                 TrialPlan(d=20, ns=(100,), reps=6, strategies=packed,
                           faults=faults)):
        card = run_trials(plan, device=cuda)
        host = run_trials(plan, device="cpu")
        assert card.host_syncs == 1
        for f in fields:
            assert getattr(card, f) == getattr(host, f), f
        assert ({k: [dataclasses.asdict(r) for r in v]
                 for k, v in card.comm.items()}
                == {k: [dataclasses.asdict(r) for r in v]
                    for k, v in host.comm.items()})
    after = kernels.launches()
    assert all(after[k] > before[k] for k in
               ("sign_corr", "sign_corr_packed", "code_corr",
                "quantize_fused", "row_normals"))
    plan = TrialPlan(d=20, ns=(100,), reps=6, strategies=FIG3_STRATEGIES)
    zero = dataclasses.replace(plan, faults=FaultPlan(machines=4, retries=1))
    a, b = run_trials(plan, device=cuda), run_trials(zero, device=cuda)
    for f in ("error_rate", "edit_distance", "edge_f1"):
        assert getattr(a, f) == getattr(b, f), f


def _row_keys(seed, t, device):
    from repro_torch.core import prng

    return prng.fold_in(prng.key(seed, device=device),
                        torch.arange(t, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_cuda_row_normals_match_plain_version(cuda, seed):
    """The row-normals kernel against its plain version on the card, bit
    for bit: d = 20, 1023 and 1024 at t = 1 and 3, with and without a
    scale, rows off 0; a row count across 2^32, which the counter wraps;
    widths under a vector (d = 1, 3) and the sweep's block (120 trials x
    136 rows x 1024)."""
    gen = torch.Generator(device=cuda).manual_seed(seed % 997)
    cases = [(t, 3, 9, d, scaled) for d in (20, 1023, 1024) for t in (1, 3)
             for scaled in (False, True)]
    cases += [(2, 2 ** 32 - 3, 2 ** 32 + 2, 37, True), (5, 1, 40, 1, False),
              (4, 7, 20, 3, True), (120, 136 * 59, 136 * 60, 1024, True)]
    before = kernels.launches()["row_normals"]
    for t, r0, r1, d, scaled in cases:
        keys = _row_keys(seed, t, cuda)
        scale = (torch.rand((t, d), generator=gen, device=cuda) + 0.4
                 if scaled else None)
        got = kernels.row_normals(keys, r0, r1, d, scale)
        want = ref.row_normals_ref(keys, r0, r1, d, scale)
        assert got.shape == want.shape == (t, r1 - r0, d)
        diff = got.view(torch.int32) != want.view(torch.int32)
        assert not bool(diff.any()), (
            f"t={t} rows {r0}..{r1} d={d} scale={scaled}: "
            f"{int(diff.sum())} of {diff.numel()} normals differ, by up to "
            f"{float((got - want).abs().max())}")
    assert kernels.launches()["row_normals"] == before + len(cases)


@pytest.mark.cuda
def test_cuda_sweep_through_row_normals_equals_the_plain_path(cuda,
                                                               monkeypatch):
    """A d = 1024 sweep draws its samples through the kernel, one launch a
    row block, and its metric sums equal those of the same sweep with the
    plain version patched in, bit for bit."""
    from repro_torch.core import FIG3_STRATEGIES, sampler
    from repro_torch.core.experiments import TrialPlan, run_trials

    plan = TrialPlan(d=1024, ns=(2048,), reps=16, strategies=FIG3_STRATEGIES)
    rows = max(1, sampler._ROW_KEYED_BLOCK // (plan.reps * plan.d))
    blocks = -(-plan.bucket_for(2048) // rows)
    assert blocks == 2
    kernels.reset_launches()
    got = run_trials(plan, device=cuda)
    assert kernels.launches()["row_normals"] == blocks
    monkeypatch.setattr(kernels, "row_normals",
                        lambda keys, r0, r1, d, scale=None:
                        ref.row_normals_ref(keys, r0, r1, d, scale))
    want = run_trials(plan, device=cuda)
    for f in ("error_rate", "edit_distance", "edge_f1", "precision",
              "recall"):
        assert getattr(got, f) == getattr(want, f), f


def _sparse_strategies(methods):
    from repro_torch.core import Strategy

    return tuple(Strategy(m, rate=r, structure="sparse", lam=0.06)
                 for m, r in methods)


#: examples/sparse_glasso.py's plan at fewer reps
SPARSE_SWEEP = dict(d=16, tree="sparse", density=0.18, rho_min=0.25,
                    rho_max=0.45, glasso_steps=300)


@pytest.mark.cuda
def test_cuda_sparse_plane_matches_cpu(cuda):
    """A d = 16 sparse sweep (the example's width, fixed lam and an EBIC
    path) on the card and on the CPU: one result read, and metrics equal
    but as experiments.sparse_sweep_faults allows (each device's sweep
    equal to its points solved alone, supports parting only at entries
    whose partial correlations sit at the threshold); a sparse fault
    plan's telemetry equal."""
    import dataclasses

    from repro_torch.core.experiments import (TrialPlan, run_trials,
                                              sparse_sweep_faults)
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.path import PathPlan

    plan = TrialPlan(strategies=_sparse_strategies(
        (("sign", 1), ("persymbol", 2), ("original", 1))), reps=6,
        ns=(250, 1000), **SPARSE_SWEEP)
    before = kernels.launches()
    for p in (plan, dataclasses.replace(plan, path=PathPlan(n_lams=4)),
              dataclasses.replace(plan, faults=FaultPlan(
                  dropout=0.3, bitflip=0.01, machines=4, seed=8))):
        card = run_trials(p, device=cuda)
        host = run_trials(p, device="cpu")
        assert card.host_syncs == 1 and card.faults == host.faults
        assert card.buckets == host.buckets
        _, faults = sparse_sweep_faults(p, card, host, device=cuda,
                                        ref_device="cpu")
        assert not faults, faults
    after = kernels.launches()
    assert all(after[k] > before[k] for k in
               ("sign_corr", "code_corr", "quantize_fused"))


@pytest.mark.cuda
def test_cuda_sparse_zero_fault_plan_equals_none(cuda):
    import dataclasses

    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan

    plan = TrialPlan(strategies=_sparse_strategies(
        (("sign", 1), ("persymbol", 4), ("original", 1))), reps=4,
        ns=(250, 1000, 4000), **SPARSE_SWEEP)
    zero = dataclasses.replace(plan, faults=FaultPlan(machines=4, retries=1))
    a, b = run_trials(plan, device=cuda), run_trials(zero, device=cuda)
    for f in ("error_rate", "edit_distance", "edge_f1", "precision",
              "recall"):
        assert getattr(a, f) == getattr(b, f), f


def _channel_strategies():
    from repro_torch.core import BudgetChannel, MACChannel, Strategy

    return (Strategy("sign"), Strategy("persymbol", rate=4),
            Strategy("sign", channel=MACChannel(4)),
            Strategy("persymbol", rate=4, channel=BudgetChannel(
                budget_bits=6 * 512 * 16, machines=4)))


@pytest.mark.cuda
def test_cuda_channel_sweep_matches_cpu(cuda):
    """benchmarks/channels.py's strategies (gather, MAC, budget) at fewer
    reps, pristine and faulty with retries, on the card and the CPU:
    equal results and ledgers, one host read, lossless MAC == gather
    sign; sign_corr and quantize_fused launched."""
    import dataclasses

    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan

    plan = TrialPlan(d=16, ns=(128, 512), reps=8, seed0=7,
                     strategies=_channel_strategies())
    fields = ("error_rate", "edit_distance", "edge_f1", "buckets",
              "host_syncs", "faults")
    before = kernels.launches()
    for p in (plan, dataclasses.replace(plan, faults=FaultPlan(
            dropout=0.15, straggle=0.3, straggle_frac=0.5, bitflip=0.01,
            retries=1, machines=4, seed=1))):
        card = run_trials(p, device=cuda)
        host = run_trials(p, device="cpu")
        assert card.host_syncs == 1
        for f in fields:
            assert getattr(card, f) == getattr(host, f), f
        assert ({k: [dataclasses.asdict(r) for r in v]
                 for k, v in card.comm.items()}
                == {k: [dataclasses.asdict(r) for r in v]
                    for k, v in host.comm.items()})
        if p.faults is None:
            assert card.error_rate["sign@mac4"] == card.error_rate["sign"]
    after = kernels.launches()
    assert all(after[k] > before[k] for k in
               ("sign_corr", "code_corr", "quantize_fused"))


@pytest.mark.cuda
def test_cuda_sign_corr_on_mac_masked_codes(cuda):
    """sign_corr on MAC codes whose undelivered rows are zero inside the
    operand: an interior block dropped whole, one cut off the 128-sample
    stage, a padded tail."""
    from repro_torch.core import MACChannel, Strategy, estimators

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 2048, 40, generator=gen, device=cuda)
    s = Strategy("sign", channel=MACChannel(8))
    delivered = torch.full((3, 8), 256, dtype=torch.int32, device=cuda)
    delivered[:, 2] = 0
    delivered[1, 5] = 77
    delivered[2, 6] = 129
    delivered[:, 7] = 200
    u = estimators.mac_sign_codes(x, s, delivered=delivered)
    assert not u[:, 512:768].any() and not u[:, 7 * 256 + 200:].any()
    assert not u[1, 5 * 256 + 77:6 * 256].any()
    before = kernels.launches()["sign_corr"]
    torch.testing.assert_close(kernels.sign_corr(u), ref.sign_corr_ref(u),
                               rtol=0, atol=0)
    assert kernels.launches()["sign_corr"] == before + 1
    host = estimators.mac_sign_codes(x.cpu(), s, delivered=delivered.cpu())
    assert torch.equal(u.cpu(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad,n_valid,machines", [(1024, 1000, 16),
                                                    (256, 256, 4),
                                                    (512, 77, 8)])
def test_cuda_draw_rowblock_batch_matches_cpu(cuda, n_pad, n_valid,
                                              machines):
    from repro_torch.core.faults import FaultPlan, fault_trial_keys

    fp = FaultPlan(dropout=0.3, straggle=0.4, straggle_frac=0.3, retries=2,
                   machines=machines, seed=5)
    got = fp.draw_rowblock_batch(fault_trial_keys(fp, 9, device=cuda),
                                 n_pad, n_valid, machines)
    want = fp.draw_rowblock_batch(fault_trial_keys(fp, 9, device="cpu"),
                                  n_pad, n_valid, machines)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_wire_plan_on_a_one_rank_nccl_mesh(cuda):
    """distributed_weights over a one-rank NCCL mesh (the WirePlan stages:
    encode, the all-gather, the central Gram) equals strategy_weights on
    the same samples bit for bit on the integer wires (replicated, the
    rowblock's rectangular sign_corr, packed) and gives the same edges as
    learn_structure; its Gram kernels launch."""
    from repro_torch.core import estimators
    from repro_torch.core.chow_liu import learn_structure
    from repro_torch.core.distributed import (distributed_learn_structure,
                                              distributed_weights)
    from repro_torch.core.strategy import Strategy
    from repro_torch.data import GGMDataset
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1)
    assert mesh.device_type == "cuda"
    x = GGMDataset(d=200, seed=4).sample(4096, device=cuda)
    for fields, kernel in ((dict(), "sign_corr"),
                           (dict(placement="rowblock"), "sign_corr"),
                           (dict(wire="packed"), "sign_corr_packed"),
                           (dict(wire="packed", placement="rowblock"),
                            "sign_corr_packed")):
        s = Strategy("sign", **fields)
        before = kernels.launches()
        got = distributed_weights(x, mesh, strategy=s)
        assert kernels.launches()[kernel] > before[kernel]
        torch.testing.assert_close(got, estimators.strategy_weights(x, s),
                                   rtol=0, atol=0)
        assert distributed_learn_structure(x, mesh, strategy=s) == \
            learn_structure(x, strategy=s)


@pytest.mark.cuda
def test_cuda_mesh_trials_match_mesh_less(cuda):
    """run_trials over one-rank NCCL meshes — data and wire — equals the
    mesh-less sweep on the card bit for bit (gather, MAC and budget
    channels, pristine and faulty, and a sparse plan), with the wire
    mesh's collectives on the reports."""
    import dataclasses

    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.strategy import Strategy
    from repro_torch.launch.mesh import make_trial_mesh

    plan = TrialPlan(d=16, ns=(128, 512), reps=8, seed0=7,
                     strategies=_channel_strategies())
    sparse = TrialPlan(d=16, ns=(250,), tree="sparse", density=0.18, reps=8,
                       glasso_steps=100, strategies=(
                           Strategy("sign", structure="sparse", lam=0.06),))
    fields = ("error_rate", "edit_distance", "edge_f1", "precision",
              "recall", "buckets", "host_syncs", "faults")
    for p in (plan, dataclasses.replace(plan, faults=FaultPlan(
            dropout=0.15, straggle=0.3, bitflip=0.01, retries=1,
            machines=4, seed=1)), sparse):
        alone = run_trials(p, device=cuda)
        for model in (None, 1):
            got = run_trials(p, mesh=make_trial_mesh(1, model=model))
            assert got.mesh_devices == 1 and got.host_syncs == 1
            for f in fields:
                assert getattr(got, f) == getattr(alone, f), f
            for lab, reports in got.comm.items():
                for r, a in zip(reports, alone.comm[lab]):
                    assert dataclasses.replace(r, collectives=0) == a
                    assert r.collectives == (0 if model is None else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,dh,window", [(4, 4, 80, 0), (8, 2, 128, 40),
                                               (4, 1, 64, 0)])
def test_cuda_flash_prefill_grad_route(cuda, dtype, hq, hkv, dh, window):
    """The kernel forward with its PyTorch backward against autograd
    through the plain version: dq, dk, dv within 2e-5 (f32) and 2^-5
    (bf16) of each gradient's largest entry, as chip_smoke.py's phase
    16(a) holds them; one launch per differentiable call."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(hq + dh)

    def rnd(h):
        return torch.randn((2, 333, h, dh), generator=gen,
                           device=cuda).to(dt)

    q, k, v, do = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)

    def route(fn):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*ts, causal=True, window=window)
        return (out, *torch.autograd.grad(out, ts, do))

    before = kernels.launches()["flash_prefill"]
    got = route(kernels.flash_prefill)
    assert kernels.launches()["flash_prefill"] == before + 1
    want = route(ref.flash_prefill_ref)
    tol = 2e-5 if dtype == "float32" else 2 ** -5
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == dt
        w32 = w.float()
        assert float((g.float() - w32).abs().max()) <= tol * float(
            w32.abs().max())


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda):
    """Two f32 train steps of a small GQA model from the same params: the
    card (kernel) and the CPU (plain) agree on loss and grad norm."""
    import copy

    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.arch import ArchConfig, LayerSpec
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamW, linear_warmup_cosine

    cfg = ArchConfig(name="train-cuda", family="dense", n_layers=2,
                     d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                     vocab=500, head_dim=32, pattern=(LayerSpec(),),
                     rope_theta=1e4)
    cpu = Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 65),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        model.requires_grad_(True)
        opt = AdamW(model.parameters())
        step = make_train_step(cfg, InputShape("t", "train", 64, 2),
                               linear_warmup_cosine(1e-3, 1, 2))
        b = {"tokens": tokens[:, :-1].to(model.device),
             "labels": tokens[:, 1:].to(model.device)}
        out[name] = [{k: float(v) for k, v in step(model, opt, b).items()}
                     for _ in range(2)]
    for a, b in zip(out["card"], out["cpu"]):
        assert a["lr"] == b["lr"]
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k])


@pytest.mark.cuda
def test_cuda_autotuned_kernel_gram(cuda, tmp_path, monkeypatch):
    """GramEngine(autotune=True) on the card: one sweep a point keyed by
    the card's name, none when warm, and the tuned int8 and packed Grams
    bit-identical to the default config's."""
    from repro_torch.core import gram as gm

    monkeypatch.setenv(gm.AUTOTUNE_CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.delenv(gm.AUTOTUNE_ENV, raising=False)
    gm.clear_autotune_cache()
    try:
        eng = gm.GramEngine(autotune=True)
        gen = torch.Generator(device=cuda).manual_seed(3)
        u = torch.randint(0, 2, (3000, 700), generator=gen, device=cuda,
                          dtype=torch.int8) * 2 - 1
        bits = torch.randint(0, 256, (700, 375), generator=gen, device=cuda,
                             dtype=torch.uint8)
        c0 = gm.autotune_sweep_count()
        assert torch.equal(eng.gram(u), gm.GramEngine().gram(u))
        bits[:, -1] = 0          # n = 2992: the tail bits beyond n are zero
        assert torch.equal(eng.packed_sign_gram(bits, 2992),
                           gm.GramEngine().packed_sign_gram(bits, 2992))
        assert gm.autotune_sweep_count() == c0 + 2
        key = gm.autotune_sweep_log()[-2]["key"]
        assert key == (f"cuda:{torch.cuda.get_device_name(cuda)}:kernel:"
                       f"int8:n4096:d1024")
        eng.gram(u)
        assert gm.autotune_sweep_count() == c0 + 2
    finally:
        gm.clear_autotune_cache()


@pytest.mark.cuda
def test_cuda_glasso_lanes_independent_of_their_batch(cuda):
    """A glasso lane's iterates on the card do not depend on the other
    lanes of its batch (the per-lane sums are fixed trees of adds): lanes
    8..15 of a 24-lane d = 128 solve equal those lanes solved alone, bit
    for bit, as the sparse sweeps' point checks require."""
    from repro_torch.core import glasso

    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((24, 512, 128), generator=gen, device=cuda)
    S = x.transpose(-1, -2) @ x / 512
    lam = torch.linspace(0.05, 0.2, 24, device=cuda)
    full = glasso.glasso_batch(S, lam, n_steps=40)
    alone = glasso.glasso_batch(S[8:16], lam[8:16], n_steps=40)
    assert torch.equal(full[8:16], alone)


def _moe_mamba_cfgs():
    """The reduced MoE, SSM and hybrid configs of the card-vs-CPU checks:
    qwen2-moe at capacity factor 64 (no drops) and 1.25 (its 4 real
    experts of 16 overflow at 80 tokens), mamba2 and jamba."""
    import dataclasses

    from repro_torch.models.arch import get_arch

    qwen = get_arch("qwen2-moe-a2.7b").reduced()
    return {"qwen2-moe-cap64": dataclasses.replace(qwen,
                                                   moe_capacity_factor=64.0),
            "qwen2-moe-cap1.25": qwen,
            "mamba2": get_arch("mamba2-370m").reduced(),
            "jamba": get_arch("jamba-1.5-large-398b").reduced()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-moe-cap64", "qwen2-moe-cap1.25",
                                  "mamba2", "jamba"])
def test_cuda_moe_and_mamba_models_match_cpu(cuda, name):
    """The same f32 weights on the card and the CPU: a 40-token prefill
    (batch 2) and 8 greedy decode steps give equal ids and logits within
    1e-4 (jamba: 1e-3, its 12 Mamba2 layers' f32 scan noise, as against
    ``repro`` in ``tests/test_torch_hybrid.py``)."""
    import copy

    from repro_torch.models.transformer import Transformer

    cfg = _moe_mamba_cfgs()[name]
    cpu = Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    drops = [blk.ff.register_forward_hook(
        lambda m, inp, out: dropped.append(int(m.dropped(inp[0]))))
        for blk in cpu.layers if blk.spec.ff == "moe"]
    dropped: list = []
    tol = 1e-3 if name == "jamba" else 1e-4
    lc, cc = cpu.prefill(tokens, max_len=48)
    for h in drops:
        h.remove()
    assert (sum(dropped) > 0) == (name in ("qwen2-moe-cap1.25", "jamba"))
    lg, cg = card.prefill(tokens.to(cuda), max_len=48)
    for i in range(9):
        assert float((lg.cpu() - lc).abs().max()) <= tol, i
        tok = lc[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(lg[:, -1].argmax(-1, keepdim=True).cpu(), tok)
        if i < 8:
            lc, cc = cpu.decode_step(cc, tok, 40 + i)
            lg, cg = card.decode_step(cg, tok.to(cuda), 40 + i)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "mamba2-370m"])
def test_cuda_moe_and_mamba_decode_step_without_host_sync(cuda, name):
    """A decode step of reduced qwen2-moe (routing, the capacity dispatch,
    the gather combine, attention) and of reduced mamba2 runs with
    ``set_sync_debug_mode("error")``: no device-to-host sync."""
    from repro_torch.launch.serve import build

    model = build(name, reduced=True, device=cuda, dtype=torch.bfloat16)
    tokens = torch.randint(0, model.cfg.vocab, (8, 16), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    logits, cache = model.prefill(tokens, max_len=20)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    logits, cache = model.decode_step(cache, tok, 16)   # warm
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.decode_step(cache, tok, 17)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits[..., :model.cfg.vocab]).all()


@pytest.mark.cuda
def test_cuda_granite4h_prefill_without_host_sync(cuda):
    """A prefill of reduced granite-4.0-h-small (the dropless MoE's sort,
    counts and grouped GEMMs, the Mamba2 mixers, NoPE attention) and a
    decode step run with ``set_sync_debug_mode("error")``: no
    device-to-host sync, and ``host_reads`` does not move."""
    from repro_torch import trace
    from repro_torch.launch.serve import build

    model = build("granite-4.0-h-small", reduced=True, device=cuda,
                  dtype=torch.bfloat16)
    tokens = torch.randint(0, model.cfg.vocab, (2, 64), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    logits, cache = model.prefill(tokens, max_len=72)   # warm
    tok = logits[:, -1].argmax(-1, keepdim=True)
    model.decode_step(cache, tok, 64)
    torch.cuda.synchronize()
    reads = trace.counts().get("host_reads", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.prefill(tokens, max_len=72)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        logits, cache = model.decode_step(cache, tok, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trace.counts().get("host_reads", 0) == reads
    assert torch.isfinite(logits[..., :model.cfg.vocab]).all()


@pytest.mark.cuda
def test_cuda_granite4h_matches_cpu(cuda):
    """Reduced granite-4.0-h-small in f32, the same weights on the card
    and the CPU: the prefill's logits and caches and 4 decode steps'
    logits agree within 1e-3 of their RMS (the widest |difference| of
    the logits, the RMS of the difference of a cache leaf: f32 GEMM and
    scan rounding through 18 Mamba2 layers, as reduced jamba's 12 sit
    ~3e-4 from ``repro``'s; the card's grouped GEMMs and flash_prefill
    against the CPU's)."""
    import copy

    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer

    cfg = get_arch("granite-4.0-h-small").reduced()
    cpu = Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 300),
                           generator=torch.Generator().manual_seed(1))

    gaps = {}

    def close(what, got, want, widest=True):
        want = want.float()
        diff = got.cpu().float() - want
        gap = diff.abs().max() if widest else diff.square().mean().sqrt()
        gaps[what] = float(gap / want.square().mean().sqrt())

    lc, cc = cpu.prefill(tokens, max_len=304)
    lg, cg = card.prefill(tokens.to(cuda), max_len=304)
    close("prefill", lg, lc)
    for i, (a, b) in enumerate(zip(cg, cc)):
        for k in b:
            close(f"layer {i} {k}", a[k], b[k], widest=False)
    for i in range(4):
        tok = lc[:, -1].argmax(-1, keepdim=True)
        lc, cc = cpu.decode_step(cc, tok, 300 + i)
        lg, cg = card.decode_step(cg, tok.to(cuda), 300 + i)
        close(f"decode {i}", lg, lc)
    assert max(gaps.values()) <= 1e-3, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_routes_of_the_encoder_and_cross_layers(cuda, dtype):
    """The routes the encoder-decoder and vision-prefixed models add, each
    kernel against its plain version (f32 within 3e-5, bf16 within 1e-2 +
    2^-7 relative): flash_prefill non-causal over a whole sequence (the
    encoder), non-causal with Sq != Skv (cross-attention), causal over a
    prefix that is not a multiple of a tile (P + S); decode_attention over
    a cross cache with every slot valid."""
    from repro_torch.kernels import decode_attention, flash_prefill

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dt)

    def close(got, want):
        tol = dict(rtol=0, atol=3e-5) if dt == torch.float32 else \
            dict(rtol=2 ** -7, atol=1e-2)
        torch.testing.assert_close(got.float(), want.float(), **tol)

    before = kernels.launches()
    for (sq, skv, hq, hkv, dh, causal) in ((300, 300, 16, 16, 64, False),
                                           (512, 130, 16, 16, 64, False),
                                           (130, 512, 8, 2, 128, False),
                                           (144 + 200, 144 + 200, 8, 2, 128,
                                            True)):
        q, k, v = rnd(2, sq, hq, dh), rnd(2, skv, hkv, dh), rnd(2, skv, hkv,
                                                                  dh)
        close(flash_prefill(q, k, v, causal=causal),
              ref.flash_prefill_ref(q, k, v, causal=causal))
    xk, xv = rnd(3, 130, 4, 64), rnd(3, 130, 4, 64)   # (B, Sm, Hkv, Dh)
    q = rnd(3, 16, 64)
    close(decode_attention(q, xk.transpose(1, 2), xv.transpose(1, 2), 130),
          ref.decode_attention_ref(q, xk.transpose(1, 2),
                                   xv.transpose(1, 2), 130))
    after = kernels.launches()
    assert after["flash_prefill"] == before["flash_prefill"] + 4
    assert after["decode_attention"] == before["decode_attention"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_cuda_stub_models_match_cpu(cuda, arch):
    """Reduced seamless (encoder, cross-attention) and llava (patch
    prefix), the same f32 weights and embeddings on the card and the
    CPU: a prefill and 8 greedy decode steps give equal ids and logits
    within 1e-4, and every attention layer launched its kernel."""
    import copy

    from repro_torch.launch.serve import random_embeds
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer

    cfg = get_arch(arch).reduced()
    cpu = Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    emb = random_embeds(cpu, 2, 40)
    p = emb["modal_embeds"].shape[1] if "modal_embeds" in emb else 0
    before = kernels.launches()
    lc, cc = cpu.prefill(tokens, max_len=p + 48, **emb)
    lg, cg = card.prefill(tokens.to(cuda), max_len=p + 48,
                          **{k: v.to(cuda) for k, v in emb.items()})
    n_attn = len(card.layers) * (2 if cfg.is_encoder_decoder else 1) + (
        len(card.enc_layers) if cfg.is_encoder_decoder else 0)
    assert kernels.launches()["flash_prefill"] == \
        before["flash_prefill"] + n_attn
    for i in range(9):
        assert float((lg.cpu() - lc).abs().max()) <= 1e-4, i
        tok = lc[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(lg[:, -1].argmax(-1, keepdim=True).cpu(), tok)
        if i < 8:
            lc, cc = cpu.decode_step(cc, tok, p + 40 + i)
            lg, cg = card.decode_step(cg, tok.to(cuda), p + 40 + i)


def _mesh_greedy(model, tokens, steps):
    """Prefill and ``steps`` greedy decode steps: (every step's logits,
    ids)."""
    logits, cache = model.prefill(tokens, max_len=tokens.shape[1] + steps)
    out, ids = [logits], []
    for i in range(steps):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ids.append(tok)
        logits, cache = model.decode_step(cache, tok, tokens.shape[1] + i)
        out.append(logits)
    return torch.cat(out, 1), torch.cat(ids, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b"])
def test_cuda_one_rank_lm_mesh_equals_mesh_less(cuda, arch):
    """Over a one-rank NCCL mesh (the MoE expert-parallel) a bf16 model's
    greedy run is the mesh-less run bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer

    cfg = get_arch(arch).reduced()
    mesh = make_host_mesh(1, 1, device="cuda")
    runs = []
    for m in (None, mesh):
        gen = torch.Generator(device=cuda).manual_seed(0)
        model = Transformer(cfg, device=cuda, dtype=torch.bfloat16,
                            generator=gen, mesh=m)
        tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                               generator=torch.Generator(device=cuda)
                               .manual_seed(1))
        with torch.no_grad():
            runs.append(_mesh_greedy(model, tokens, 4))
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], runs[1][0])
    dist.destroy_process_group()


def _init_rank(rank, world, store, out):
    import pickle

    from repro_torch.launch.mesh import init_rank, make_host_mesh
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer

    init_rank(rank, world, store, device="cuda:0",
              backend="cuda:gloo,cpu:gloo")
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    res = {}
    for shape in ((1, 2), (2, 1)):
        gen = torch.Generator(device="cuda:0").manual_seed(0)
        model = Transformer(cfg, device="cuda:0", generator=gen, fsdp=True,
                            mesh=make_host_mesh(*shape, device="cuda"))
        res[shape] = {n: p.cpu() for n, p in model.named_parameters()}
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_cuda_sharded_init_is_the_full_inits_slice(cuda, tmp_path):
    """Two gloo ranks on the card draw reduced jamba (attention, Mamba2,
    MoE) over (1, 2) and (2, 1) with FSDP: each rank's tensors are its
    slices (``LMShard.cut``) of the mesh-less model's on the card."""
    import pickle

    import torch.multiprocessing as mp
    from repro_torch.models.arch import get_arch
    from repro_torch.models.sharding import LMShard
    from repro_torch.models.transformer import Transformer

    mp.spawn(_init_rank, args=(2, str(tmp_path / "store"), str(tmp_path)),
             nprocs=2)
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    full = Transformer(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    named = {n: p.cpu() for n, p in full.named_parameters()}
    for rank in range(2):
        got = pickle.load(open(tmp_path / f"rank{rank}.pkl", "rb"))
        for shape, params in got.items():
            mesh = _FakeMesh(shape, rank)
            sharded = Transformer(cfg, device="meta", mesh=mesh, fsdp=True)
            lays = sharded.param_layouts()
            for n, t in params.items():
                want = named[n] if lays[n] is None else LMShard.cut(
                    sharded.shard, named[n], lays[n])
                assert torch.equal(t, want), (shape, rank, n)


class _FakeMesh:
    """A (data, model) mesh's coordinates for ``LMShard``'s layouts and
    cuts, without a process group."""

    device_type = "meta"
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, rank):
        self.shape_ = shape
        self.coords = {"data": rank // shape[1], "model": rank % shape[1]}

    def size(self, i):
        return self.shape_[i]

    def get_local_rank(self, name):
        return self.coords[name]

    def get_group(self, name):
        return None


@pytest.mark.cuda
def test_cuda_tree_edges_read_back_as_index_pairs(cuda):
    """At d = 4096 a Boruvka tree's edge list is found on the card: the
    numpy path's list on the same adjacency, from one read of at most
    64 KiB inside the ``repro_torch.edges`` span, and one synchronising
    operation there (``set_sync_debug_mode``). A graph of more than
    d - 1 edges reads its count and pairs after and still gives the
    numpy list."""
    import warnings

    from repro_torch import trace
    from repro_torch.core import chow_liu

    d = 4096
    w = torch.rand(d, d, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(3))
    adj = chow_liu.boruvka_mst(w + w.T)
    want = chow_liu.adjacency_to_edges(adj.cpu())
    assert len(want) == d - 1
    torch.cuda.synchronize()
    with trace.recording() as recs, warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = chow_liu.adjacency_to_edges(adj)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert got == want
    (span,) = [r for r in recs if r.name == "repro_torch.edges"]
    assert span.counts["host_reads"] == 1
    assert span.counts["edges_read_bytes"] <= 65536
    assert sum("called a synchronizing" in str(x.message) for x in ws) == 1
    g = torch.rand(300, 300, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(4)) > 0.5
    g = (g | g.T).fill_diagonal_(False)
    before = trace.counts()["host_reads"]
    assert chow_liu.adjacency_to_edges(g) == chow_liu.adjacency_to_edges(
        g.cpu().numpy())
    assert trace.counts()["host_reads"] - before == 3
