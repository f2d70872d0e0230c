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
