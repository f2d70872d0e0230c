"""The port's attention kernel wrappers against ``repro``'s.

On the CPU each wrapper runs its plain version (``repro_torch.kernels.ref``);
it is held to ``repro.kernels.ref`` and to the Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` runs them, on the same numpy inputs.
All in f32 at ``atol=3e-5`` (the bound ``tests/test_kernels.py`` holds the
Pallas prefill kernel to: f32 sums in another order). The CUDA kernels
themselves are tested on the card by ``tests/test_torch_cuda.py``.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_prefill import flash_prefill as j_prefill
from repro_torch import kernels

I = dict(interpret=True)
ATOL = 3e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# flash_prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,hq,hkv,dh,causal,window", [
    (1, 64, 4, 4, 32, True, 0),     # MHA (G = 1)
    (2, 72, 8, 2, 32, True, 0),     # GQA G = 4, Sq not a tile multiple
    (1, 100, 4, 1, 64, True, 24),   # MQA, sliding window, ragged
    (1, 64, 4, 2, 32, False, 0),    # non-causal
    (1, 48, 8, 2, 16, False, 20),   # non-causal with a window
])
def test_flash_prefill_against_repro(b, sq, hq, hkv, dh, causal, window):
    rng = np.random.default_rng(sq + hq + dh)
    q, k, v = (_normal(rng, b, sq, hq, dh), _normal(rng, b, sq, hkv, dh),
               _normal(rng, b, sq, hkv, dh))
    got = kernels.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    assert got.shape == (b, sq, hq, dh) and got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, j_ref.flash_prefill_ref(jq, jk, jv, causal=causal,
                                        window=window))
    _close(got, j_prefill(jq, jk, jv, causal=causal, window=window,
                          block_q=32, block_k=128, **I))


def test_flash_prefill_strided_operands():
    """q, k and v may be any views with a unit-stride feature axis: a
    head slice of a fused projection and a (B, H, S, Dh) -> (B, S, H, Dh)
    transpose give exactly the result of contiguous copies (which the
    tests above hold to ``repro``)."""
    rng = np.random.default_rng(3)
    b, s, hq, hkv, dh = 2, 40, 4, 2, 32
    fused = torch.from_numpy(_normal(rng, b, s, hq + 2 * hkv, dh))
    q = fused[:, :, :hq]
    k = torch.from_numpy(_normal(rng, b, hkv, s, dh)).transpose(1, 2)
    v = fused[:, :, hq + hkv:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = kernels.flash_prefill(q, k, v, causal=True, window=0)
    want = kernels.flash_prefill(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True, window=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_prefill_rows_without_keys_are_zero():
    """A query row that sees no key (Sq > Skv with a window) gives 0, not
    NaN; the rows that see keys are unchanged."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_normal(rng, 1, 60, 2, 16))
    k = torch.from_numpy(_normal(rng, 1, 20, 1, 16))
    v = torch.from_numpy(_normal(rng, 1, 20, 1, 16))
    out = kernels.flash_prefill(q, k, v, causal=True, window=8)
    assert torch.isfinite(out).all()
    assert (out[:, 27:] == 0).all()   # rows i >= 20 + 8 - 1 see no key
    assert (out[:, :27].abs().sum(-1) > 0).all()


def _prefill_with_bf16_p(q, k, v, *, causal, window):
    """The bf16 tensor-core kernel's arithmetic in plain torch: f32 scores
    of the bf16 operands, the probabilities P rounded to bf16 before P V,
    f32 sums, the output rounded to bf16."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    valid = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        valid &= qpos >= kpos
    if window:
        valid &= kpos > qpos - window
    p = torch.exp(s.masked_fill(~valid, -math.inf)
                  - s.masked_fill(~valid, -math.inf).amax(-1, keepdim=True))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.bfloat16().float(), v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, hq, dh).bfloat16()


@pytest.mark.parametrize("window", [0, 300])
def test_flash_prefill_bf16_p_rounding_within_card_tolerance(window):
    """Rounding P to bf16 before P V (which the plain version, all f32,
    does not do) keeps a 2048-token causal prefill, with and without a
    window, within the bound ``chip_smoke.py`` holds the bf16 kernel to on
    the card: atol 1e-2, rtol 2^-7."""
    rng = np.random.default_rng(11 + window)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 2048, h, 128)).bfloat16()
               for h in (4, 1, 1))
    want = kernels.flash_prefill(q, k, v, causal=True, window=window)
    got = _prefill_with_bf16_p(q, k, v, causal=True, window=window)
    assert want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=2 ** -7)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,s,dh,pos,window", [
    (2, 4, 4, 96, 32, 50, None),     # MHA
    (2, 8, 2, 96, 32, 1, None),      # GQA G = 4, one valid entry
    (1, 8, 2, 130, 64, 130, None),   # every entry valid, S ragged
    (1, 16, 1, 200, 32, 150, 40),    # MQA with a window
    (2, 8, 2, 64, 16, 64, 16),
])
def test_decode_attention_against_repro(b, hq, hkv, s, dh, pos, window):
    rng = np.random.default_rng(s + pos)
    q, k, v = (_normal(rng, b, hq, dh), _normal(rng, b, hkv, s, dh),
               _normal(rng, b, hkv, s, dh))
    got = kernels.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), pos, window=window)
    assert got.shape == (b, hq, dh) and got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, j_ref.decode_attention_ref(jq, jk, jv, pos, window=window))
    _close(got, j_decode(jq, jk, jv, pos, window=window, block_s=128, **I))


def test_decode_attention_reads_the_model_cache_through_strides():
    """The model's (B, S, Hkv, Dh) cache viewed as (B, Hkv, S, Dh) by a
    transpose, no copy, gives what a contiguous copy gives."""
    rng = np.random.default_rng(7)
    b, hq, hkv, s, dh = 2, 8, 2, 48, 32
    q = torch.from_numpy(_normal(rng, b, hq, dh))
    ck = torch.from_numpy(_normal(rng, b, s, hkv, dh))
    cv = torch.from_numpy(_normal(rng, b, s, hkv, dh))
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    assert kt.data_ptr() == ck.data_ptr() and not kt.is_contiguous()
    got = kernels.decode_attention(q, kt, vt, 30)
    want = kernels.decode_attention(q, kt.contiguous(), vt.contiguous(), 30)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    _close(got, j_ref.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(kt.numpy()),
        jnp.asarray(vt.numpy()), 30))


def test_decode_attention_without_valid_entries_is_zero():
    """pos = 0 (and a window of 0) leaves no valid entry: the output is 0,
    not NaN (``repro``'s plain softmax would average every entry)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_normal(rng, 1, 4, 16))
    k = torch.from_numpy(_normal(rng, 1, 2, 32, 16))
    for pos, window in ((0, None), (10, 0)):
        out = kernels.decode_attention(q, k, k, pos, window=window)
        assert torch.isfinite(out).all() and (out == 0).all()


def test_wrappers_check_the_contract():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 3, 32)
    with pytest.raises(ValueError, match="divide"):
        kernels.flash_prefill(q, k, k)
    with pytest.raises(TypeError):
        kernels.flash_prefill(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="unit-stride"):
        kernels.flash_prefill(q.transpose(2, 3), q, q)
    qd, cache = torch.zeros(1, 8, 32), torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError, match="differ"):
        kernels.decode_attention(qd, cache, cache[:, :, :8], 4)
    with pytest.raises(TypeError):
        kernels.decode_attention(qd, cache, cache, 4.5)
    before = kernels.launches()
    kernels.decode_attention(qd, cache, cache, 4)
    kernels.flash_prefill(q, q, q)
    assert kernels.launches() == before  # the CPU runs no kernel
