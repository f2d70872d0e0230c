"""The port's kernel wrappers against ``repro``'s Pallas kernels.

On the CPU each wrapper runs its plain version; the Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them. Integer paths are
bit-identical. ``code_corr`` decodes to f32 where the Pallas kernel
decodes to bf16, so it is held to ``repro``'s f32 ``xla`` reference with
a reduction-order tolerance and to the Pallas kernel with a bound of
bf16 rounding (2^-8 of each product's size). The CUDA kernels themselves
are tested on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.gram import GramEngine as JGramEngine
from repro.core.quantizers import PerSymbolQuantizer as JQuantizer
from repro.kernels import quantize as j_quantize
from repro.kernels import sign_corr as j_kernels
from repro_torch import kernels
from repro_torch.core.quantizers import PerSymbolQuantizer, codebook_tensors
from repro_torch.kernels import ref

I = dict(interpret=True)


def _signs(rng, shape):
    return rng.choice(np.array([-1, 1], np.int8), size=shape)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape_l,shape_r", [
    ((100, 20), None), ((37, 5), (37, 9)), ((3, 64, 20), None),
    ((2, 50, 12), (2, 50, 33))])
def test_sign_corr_bit_identical(shape_l, shape_r):
    rng = np.random.default_rng(sum(shape_l))
    u = _signs(rng, shape_l)
    v = None if shape_r is None else _signs(rng, shape_r)
    want = np.asarray(j_kernels.sign_corr(
        jnp.asarray(u), None if v is None else jnp.asarray(v), **I))
    got = kernels.sign_corr(_t(u), None if v is None else _t(v))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,dr,b", [
    (64, 20, None, None), (61, 20, None, None), (125, 7, 13, None),
    (61, 9, None, 3), (40, 6, 11, 2)])
def test_sign_corr_packed_bit_identical(n, d, dr, b):
    rng = np.random.default_rng(n + d)
    lead = () if b is None else (b,)
    nb = -(-n // 8)

    def packed(rows):
        bits = rng.integers(0, 2, size=(*lead, rows, nb * 8)).astype(np.uint8)
        bits[..., n:] = 0  # tail bits beyond n are zero on the wire
        return np.packbits(bits, axis=-1, bitorder="little")

    p = packed(d)
    q = None if dr is None else packed(dr)
    want = np.asarray(j_kernels.sign_corr_packed(
        jnp.asarray(p), n, None if q is None else jnp.asarray(q), **I))
    got = kernels.sign_corr_packed(_t(p), n, None if q is None else _t(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate", [2, 4, 7])
@pytest.mark.parametrize("batched,rect", [(False, False), (True, True)])
def test_code_corr_against_repro(rate, batched, rect):
    rng = np.random.default_rng(rate)
    n, d, dr = 300, 12, 17
    lead = (3,) if batched else ()
    codes = rng.integers(-1, 1 << rate, size=(*lead, n, d)).astype(np.int8)
    rhs = (rng.integers(-1, 1 << rate, size=(*lead, n, dr)).astype(np.int8)
           if rect else None)
    cb = JQuantizer(rate).centroids_np
    eng = JGramEngine(backend="xla")
    jfn = eng.code_gram_batch if batched else eng.code_gram
    want = np.asarray(jfn(jnp.asarray(codes), cb,
                          None if rhs is None else jnp.asarray(rhs)))
    got = kernels.code_corr(_t(codes), cb, None if rhs is None else _t(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * n)
    # the Pallas kernel decodes to bf16 (8 mantissa bits): each product
    # may move by 2^-8 of its size, so the bound is 2^-8 * |U|^T |V|
    pallas = np.asarray(j_kernels.code_corr(
        jnp.asarray(codes), jnp.asarray(cb),
        None if rhs is None else jnp.asarray(rhs), **I))
    dec = ref.decode_codes(_t(codes), _t(cb)).abs().double()
    dec_r = dec if rhs is None else ref.decode_codes(_t(rhs), _t(cb)).abs(
        ).double()
    bound = 2.0 ** -8 * torch.matmul(dec.transpose(-1, -2), dec_r).numpy()
    assert (np.abs(got.numpy() - pallas) <= bound + 1e-5 * n).all()


@pytest.mark.parametrize("rate", [1, 2, 4, 3, 7])
def test_quantize_fused_bit_identical(rate):
    rng = np.random.default_rng(rate)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    b = JQuantizer(rate).boundaries
    x[1, :b.shape[0]] = np.asarray(b)[:64]
    pack = 8 % rate == 0
    want = j_quantize.quantize_fused(jnp.asarray(x), rate, pack=pack, **I)
    got = kernels.quantize_fused(_t(x), rate, values=True, pack=pack)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    codes_only = kernels.quantize_fused(_t(x), rate)
    np.testing.assert_array_equal(codes_only.numpy(), np.asarray(want[0]))


def test_encode_ref_nan_and_bounded_blocks(monkeypatch):
    """NaN encodes to 0 (a compare-and-sum, not searchsorted), and the
    row-blocked loop gives the one-block answer."""
    x = torch.randn(33, 17, generator=torch.Generator().manual_seed(1))
    x[3, 4] = float("nan")
    b, _ = codebook_tensors(3, "cpu")
    whole = ref.encode_ref(x, b)
    assert int(whole[3, 4]) == 0
    monkeypatch.setattr(ref, "_ENCODE_BLOCK", 17 * 7 * 2)
    torch.testing.assert_close(ref.encode_ref(x, b), whole, rtol=0, atol=0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    u = torch.ones(8, 4, dtype=torch.int8)
    with pytest.raises(TypeError):
        kernels.sign_corr(u.float())
    with pytest.raises(ValueError):
        kernels.sign_corr(u, torch.ones(9, 4, dtype=torch.int8)[None])
    with pytest.raises(TypeError):
        kernels.sign_corr_packed(u, 32)
    with pytest.raises(ValueError):
        kernels.sign_corr_packed(torch.zeros(3, 4, dtype=torch.uint8), 32,
                                 torch.zeros(3, 5, dtype=torch.uint8))
    with pytest.raises(ValueError):
        kernels.code_corr(u, np.zeros(129, np.float32))
    with pytest.raises(ValueError):
        kernels.quantize_fused(torch.zeros(4, 6), 3, pack=True)
    with pytest.raises(ValueError):
        kernels.quantize_fused(torch.zeros(4, 6), 2, pack=True)
    with pytest.raises(ValueError):
        kernels.quantize_fused(torch.zeros(4, 8), 8)


def test_plain_versions_launch_nothing():
    kernels.reset_launches()
    u = torch.ones(16, 4, dtype=torch.int8)
    kernels.sign_corr(u)
    kernels.code_corr(u, np.array([-1.0, 0.0, 1.0], np.float32))
    kernels.sign_corr_packed(torch.zeros(4, 2, dtype=torch.uint8), 16)
    PerSymbolQuantizer(2).encode(torch.zeros(4, 4))
    assert kernels.launches() == {k: 0 for k in kernels.WRAPPERS}
