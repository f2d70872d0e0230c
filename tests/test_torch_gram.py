"""The port's GramEngine against ``repro``'s on shared numpy inputs.

Sign, packed and rate-1 code Grams are bit-identical on every backend and
under d-tiling / n-chunking; rate >= 2 code Grams match ``repro``'s f32
``xla`` backend within a reduction-order tolerance.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import gram as j_gram
from repro.core.quantizers import PerSymbolQuantizer as JQuantizer
from repro_torch.core import gram as t_gram

BACKENDS = ("kernel", "torch", "numpy")
JE = j_gram.GramEngine(backend="xla")


def _engine(backend, **kw):
    return t_gram.GramEngine(backend=backend, device="cpu", **kw)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _signs(rng, shape):
    return rng.choice(np.array([-1, 0, 1], np.int8), size=shape)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tiling", [{}, {"d_tile": 16, "n_chunk": 64}])
def test_sign_gram_bit_identical(backend, tiling):
    rng = np.random.default_rng(0)
    u, v = _signs(rng, (300, 37)), _signs(rng, (300, 21))
    ub, vb = _signs(rng, (3, 200, 37)), _signs(rng, (3, 200, 21))
    eng = _engine(backend, **tiling)
    cases = [(eng.gram(torch.from_numpy(u)), JE.gram(jnp.asarray(u))),
             (eng.gram(u, v), JE.gram(jnp.asarray(u), jnp.asarray(v))),
             (eng.gram_batch(torch.from_numpy(ub), torch.from_numpy(vb)),
              JE.gram_batch(jnp.asarray(ub), jnp.asarray(vb)))]
    for got, want in cases:
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [256, 253])
def test_packed_gram_bit_identical(backend, n):
    rng = np.random.default_rng(n)
    nb = -(-n // 8)
    bits = rng.integers(0, 2, size=(3, 40, nb * 8)).astype(np.uint8)
    bits[..., n:] = 0
    p = np.packbits(bits, axis=-1, bitorder="little")
    for tiling in ({}, {"d_tile": 16, "n_chunk": 64}):
        eng = _engine(backend, **tiling)
        np.testing.assert_array_equal(
            _np(eng.packed_sign_gram(torch.from_numpy(p[0]), n)),
            np.asarray(JE.packed_sign_gram(jnp.asarray(p[0]), n)))
        np.testing.assert_array_equal(
            _np(eng.packed_sign_gram_batch(p, n, p[:, :13])),
            np.asarray(JE.packed_sign_gram_batch(jnp.asarray(p), n,
                                                 jnp.asarray(p[:, :13]))))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rate", [1, 2, 5])
def test_code_gram_against_repro(backend, rate):
    rng = np.random.default_rng(rate)
    n = 400
    codes = rng.integers(-1, 1 << rate, size=(n, 30)).astype(np.int8)
    cb = JQuantizer(rate).centroids_np
    eng = _engine(backend, d_tile=16)
    got = _np(eng.code_gram(torch.from_numpy(codes), cb))
    want = np.asarray(JE.code_gram(jnp.asarray(codes), cb))
    batch = _np(eng.code_gram_batch(codes[None], cb, codes[None, :, :7]))
    want_b = np.asarray(JE.code_gram_batch(jnp.asarray(codes[None]), cb,
                                           jnp.asarray(codes[None, :, :7])))
    if rate == 1:  # the 2-level codebook rides the integer sign Gram
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(batch, want_b)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * n)
        np.testing.assert_allclose(batch, want_b, rtol=1e-5, atol=1e-5 * n)


def test_f32_values_contract_in_f32():
    x = np.random.default_rng(3).standard_normal((128, 24)).astype(np.float32)
    for backend in BACKENDS:
        got = _np(_engine(backend).gram(x))
        np.testing.assert_allclose(got, np.asarray(JE.gram(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5 * 128)


def test_auto_resolves_from_the_operands():
    eng = t_gram.GramEngine()
    assert eng.resolve(torch.zeros(2)) == "torch"
    assert t_gram.GramEngine(device="cpu").resolve(np.zeros(2)) == "torch"
    with pytest.raises(ValueError):
        t_gram.GramEngine(backend="pallas").resolve(torch.zeros(2))


def test_kernel_backend_has_no_bf16_value_gram():
    u = torch.ones(8, 4, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        _engine("kernel").gram(u)


@pytest.mark.parametrize("path", ["f32", "int8", "code", "packed"])
def test_working_set_model_matches_repro(path):
    for tb, jb in (("kernel", "pallas"), ("torch", "xla"), ("numpy", "numpy")):
        for tiling in ({}, {"d_tile": 128, "n_chunk": 4096}):
            got = t_gram.gram_working_set_bytes(
                path, 1 << 14, 1000, backend=tb,
                config=t_gram.GramConfig(**tiling), batch=2)
            want = j_gram.gram_working_set_bytes(
                path, 1 << 14, 1000, backend=jb,
                config=j_gram.GramConfig(**tiling), batch=2)
            assert got == want
