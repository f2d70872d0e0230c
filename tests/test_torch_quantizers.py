"""The port's quantizers and encode stage against ``repro`` on shared
numpy inputs: codes, packed bytes and payloads are bit-identical."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import estimators as j_est
from repro.core import quantizers as j_q
from repro.core.strategy import Strategy as JStrategy
from repro_torch.core import estimators as t_est
from repro_torch.core import quantizers as t_q
from repro_torch.interop import strategy_from_fields


#: f32 subnormals on both sides of 0; ``repro`` (XLA) reads them as 0.0
SUBNORMALS = [1e-45, -1e-45, 1e-40, -1e-40]


def _edge_samples(rate: int, n: int = 512, d: int = 24, seed: int = 0):
    """Normals plus +-inf, NaN, +-0.0, +-subnormals, every boundary and
    the next normal float above it."""
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    b = j_q._codebook_np(rate)[0][1:-1].astype(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0] + SUBNORMALS,
                       np.float32)
    above = np.where(b == 0, np.finfo(np.float32).tiny,
                     np.nextafter(b, np.float32(np.inf)))
    edge = np.concatenate([special, b, above.astype(np.float32)])
    x.reshape(-1)[:edge.size] = edge
    return x


@pytest.mark.parametrize("rate", range(1, 8))
def test_encode_bit_identical(rate):
    x = _edge_samples(rate, seed=rate)
    want = np.asarray(j_q.PerSymbolQuantizer(rate).encode(jnp.asarray(x)))
    got = t_q.PerSymbolQuantizer(rate).encode(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate", [1, 3, 7])
def test_codebook_and_decode(rate):
    a, c = j_q._codebook_np(rate)
    a2, c2 = t_q._codebook_np(rate)
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(c, c2)
    jq, tq = j_q.PerSymbolQuantizer(rate), t_q.PerSymbolQuantizer(rate)
    np.testing.assert_array_equal(tq.centroids_np, jq.centroids_np)
    np.testing.assert_array_equal(tq.boundaries_np, np.asarray(jq.boundaries))
    assert tq.codebook_variance == jq.codebook_variance
    x = _edge_samples(rate, seed=10 + rate)
    x = np.nan_to_num(x)
    np.testing.assert_array_equal(
        tq.quantize(torch.from_numpy(x)).numpy(),
        np.asarray(jq.quantize(jnp.asarray(x))))


def test_sign_codes_and_quantize():
    x = _edge_samples(1, seed=3)
    np.testing.assert_array_equal(
        t_q.sign_codes(torch.from_numpy(x)).numpy(),
        np.asarray(j_q.sign_codes(jnp.asarray(x))))
    np.testing.assert_array_equal(
        t_q.sign_quantize(torch.from_numpy(x)).numpy(),
        np.asarray(j_q.sign_quantize(jnp.asarray(x))))


@pytest.mark.parametrize("rate", [1, 2, 4])
def test_pack_unpack_bit_identical(rate):
    rng = np.random.default_rng(rate)
    codes = rng.integers(0, 1 << rate, size=(3, 5, 64)).astype(np.int8)
    want = np.asarray(j_q.pack_codes(jnp.asarray(codes), rate))
    got = t_q.pack_codes(torch.from_numpy(codes), rate)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_q.unpack_codes(got, rate).numpy(),
        np.asarray(j_q.unpack_codes(jnp.asarray(want), rate)))


def test_bitpack_signs_round_trip():
    rng = np.random.default_rng(5)
    u = rng.choice([-1.0, 1.0], size=(7, 40)).astype(np.float32)
    want = np.asarray(j_q.bitpack_signs(jnp.asarray(u)))
    got = t_q.bitpack_signs(torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_q.bitunpack_signs(got).numpy(), u)
    with pytest.raises(ValueError):
        t_q.bitpack_signs(torch.ones(3, 12))


def test_valid_sample_mask():
    np.testing.assert_array_equal(
        t_q.valid_sample_mask(10, 7, device="cpu").numpy(),
        np.asarray(j_q.valid_sample_mask(10, 7)))
    assert t_q.MASKED_CODE == j_q.MASKED_CODE


PAYLOAD_STRATEGIES = (
    [JStrategy(), JStrategy(wire="packed"), JStrategy("original")]
    + [JStrategy("persymbol", rate=r) for r in range(1, 8)]
    + [JStrategy("persymbol", rate=r, wire="packed") for r in (1, 2, 4)])


@pytest.mark.parametrize("s", PAYLOAD_STRATEGIES, ids=lambda s: f"{s.label}-{s.wire}")
def test_strategy_payload_bit_identical(s):
    x = _edge_samples(s.rate if s.method == "persymbol" else 1, n=256,
                      seed=7)
    x = np.nan_to_num(x, posinf=5.0, neginf=-5.0)
    ts = strategy_from_fields(dataclasses.asdict(s))
    want = np.asarray(j_est.strategy_payload(jnp.asarray(x), s))
    got = t_est.strategy_payload(torch.from_numpy(x), ts)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    # valid-length masking of a batched payload, and its central operand
    xb = np.stack([x, x[::-1].copy()])
    want = np.asarray(j_est.strategy_payload(jnp.asarray(xb), s, n_valid=200))
    got = t_est.strategy_payload(torch.from_numpy(xb), ts, n_valid=200)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_est.payload_operand(got, ts, n_valid=200).numpy(),
        np.asarray(j_est.payload_operand(jnp.asarray(want), s, n_valid=200)))


@pytest.mark.parametrize("rate", range(1, 8))
def test_subnormals_match_repro(rate):
    """``repro`` reads f32 subnormals as 0.0 (XLA's denormals-are-zero):
    each signs as +1 and encodes as 0.0 does; the port flushes them the
    same way."""
    tiny = np.array(SUBNORMALS + [0.0, -0.0], np.float32)
    xt, xj = torch.from_numpy(tiny), jnp.asarray(tiny)
    np.testing.assert_array_equal(t_q.sign_codes(xt).numpy(),
                                  np.asarray(j_q.sign_codes(xj)))
    np.testing.assert_array_equal(t_q.sign_quantize(xt).numpy(),
                                  np.asarray(j_q.sign_quantize(xj)))
    got = t_q.PerSymbolQuantizer(rate).encode(xt)
    want = np.asarray(j_q.PerSymbolQuantizer(rate).encode(xj))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == want[-1]).all()  # every subnormal encodes as 0.0


def test_encode_rejects_rates_beyond_int8():
    with pytest.raises(ValueError):
        t_q.PerSymbolQuantizer(8)
