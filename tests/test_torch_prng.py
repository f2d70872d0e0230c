"""The port's threefry (``repro_torch.core.prng``) against ``jax.random``.

Keys, ``fold_in``, ``split``, ``bits`` and ``uniform`` are held bit for
bit. Normals are held within ``NORMAL_RTOL`` relative (2^-21, about four
f32 ulps; the port evaluates XLA's erfinv algorithm with an f64 log1p),
and their signs exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.core import prng

#: |normal - jax normal| <= NORMAL_RTOL * |jax normal|
NORMAL_RTOL = 2.0 ** -21
SEEDS = (0, 1, 42, 2 ** 31 + 5, 2 ** 32 - 1)


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    jk = jax.random.key(seed)
    tk = prng.key(seed, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    for i in (0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, i).numpy(),
                                      _data(jax.random.fold_in(jk, i)))
    # chains: split of a fold, fold of a split row
    js = jax.random.split(jax.random.fold_in(jk, 3), 6)
    ts = prng.split(prng.fold_in(tk, 3), 6)
    np.testing.assert_array_equal(ts.numpy(), _data(js))
    np.testing.assert_array_equal(
        prng.fold_in(ts[4], 9).numpy(),
        _data(jax.random.fold_in(js[4], 9)))
    # split(k, m)[i] == fold_in(k, i)
    np.testing.assert_array_equal(
        ts.numpy(), prng.fold_in(prng.fold_in(tk, 3),
                                 torch.arange(6)).numpy())


def test_batched_folds_broadcast():
    jk = jax.random.key(11)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jk, jnp.arange(4, dtype=jnp.uint32))
    rows = jax.vmap(lambda k: jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        k, jnp.arange(5, dtype=jnp.uint32)))(keys)
    tkeys = prng.fold_in(prng.key(11, device="cpu"), torch.arange(4))
    trows = prng.fold_in(tkeys[:, None, :], torch.arange(5)[None, :])
    np.testing.assert_array_equal(trows.numpy(), _data(rows))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (4, 5), (2, 3, 9)])
def test_bits_and_uniform_are_bit_identical(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    tk = prng.fold_in(prng.key(seed, device="cpu"), 5)
    np.testing.assert_array_equal(
        prng.bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-1.0 + 2.0 ** -24, 1.0), (-3.0, 2.5)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        got = prng.uniform(tk, shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_tolerance_sign_exact(seed):
    jk = jax.random.key(seed)
    tk = prng.key(seed, device="cpu")
    want = np.asarray(jax.random.normal(jk, (1 << 16,)))
    got = prng.normal(tk, (1 << 16,)).numpy()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    # mostly equal outright
    assert np.mean(got == want) > 0.95


def test_erfinv_tracks_xla():
    u = prng.uniform(prng.key(9, device="cpu"), (1 << 16,),
                     minval=-1.0 + 2.0 ** -24)
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(u.numpy())))
    got = prng.erfinv(u).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


def test_key_rejects_seeds_outside_uint32():
    with pytest.raises(ValueError, match="seed"):
        prng.key(-1, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        prng.key(1 << 32, device="cpu")
