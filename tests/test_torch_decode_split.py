"""The split-KV decode attention of the CUDA ``decode_attention``, modelled
on the CPU.

The kernel splits the valid cache range into ceil(tiles / splits) tiles
of 64 entries per split, computes each split's online-softmax partial
(max, sum, accumulator) and combines the partials in split order in the
same launch. ``ref.decode_split_ranges`` and
``ref.decode_attention_split_ref`` model that; these tests hold the model
to the plain version, to ``repro``'s plain reference and to its Pallas
kernel in interpret mode, on the same numpy inputs. All in f32 at
``atol=3e-5``, the bound ``tests/test_torch_attention.py`` holds the
port's decode attention to (f32 sums in another order). The kernel itself
is tested on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro_torch import kernels
from repro_torch.kernels import ref

ATOL = 3e-5

#: (B, Hq, Hkv, S, Dh, pos, window): groups of 1, 4 and 48, every entry
#: valid, pos = 1, and windows that leave whole splits without an entry
SHAPES = [
    (2, 4, 4, 300, 32, 300, None),   # G = 1, five tiles
    (2, 8, 2, 300, 32, 1, None),     # G = 4, one valid entry
    (1, 48, 1, 200, 64, 200, None),  # G = 48 (MQA)
    (2, 8, 2, 400, 32, 390, 70),     # window: two tiles of seven
    (1, 8, 2, 130, 16, 130, 0),      # window 0: no valid entry
]
#: 64 splits is more than any shape's tiles: most splits are empty
SPLITS = [1, 2, 7, 64]


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(b, hq, hkv, s, dh, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, hq, dh), _normal(rng, b, hkv, s, dh),
            _normal(rng, b, hkv, s, dh))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("b,hq,hkv,s,dh,pos,window", SHAPES)
def test_split_model_against_repro(b, hq, hkv, s, dh, pos, window, splits):
    q, k, v = _inputs(b, hq, hkv, s, dh, s + pos + splits)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ref.decode_attention_split_ref(tq, tk, tv, pos, window=window,
                                         splits=splits)
    assert got.shape == (b, hq, dh) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        got.numpy(), ref.decode_attention_ref(tq, tk, tv, pos,
                                              window=window).numpy(),
        atol=ATOL, rtol=0)
    if window == 0:  # repro averages every entry here; the port gives 0
        assert (got == 0).all()
        return
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_ref.decode_attention_ref(
            jq, jk, jv, pos, window=window)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_decode(jq, jk, jv, pos, window=window,
                                         block_s=128, interpret=True)),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("lo,hi,splits", [
    (0, 2064, 6), (0, 2064, 1), (10, 140, 7), (0, 1, 3), (5, 5, 3),
    (320, 390, 2), (0, 4096, 64)])
def test_split_ranges_partition_the_range(lo, hi, splits):
    """The splits cover [lo, hi) once, in order, each a whole number of
    64-entry tiles but the last non-empty one; empty ones come last."""
    ranges = ref.decode_split_ranges(lo, hi, splits)
    assert len(ranges) == splits
    covered = [i for a, e in ranges for i in range(a, e)]
    assert covered == list(range(lo, hi))
    sizes = [e - a for a, e in ranges]
    full = [x for x in sizes if x > 0]
    assert all(x % ref.DECODE_TILE == 0 for x in full[:-1])
    assert sizes == full + [0] * (splits - len(full))


def test_empty_splits_add_nothing():
    """A split without an entry contributes max -inf and sum 0: no NaN,
    and the same output as the count that leaves none empty."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 200, 32, 3))
    for pos, window in ((1, None), (150, 20), (200, None)):
        few = ref.decode_attention_split_ref(q, k, v, pos, window=window,
                                             splits=1)
        many = ref.decode_attention_split_ref(q, k, v, pos, window=window,
                                              splits=50)
        assert bool(torch.isfinite(many).all())
        torch.testing.assert_close(many, few, atol=ATOL, rtol=0)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor a forced split count changes nothing: the wrapper
    returns the plain version and launches nothing; a count below 1 is
    refused."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 8, 2, 300, 32, 5))
    before = kernels.launches()
    got = kernels.decode_attention(q, k, v, 250, window=200, splits=7)
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, k, v, 250, window=200),
        atol=0, rtol=0)
    assert kernels.launches() == before
    with pytest.raises(ValueError, match="splits"):
        kernels.decode_attention(q, k, v, 250, splits=0)


def test_workspace_counters_stay_apart_from_partials(monkeypatch):
    """The wrapper's workspace bookkeeping, with the kernel's plan stubbed:
    the counters live in an int32 buffer of their own, so that no shape's
    partials land on another's counters; a shape with more groups than
    the counters hold gets a new zeroed buffer (and every cached launch
    argument is dropped), and a smaller shape after it reuses both
    buffers."""
    mod = importlib.import_module("repro_torch.kernels.decode_attention")

    # (B of the call) -> (split count, counters, partial bytes)
    plans = {8: (4, 64, 532_480), 12: (2, 96, 399_360), 1: (1, 0, 0)}
    monkeypatch.setattr(mod, "_plan", lambda lib, q, hkv, lo, hi, splits:
                        plans[q.shape[0]])
    monkeypatch.setattr(mod, "_workspace", {})
    monkeypatch.setattr(mod, "_args", {})

    def args(b):
        q = torch.zeros(b, 32, 128)
        key = (0, 7, q.dtype, b, 32, 128, 8, 2080, 0)
        got = mod._launch_args(None, q, 8, 2080, 0, key)
        mod._args[key] = got
        return got

    assert args(1) == (None, 0, None, 0)
    c8, n8, p8, b8 = args(8)
    counters, parts = mod._workspace[(0, 7)]
    assert (n8, b8) == (64, 532_480) and counters.dtype == torch.int32
    assert counters.data_ptr() == c8 and parts.data_ptr() == p8
    counters.fill_(3)   # what a launch would never leave, to see a new one
    c12, n12, p12, b12 = args(12)
    new_counters, new_parts = mod._workspace[(0, 7)]
    assert n12 == 96 and new_counters.data_ptr() == c12 != c8
    assert bool((new_counters == 0).all())
    assert new_parts is parts and (p12, b12) == (p8, b8)
    assert len(mod._args) == 1   # the B = 8 arguments were dropped
    assert args(8) == (c12, 96, p8, 532_480)
