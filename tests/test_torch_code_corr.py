"""The 3xTF32 split of the tensor-core ``code_corr``, modelled on the CPU.

The CUDA kernel splits each centroid c into hi = tf32(c) and
lo = tf32(c - hi) (round to nearest, ties away from zero) and sums
hi hi + hi lo + lo hi on the tensor cores. ``ref.tf32_split`` and
``ref.code_corr_tf32_ref`` model that arithmetic exactly (in float64);
these tests hold the model to the f32 reference and to ``repro``'s f32
``xla`` Gram within the tolerance ``chip_smoke.py`` holds the kernel to,
1e-5 n + 1e-5 |G|. The kernel itself is tested on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.gram import GramEngine as JGramEngine
from repro.core.quantizers import PerSymbolQuantizer as JQuantizer
from repro_torch.core.quantizers import PerSymbolQuantizer
from repro_torch.kernels import ref

RATES = [2, 3, 4, 5, 6, 7]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _tolerance(n, want):
    return 1e-5 * n + 1e-5 * np.abs(want)


@pytest.mark.parametrize("rate", RATES)
def test_split_terms_are_tf32(rate):
    """hi and lo have their low 13 mantissa bits zero: the tensor core,
    which reads the top 19 bits of a .tf32 operand, reads them exactly."""
    hi, lo = ref.tf32_split(PerSymbolQuantizer(rate).centroids_np)
    assert (_bits(hi) & 0x1FFF == 0).all()
    assert (_bits(lo) & 0x1FFF == 0).all()
    assert hi.dtype == lo.dtype == torch.float32


@pytest.mark.parametrize("rate", RATES)
def test_split_is_within_2_pow_22(rate):
    c = PerSymbolQuantizer(rate).centroids_np.astype(np.float64)
    hi, lo = ref.tf32_split(c.astype(np.float32))
    err = np.abs(hi.double().numpy() + lo.double().numpy() - c)
    assert (err <= 2.0 ** -22 * np.abs(c)).all()


def test_split_rounds_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 numbers goes to the one
    of larger magnitude (round-half-even would go down here)."""
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                    3.0 + 2.0 ** -10], np.float32)
    hi, lo = ref.tf32_split(tie)
    np.testing.assert_array_equal(
        hi.numpy(), np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                              3.0 + 2.0 ** -9], np.float32))
    np.testing.assert_array_equal((hi.double() + lo.double()).numpy(),
                                  tie.astype(np.float64))


@pytest.mark.parametrize("rate", [2, 4, 7])
@pytest.mark.parametrize("batched,rect", [(False, False), (False, True),
                                          (True, True)])
def test_three_product_gram_within_tolerance(rate, batched, rect):
    """On codes with -1 sentinels (and codes >= L at R = 7's int8 range),
    the 3-product Gram is within code_tolerance of the f32 reference and
    of repro's f32 xla Gram."""
    rng = np.random.default_rng(10 * rate + 2 * batched + rect)
    n, d, dr = 3001, 24, 37
    lead = (3,) if batched else ()
    hi_code = min(1 << rate, 127)
    codes = rng.integers(-1, hi_code, size=(*lead, n, d)).astype(np.int8)
    rhs = (rng.integers(-1, hi_code, size=(*lead, n, dr)).astype(np.int8)
           if rect else None)
    cb = JQuantizer(rate).centroids_np
    tc = torch.from_numpy(codes)
    tr = None if rhs is None else torch.from_numpy(rhs)
    got = ref.code_corr_tf32_ref(tc, cb, tr).numpy()
    want = ref.code_corr_ref(tc, torch.from_numpy(cb), tr).numpy()
    assert np.abs(got - want).max() > 0  # the split is not the f32 decode
    assert (np.abs(got - want) <= _tolerance(n, want)).all()
    eng = JGramEngine(backend="xla")
    jfn = eng.code_gram_batch if batched else eng.code_gram
    jx = np.asarray(jfn(jnp.asarray(codes), cb,
                        None if rhs is None else jnp.asarray(rhs)))
    assert (np.abs(got - jx) <= _tolerance(n, jx)).all()
