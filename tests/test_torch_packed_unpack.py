"""The tensor-core ``sign_corr_packed``'s unpack and the quantizer's edges.

On the card ``sign_corr_packed`` unpacks sign bits to ±1 int8 bytes in
shared memory, 16 bytes (128 samples) a stage, and zeroes samples >= n;
``ref.unpack_signs_s8`` models that bit arithmetic on the CPU, and is
held here to the plain unpack. The wrapper pads the byte axis to 16-byte
rows for TMA; the plain route must not see the pad. Both kernels' plain
versions are held to ``repro``'s Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them: packed bits with non-zero pad bits
shared across rows (which ``repro``'s contract allows), and encodes of
totals that are not a multiple of 4. Tolerance: bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as j_quantize
from repro.kernels import sign_corr as j_kernels
from repro_torch import kernels
from repro_torch.core.gram import GramEngine
from repro_torch.kernels import ref
from repro_torch.kernels.sign_corr import _as_words

I = dict(interpret=True)


def _plain_s8(packed, n):
    """ref.unpack_signs_pm1 as int8, zero-padded to the model's width."""
    want = ref.unpack_signs_pm1(packed, n).to(torch.int8)
    width = 128 * -(-packed.shape[-1] // 16)
    return torch.nn.functional.pad(want, (0, width - want.shape[-1]))


@pytest.mark.parametrize("stage", [0, 1])
def test_unpack_model_every_byte_and_mask_offset(stage):
    """Row r holds byte value r at every one of 32 bytes (two stages); n
    runs over every offset 0..127 of the stage: the model's bytes equal
    the plain ±1 unpack, samples >= n 0, little bit order."""
    packed = torch.arange(256, dtype=torch.uint8)[:, None].repeat(1, 32)
    for off in range(128):
        n = 128 * stage + off
        got = ref.unpack_signs_s8(packed, n)
        assert got.dtype == torch.int8 and got.shape == (256, 256)
        assert torch.equal(got, _plain_s8(packed, n)), n


@pytest.mark.parametrize("n,nb", [(1, 1), (997, 125), (1000, 126),
                                  (2000, 250), (300, 40), (0, 3)])
def test_unpack_model_random_bits_and_gram(n, nb):
    """Random bits beyond n, byte widths off 16: the model's operand is the
    plain unpack, and its int Gram is sign_corr_packed_ref's."""
    rng = np.random.default_rng(n + nb)
    packed = torch.from_numpy(
        rng.integers(0, 256, size=(2, 19, nb)).astype(np.uint8))
    s8 = ref.unpack_signs_s8(packed, n)
    assert torch.equal(s8, _plain_s8(packed, n))
    g = torch.matmul(s8.to(torch.int64), s8.to(torch.int64).transpose(-1, -2))
    assert torch.equal(g.to(torch.float32),
                       ref.sign_corr_packed_ref(packed, n))


@pytest.mark.parametrize("shape,sl", [
    ((2, 20, 125), None),                 # byte width off 16
    ((1, 37, 32), None),                  # already aligned
    ((3, 20, 48), (slice(None), slice(None), slice(3, 40))),  # byte slice
    ((3, 40, 32), (slice(None), slice(5, 25), slice(None))),  # row slice
])
def test_wrapper_padding_leaves_the_plain_route_unchanged(shape, sl):
    """The 16-byte padding the wrapper gives the kernel (zero bytes past
    the wire's) changes nothing in the plain version's Gram, for any n up
    to and past the wire's 8 nb samples."""
    rng = np.random.default_rng(sum(shape))
    p = torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.uint8))
    if sl is not None:
        p = p[sl]
    words = _as_words(p)
    assert words.dtype == torch.int32
    padded = words.view(torch.uint8)
    assert padded.shape[-1] % 16 == 0 and padded.data_ptr() % 16 == 0
    assert all(s % 16 == 0 for s in padded.stride()[:-1])
    assert torch.equal(padded[..., :p.shape[-1]], p)
    assert not padded[..., p.shape[-1]:].any()
    nb = p.shape[-1]
    for n in (1, 8 * nb - 5, 8 * nb, 8 * nb + 9):
        want = ref.sign_corr_packed_ref(p, n)
        assert torch.equal(ref.sign_corr_packed_ref(padded, min(n, 8 * nb)),
                           want)
        assert torch.equal(kernels.sign_corr_packed(p, n), want)


@pytest.mark.parametrize("n,d,dr,b", [
    (61, 20, None, None), (997, 37, None, None), (125, 7, 13, None),
    (129, 9, None, 3), (1001, 20, 37, 2)])
def test_packed_shared_pad_bits_match_repro(n, d, dr, b):
    """Non-zero pad bits beyond n, the same in every row (repro's contract:
    they XOR to 0): the plain version and GramEngine's kernel route in
    d_tile blocks equal repro's Pallas kernel bit for bit."""
    rng = np.random.default_rng(n * d)
    lead = () if b is None else (b,)
    nb = -(-n // 8)
    pad_bits = rng.integers(0, 2, size=nb * 8 - n).astype(np.uint8)

    def packed(rows):
        bits = rng.integers(0, 2, size=(*lead, rows, nb * 8)).astype(np.uint8)
        bits[..., n:] = pad_bits
        return np.packbits(bits, axis=-1, bitorder="little")

    p = packed(d)
    q = None if dr is None else packed(dr)
    want = np.asarray(j_kernels.sign_corr_packed(
        jnp.asarray(p), n, None if q is None else jnp.asarray(q), **I))
    tp = torch.from_numpy(p)
    tq = None if q is None else torch.from_numpy(q)
    np.testing.assert_array_equal(
        kernels.sign_corr_packed(tp, n, tq).numpy(), want)
    eng = GramEngine(backend="kernel", d_tile=5)
    got = (eng.packed_sign_gram(tp, n, tq) if b is None
           else eng.packed_sign_gram_batch(tp, n, tq))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate,shape", [
    (1, (3, 5)), (2, (7, 9)), (3, (5, 3)), (4, (3, 6)), (5, (1, 7)),
    (6, (9, 11)), (7, (13, 5))])
def test_quantize_odd_totals_match_repro(rate, shape):
    """Totals of 1, 2 or 3 mod 4 (the kernel's scalar tail): codes, values
    and, where R | 8 and the row allows it, packed bytes equal repro's
    Pallas quantizer."""
    rng = np.random.default_rng(rate)
    x = rng.standard_normal(shape).astype(np.float32)
    assert x.size % 4 != 0
    x[0, :2] = [np.inf, np.nan]
    pack = 8 % rate == 0 and shape[1] % (8 // rate) == 0
    want = j_quantize.quantize_fused(jnp.asarray(x), rate, pack=pack, **I)
    got = kernels.quantize_fused(torch.from_numpy(x), rate, values=True,
                                 pack=pack)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
