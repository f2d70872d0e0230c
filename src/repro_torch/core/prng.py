"""Counter-based threefry2x32 with ``jax.random``'s partitionable layout.

The trial plane draws every sample, fault and flip from ``fold_in``
streams of ``jax.random`` keys. This module reproduces those streams in
plain PyTorch, so the port draws the same trials as ``repro``:

* a key is a (..., 2) int64 tensor of two uint32 words; ``key(seed)``
  is ``(0, seed)``;
* ``fold_in(k, i)`` is threefry2x32(k, (0, i)), and ``split(k, m)[i]``
  equals ``fold_in(k, i)``;
* ``bits(k, shape)`` hashes the counters (0, j) of the flat index j of
  ``shape`` and XORs the two output words;
* ``uniform`` puts the top 23 bits under the exponent of 1.0 and
  subtracts 1; ``normal`` is sqrt(2) * erfinv of a uniform in (-1, 1).

Keys, bits and uniforms are bit-identical to ``jax.random``'s. For the
erfinv this module evaluates XLA's own f32 algorithm (Giles' two
polynomials in w = -log1p(-u^2)) rather than ``torch.erfinv``, which is
off by up to ~7.5e-5 against the exact value in f32. The log1p is taken
in f64 and each polynomial step is an f64 multiply-add rounded to f32,
as XLA fuses them: the normals are then within 2 f32 ulps of
``jax.random.normal``'s (about 99% equal), and, since every step is an
IEEE operation or an f64 log1p rounded to f32, the card and the CPU
agree on them. The sign of a normal is the sign of its uniform, so it is
exact.

torch's uint32 has few operations, so each word lives in int64 and is
masked to 32 bits after every add and rotate. Every tensor is made on
the device of the keys it is given.
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: (-1, 1): the lowest f32 above -1 (``jax.random.normal``'s minval)
_NORMAL_LO = -1.0 + 2.0 ** -24
_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32).item()
#: XLA's ErfInv32 (Giles 2010): polynomial coefficients, highest first,
#: for w < 5 (in w - 2.5) and for w >= 5 (in sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r).bitwise_or_(x >> (32 - r)).bitwise_and_(M32)


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of counter words (x1, x2) under key
    words (k1, k2); all int64 holding uint32, broadcast together. The
    result words are fresh tensors of the broadcast shape."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = torch.broadcast_tensors(x1 + ks[0], x2 + ks[1])
    x1 = x1.bitwise_and(M32)
    x2 = x2.bitwise_and(M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(M32)
            x2 = _rotl(x2, r).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return x1, x2


def key(seed: int, *, device=None) -> torch.Tensor:
    """The (2,) key of ``jax.random.key(seed)`` for 0 <= seed < 2^32."""
    seed = int(seed)
    if not 0 <= seed <= M32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of (..., 2) keys and uint32 ``data`` (an
    int or an integer tensor), broadcast: (..., 2) keys out."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data & M32)
    return torch.stack([o1, o2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys, row i = ``fold_in(k, i)``."""
    return fold_in(k, torch.arange(num, device=k.device))


def bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of each of the (..., 2) keys:
    (..., *shape) int64 holding uint32."""
    shape = tuple(shape)
    count = math.prod(shape)
    if count >= 1 << 32:
        raise ValueError("at most 2^32 draws a key")
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k2 = keys[..., 1].reshape(lead + (1,) * len(shape))
    ctr = torch.arange(count, dtype=torch.int64,
                       device=keys.device).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    return b1 ^ b2


def uniform(keys: torch.Tensor, shape=(), *, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 over [minval, maxval), bit for bit.
    XLA fuses the scale and shift into one multiply-add, taken here in
    f64 (the product of two f32 is exact there) and rounded to f32."""
    b = bits(keys, shape)
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def erfinv(u: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfinv of f32 ``u`` in (-1, 1) (module docstring)."""
    w = torch.log1p(-(u * u).double()).neg_().float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = None
    for lo, hi in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, lo, hi).double()  # f32 coefficients
        p = c if p is None else (p * w).add_(c).float().double()
    return p.float() * u


def normal(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in f32: sqrt(2) * erfinv(u), u uniform in
    (-1, 1) bit for bit (the erfinv: :func:`erfinv`)."""
    u = uniform(keys, shape, minval=_NORMAL_LO, maxval=1.0)
    return erfinv(u).mul_(_SQRT2)
