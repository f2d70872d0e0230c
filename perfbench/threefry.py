"""Counter-based threefry2x32 with ``jax.random``'s partitionable layout:
the reference's copy of the port's ``core.prng``, frozen here so that the
sweep's samples are worked out again outside the program.

A key is a (..., 2) int64 tensor of two uint32 words; ``fold_in(k, i)``
is threefry2x32(k, (0, i)); ``normal`` is sqrt(2) * erfinv of a uniform
in (-1, 1), with XLA's f32 erfinv (Giles' two polynomials, the log1p in
f64 and each step an f64 multiply-add rounded to f32). Every operation is
an IEEE operation, so the card and the CPU agree bit for bit.
"""
from __future__ import annotations

import math

import torch

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
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of (..., 2) keys and uint32 ``data`` (an
    int or an integer tensor), broadcast: (..., 2) keys out."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data & M32)
    return torch.stack([o1, o2], dim=-1)


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
