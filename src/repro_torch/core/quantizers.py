"""Quantizers for communication-constrained transmission (paper §3.1, §5).

The port of ``repro.core.quantizers``; codes and packed bytes are
bit-identical to it.

* ``sign_quantize`` / ``sign_codes`` — the sign method: 1 bit/sample,
  u = sign(x) in {-1, +1} with 0 -> +1.
* ``PerSymbolQuantizer`` — the R-bit per-symbol scheme of §5: 2^R
  equiprobable bins of N(0,1) (boundaries a_i = Phi^{-1}(i 2^{-R})) with
  centroid reconstruction points (eq. 40, sign typo corrected):
  c_i = 2^R (phi(a_i) - phi(a_{i+1})).

On a CUDA tensor ``PerSymbolQuantizer.encode`` runs the fused quantize
kernel (``kernels.quantize.quantize_fused``); on a CPU tensor its plain
version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.special import ndtri  # inverse standard-normal CDF

from repro_torch.kernels.quantize import quantize_fused
from repro_torch.kernels.ref import pack_codes_ref


def sign_bits(x: torch.Tensor) -> torch.Tensor:
    """The sign method's bits, x >= 0, with subnormals read as zero as
    ``repro`` reads them (XLA flushes denormals): x > -tiny, so -1e-45
    gives True and NaN False."""
    if not x.is_floating_point():
        return x >= 0
    return x > -torch.finfo(x.dtype).tiny


def sign_quantize(x: torch.Tensor) -> torch.Tensor:
    """Sign method: u = sign(x) in {-1, +1} (0 and subnormals map to +1),
    x's dtype."""
    return torch.where(sign_bits(x), 1.0, -1.0).to(x.dtype)


def sign_codes(x: torch.Tensor) -> torch.Tensor:
    """Sign method as int8 wire codes: {-1, +1} with 0 (and any subnormal)
    -> +1 — the dtype the Gram kernels ingest directly. Built in place on
    one int8 buffer, so the transient is x.numel() bytes of bools beside
    the result."""
    u = sign_bits(x).to(torch.int8)
    return u.mul_(2).sub_(1)


@functools.lru_cache(maxsize=None)
def _codebook_np(rate: int) -> tuple[np.ndarray, np.ndarray]:
    """(boundaries a_1..a_{2^R+1} with +-inf trimmed, centroids c_1..c_{2^R})."""
    if rate < 1 or rate > 16:
        raise ValueError(f"rate must be in [1, 16], got {rate}")
    m = 1 << rate
    probs = np.arange(0, m + 1, dtype=np.float64) / m
    a = np.empty(m + 1)
    a[0], a[-1] = -np.inf, np.inf
    a[1:-1] = ndtri(probs[1:-1])
    phi = np.exp(-np.square(np.where(np.isfinite(a), a, 0.0)) / 2.0) / np.sqrt(2 * np.pi)
    phi = np.where(np.isfinite(a), phi, 0.0)  # phi(+-inf) = 0
    centroids = m * (phi[:-1] - phi[1:])  # eq. (40), corrected sign
    return a, centroids


@functools.lru_cache(maxsize=None)
def _codebook_tensors(rate: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    a, c = _codebook_np(rate)
    return (torch.tensor(a[1:-1].astype(np.float32), device=device),
            torch.tensor(c.astype(np.float32), device=device))


def codebook_tensors(rate: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(interior boundaries, centroids) of the R-bit codebook as f32
    tensors on ``device`` — the same f32 values ``repro`` casts to."""
    return _codebook_tensors(int(rate), str(torch.device(device)))


class PerSymbolQuantizer:
    """R-bit equiprobable-bin quantizer for standard normal data (paper §5).

    R is 1..7 here: codes travel as int8 and the fused kernel keeps at
    most 128 levels on chip.
    """

    def __init__(self, rate: int):
        self.rate = int(rate)
        if not 1 <= self.rate <= 7:
            raise ValueError(f"rate must be in [1, 7], got {rate}")
        a, c = _codebook_np(self.rate)
        #: f32 host copies of the interior boundaries and the centroids
        self.boundaries_np = np.asarray(a[1:-1], dtype=np.float32)
        self.centroids_np = np.asarray(c, dtype=np.float32)

    @property
    def num_levels(self) -> int:
        return 1 << self.rate

    @property
    def codebook_variance(self) -> float:
        """sigma_u^2 — variance of the discrete reconstruction variable.
        Reconstruction distortion is E[(x-u)^2] = 1 - sigma_u^2 (eq. 41)."""
        c = np.asarray(self.centroids_np, dtype=np.float64)
        return float(np.mean(np.square(c)))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Map f32 samples to bin indices in [0, 2^R) — the R-bit messages —
        as int8 (``repro`` returns the same values as int32): the count of
        interior boundaries strictly below x, a subnormal x read as 0."""
        x = torch.as_tensor(x, dtype=torch.float32).contiguous()
        return quantize_fused(x, self.rate)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        _, cents = codebook_tensors(self.rate, codes.device)
        return cents[codes.to(torch.int64)]

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def reconstruction_distortion(rate: int) -> float:
    """Closed-form E[(x-u)^2] = 1 - sigma_u^2 for the R-bit quantizer."""
    return 1.0 - PerSymbolQuantizer(rate).codebook_variance


#: Sentinel bin code marking a masked-out (padded) sample: it matches no
#: quantizer level, so every Gram backend decodes it to 0.
MASKED_CODE = -1


def valid_sample_mask(n_pad: int, n_valid, device=None) -> torch.Tensor:
    """(n_pad,) bool mask of the valid sample rows under shape bucketing:
    rows >= n_valid are padding. ``n_valid`` may be a tensor (its device
    wins) or a python int (then ``device``, default cuda)."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device, n_valid)
    return torch.arange(n_pad, device=dev) < n_valid


def valid_row_mask(n_pad: int, n_rows) -> torch.Tensor:
    """(..., n_pad, d) bool mask of delivered rows under PER-FEATURE row
    counts, the fault plane's generalization of
    :func:`valid_sample_mask`: row i of feature j is valid iff
    i < n_rows[..., j]. ``n_rows``: the (..., d) counts a ``FaultPlan``
    draws (0 for a dropped machine's features, a truncated prefix for a
    straggler's), a tensor whose device the mask takes."""
    counts = torch.as_tensor(n_rows)
    rows = torch.arange(n_pad, device=counts.device)
    return rows[:, None] < counts[..., None, :]


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def bitpack_signs(u_pm1: torch.Tensor) -> torch.Tensor:
    """Pack {-1,+1} sign arrays along the last axis into uint8 (8
    symbols/byte, little bit order). Last axis must be a multiple of 8."""
    if u_pm1.shape[-1] % 8 != 0:
        raise ValueError("pad to a multiple of 8 symbols before packing")
    return pack_codes((u_pm1 > 0).to(torch.uint8), 1)


def bitunpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitpack_signs`; returns {-1.,+1.} float32."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) & w) > 0
    return torch.where(bits, 1.0, -1.0).to(torch.float32).reshape(
        *packed.shape[:-1], packed.shape[-1] * 8)


def pack_codes(codes: torch.Tensor, rate: int) -> torch.Tensor:
    """Pack R-bit integer codes densely into uint8 along the last axis —
    the honest wire format (R bits/symbol, paper §3). rate must divide 8;
    last axis must be a multiple of 8 // rate. Little order: symbol i of
    a byte sits at bit i*R."""
    return pack_codes_ref(codes, rate)


def unpack_codes(packed: torch.Tensor, rate: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns int32 codes."""
    return unpack_codes_u8(packed, rate).to(torch.int32)


def unpack_codes_u8(packed: torch.Tensor, rate: int) -> torch.Tensor:
    """:func:`unpack_codes` as uint8 (a quarter of the int32 bytes)."""
    per = 8 // rate
    mask = (1 << rate) - 1
    parts = [(packed >> (i * rate)) & mask for i in range(per)]
    c = torch.stack(parts, dim=-1)
    return c.reshape(*packed.shape[:-1], packed.shape[-1] * per)
