"""Fused per-symbol quantizer: wrapper and launch count.

R-bit encode (the count of interior N(0,1) bin boundaries strictly below
x), optional centroid decode and optional dense R-bit pack along the last
axis, in one pass over x (``csrc/quantize.cu``). The wrapper takes the
plain version from ``ref`` for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._build import check

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def quantize_fused(x: torch.Tensor, rate: int, *, values: bool = False,
                   pack: bool = False):
    """(codes int8[, values f32][, packed uint8]) for the R-bit quantizer.

    x: contiguous f32 of any shape (packing works along its last axis). rate in
    [1, 7] (codes fit int8). values: also return the centroid decode.
    pack: also return the dense R-bit wire payload, (..., n*R/8) uint8 —
    needs rate | 8 and the last axis a multiple of 8 / rate.

    Boundary convention: at rate 1 an exact 0.0 encodes as 0 (bins are
    ``x > a_i``), unlike ``quantizers.sign_codes``, which maps 0 to +1.
    A subnormal x encodes as 0.0 does, as in ``repro``.
    """
    from repro_torch.core.quantizers import codebook_tensors

    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError("quantize_fused takes an f32 torch tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_fused runs on cpu or cuda, not "
                         f"{x.device}")
    if not 1 <= rate <= 7:
        raise ValueError(f"rate must be in [1, 7], got {rate}")
    if pack:
        if 8 % rate != 0:
            raise ValueError(f"pack requires rate | 8, got {rate}")
        if x.dim() == 0 or x.shape[-1] % (8 // rate) != 0:
            raise ValueError(f"pad to a multiple of {8 // rate} symbols "
                             f"before packing")
    if not x.is_contiguous():
        raise ValueError("quantize_fused needs a contiguous x")
    bounds, cents = codebook_tensors(rate, x.device)
    if x.device.type == "cpu":
        return ref.quantize_fused_ref(x, bounds, cents, rate, values=values,
                                      pack=pack)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    vals = torch.empty(x.shape, dtype=torch.float32,
                       device=x.device) if values else None
    packed = None
    if pack:
        packed = torch.empty((*x.shape[:-1], x.shape[-1] * rate // 8),
                             dtype=torch.uint8, device=x.device)
    lib = _build.library("quantize", {
        "quantize_f32": [_P, _P, _P, _I, _P, _P, _P, _L, _I, _I, _P]})
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        check(lib.quantize_f32(
            x.data_ptr(), bounds.data_ptr(), cents.data_ptr(), cents.numel(),
            codes.data_ptr(), None if vals is None else vals.data_ptr(),
            None if packed is None else packed.data_ptr(), x.numel(), rate,
            sms, torch.cuda.current_stream(x.device).cuda_stream),
            "quantize_fused")
    quantize_fused.launches += 1
    outs = [codes] + ([vals] if values else []) + ([packed] if pack else [])
    return outs[0] if len(outs) == 1 else tuple(outs)


quantize_fused.launches = 0
