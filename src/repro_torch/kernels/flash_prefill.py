"""Full-sequence GQA flash attention (prefill): wrapper and launch count.

``repro``'s LM prefill calls its Pallas ``flash_prefill`` on every
attention layer when it runs on its accelerator; the port calls this
wrapper on every attention layer of ``Transformer.prefill``. The kernel
(``csrc/flash_prefill.cu``) keeps the online softmax in f32 and writes
q's dtype. The wrapper takes the plain version from ``ref`` for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref
from ._build import check

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: head sizes the attention kernels are instantiated for
HEAD_DIMS = (32, 48, 64, 80, 96, 112, 128)


def check_operands(what: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, q_dims: int) -> None:
    """Raise unless q (``q_dims``-D) and the 4-D k, v share a device and a
    dtype (f32 or bf16), k and v a shape, q and k a batch and a head size,
    and every feature axis has unit stride."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} takes torch tensors, got {type(t)!r}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what} takes f32 or bf16, got {name} "
                            f"{t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
        if t.dim() != (q_dims if name == "q" else 4):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{what} needs a unit-stride feature axis, got "
                             f"{name} strides {t.stride()}")
    if k.shape != v.shape:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head size")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention of every query row over the keys it sees.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) with Hkv | Hq; f32 or bf16,
    each with a unit-stride last axis and any other strides. Key j is
    visible to query i when ``i >= j`` (``causal``) and ``j > i - window``
    (``window > 0``). Returns (B, Sq, Hq, Dh) in q's dtype; a row that
    sees no key is 0.
    """
    check_operands("flash_prefill", q, k, v, 4)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"flash_prefill: {hkv} KV heads do not divide "
                         f"{hq} query heads")
    window = int(window)
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, causal=causal, window=window)
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head size {dh} is not one of "
                         f"{HEAD_DIMS}")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    lib = _build.library("flash_prefill", {
        "flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _F,
                          _P]})
    with torch.cuda.device(q.device):
        check(lib.flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, sq, skv, hq, hkv, dh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), window, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream),
            "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
