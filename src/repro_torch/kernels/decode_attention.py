"""One-token GQA flash-decode against a KV cache: wrapper and launch count.

``Transformer.decode_step`` calls this wrapper on every attention layer
with the model's (B, Sbuf, Hkv, Dh) cache viewed as (B, Hkv, Sbuf, Dh)
(no copy) and ``pos`` the number of valid entries, a host int, so a
decode step needs no device-to-host sync. The kernel
(``csrc/decode_attention.cu``) keeps the online softmax in f32 and writes
q's dtype. The wrapper takes the plain version from ``ref`` for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
import operator

import torch

from . import _build, ref
from ._build import check
from .flash_prefill import HEAD_DIMS, check_operands

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, *, window: int | None = None) -> torch.Tensor:
    """Attention of one query token per head over a KV cache.

    q: (B, Hq, Dh); k, v: (B, Hkv, S, Dh) with Hkv | Hq; f32 or bf16, each
    with a unit-stride last axis and any other strides. ``pos`` (int): the
    entries ``i < pos`` are valid and, with ``window``, only those with
    ``i >= pos - window``. Returns (B, Hq, Dh) in q's dtype; with no valid
    entry it is 0.
    """
    check_operands("decode_attention", q, k, v, 3)
    b, hq, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"decode_attention: {hkv} KV heads do not divide "
                         f"{hq} query heads")
    pos = operator.index(pos)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, window=window)
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head size {dh} is not one of "
                         f"{HEAD_DIMS}")
    lo = 0 if window is None else max(0, pos - int(window))
    hi = max(0, min(pos, s_len))
    out = torch.empty((b, hq, dh), dtype=q.dtype, device=q.device)
    lib = _build.library("decode_attention", {
        "decode_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _F, _P]})
    with torch.cuda.device(q.device):
        check(lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, hq, hkv, dh, lo, hi,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream),
            "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
