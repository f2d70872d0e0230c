"""One-token GQA flash-decode against a KV cache: wrapper and launch count.

``Transformer.decode_step`` calls this wrapper on every attention layer
with the model's (B, Sbuf, Hkv, Dh) cache viewed as (B, Hkv, Sbuf, Dh)
(no copy) and ``pos`` the number of valid entries, a host int, so a
decode step needs no device-to-host sync. The kernel
(``csrc/decode_attention.cu``) splits the valid range across blocks,
keeps the online softmax in f32, combines the splits in the same launch
and writes q's dtype. The wrapper keeps the kernel's workspace per device
and stream: the counters that find each group's last block, in an int32
buffer of their own (zeroed when it grows, and left at 0 by every launch),
and the splits' partials in another; each grows when a shape needs more.
It takes the plain version from ``ref`` for a CPU tensor; for a CUDA
tensor it launches the kernel or raises; a meta tensor takes the dry
run's stand-in (``meta``) or raises.
"""
from __future__ import annotations

import ctypes
import math
import operator

import torch

from . import _build, meta, ref
from ._build import check
from .flash_prefill import HEAD_DIMS, check_operands

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "decode_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P, _L, _P,
                         _L, _P],
    "decode_attention_plan": [_I, _I, _I, _I, _I, _I, _I, _I,
                              ctypes.POINTER(_I), ctypes.POINTER(_L),
                              ctypes.POINTER(_L)]}

#: (counters, partials) by (device index, stream)
_workspace: dict = {}
#: launch arguments (counters, their count, partials, their bytes) by
#: (device index, stream, dtype, B, Hq, Dh, Hkv, S, forced splits);
#: emptied when a workspace grows
_args: dict = {}


def _range(pos: int, s_len: int, window: int | None) -> tuple[int, int]:
    lo = 0 if window is None else max(0, pos - int(window))
    return lo, max(0, min(pos, s_len))


def _plan(lib, q: torch.Tensor, hkv: int, lo: int, hi: int,
          splits: int) -> tuple[int, int, int]:
    """(split count, counters, partial bytes) of a launch over [lo, hi)."""
    b, hq, dh = q.shape
    count, counters, nbytes = _I(), _L(), _L()
    check(lib.decode_attention_plan(int(q.dtype == torch.bfloat16), b, hq,
                                    hkv, dh, lo, hi, splits,
                                    ctypes.byref(count),
                                    ctypes.byref(counters),
                                    ctypes.byref(nbytes)),
          "decode_attention plan")
    return count.value, counters.value, nbytes.value


def _launch_args(lib, q: torch.Tensor, hkv: int, s_len: int, splits: int,
                 key: tuple) -> tuple:
    """(counters, their count, partials, their bytes) that every range of
    this cache fits, from the workspace of ``key``'s device and stream;
    its counters grow zeroed and its partials grow when this shape needs
    more than they hold."""
    _, n_counters, part_bytes = _plan(lib, q, hkv, 0, s_len, splits)
    if n_counters == 0:
        return None, 0, None, 0
    counters, parts = _workspace.get(key[:2], (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32,
                               device=q.device)
        _args.clear()
    if parts is None or parts.numel() < part_bytes:
        parts = torch.empty(part_bytes, dtype=torch.uint8, device=q.device)
        _args.clear()
    _workspace[key[:2]] = counters, parts
    return (counters.data_ptr(), counters.numel(), parts.data_ptr(),
            parts.numel())


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, *, window: int | None = None,
                     splits: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Attention of one query token per head over a KV cache.

    q: (B, Hq, Dh); k, v: (B, Hkv, S, Dh) with Hkv | Hq; f32 or bf16, each
    with a unit-stride last axis and any other strides. ``pos`` (int): the
    entries ``i < pos`` are valid and, with ``window``, only those with
    ``i >= pos - window``. Returns (B, Hq, Dh) in q's dtype; with no valid
    entry it is 0. ``splits`` forces the kernel's split count (tests;
    splits may then hold no entry); by default it fills one wave of the
    card. On the CPU it has no effect. The softmax is of q.k times
    ``scale`` (default 1/sqrt(Dh)).
    """
    check_operands("decode_attention", q, k, v, 3)
    b, hq, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"decode_attention: {hkv} KV heads do not divide "
                         f"{hq} query heads")
    pos = operator.index(pos)
    forced = 0 if splits is None else operator.index(splits)
    if splits is not None and forced < 1:
        raise ValueError(f"decode_attention: splits must be >= 1, got "
                         f"{splits}")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, window=window,
                                        scale=scale)
    if q.device.type == "meta":
        return meta.stand_in("decode_attention", torch.empty_like(q),
                             decode_attention_cost(q, k, v, pos,
                                                   window=window))
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head size {dh} is not one of "
                         f"{HEAD_DIMS}")
    lo, hi = _range(pos, s_len, window)
    out = torch.empty((b, hq, dh), dtype=q.dtype, device=q.device)
    lib = _build.library("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        key = (q.get_device(), stream, q.dtype, b, hq, dh, hkv, s_len, forced)
        args = _args.get(key)
        if args is None:
            args = _args[key] = _launch_args(lib, q, hkv, s_len, forced, key)
        check(lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, hq, hkv, dh, lo, hi,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / math.sqrt(dh) if scale is None else float(scale), forced,
            *args, stream),
            "decode_attention")
    decode_attention.launches += 1
    if meta.observer is not None:
        meta.observer("decode_attention",
                      *decode_attention_cost(q, k, v, pos, window=window))
    return out


decode_attention.launches = 0


def decode_attention_cost(q, k, v, pos: int, *, window: int | None = None
                          ) -> tuple[int, int]:
    """(FLOPs, bytes) of one :func:`decode_attention` call: 4 Dh FLOPs a
    valid entry and query head, q and the valid K/V rows read once and
    the output written once (the dry run's count of a kernel call)."""
    b, hq, dh = q.shape
    lo, hi = _range(operator.index(pos), k.shape[2], window)
    rows = b * k.shape[1] * (hi - lo) * dh * k.element_size()
    return 4 * b * hq * dh * (hi - lo), meta.nbytes(q, q) + 2 * rows


def split_count(q: torch.Tensor, k: torch.Tensor, pos: int, *,
                window: int | None = None) -> int:
    """The split count the kernel takes for this call (CUDA tensors)."""
    if q.device.type != "cuda":
        raise ValueError("split_count: the split count is the CUDA "
                         "kernel's; q lies on " + str(q.device))
    lo, hi = _range(operator.index(pos), k.shape[2], window)
    lib = _build.library("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        return _plan(lib, q, k.shape[1], lo, hi, 0)[0]
