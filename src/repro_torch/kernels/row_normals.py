"""Row-keyed standard normals of the trial plane: wrapper and launch count.

Element (k, i, j) of ``row_normals(keys, r0, r1, d, scale)`` is
``scale[k, j] * sqrt(2) * erfinv(u)``, u the uniform in (-1, 1) drawn from
``prng.bits(prng.fold_in(keys[k], r0 + i), (d,))[j]``: the normals of
``core.prng`` for rows r0..r1 of each trial, bit for bit, in one pass that
writes each normal once (``csrc/row_normals.cu``). The wrapper takes the
plain version from ``ref`` for a CPU tensor; for a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._build import check

_P, _L = ctypes.c_void_p, ctypes.c_longlong


def row_normals(keys: torch.Tensor, r0: int, r1: int, d: int,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """(t, r1 - r0, d) f32 normals of the (t, 2) int64 trial ``keys``
    (uint32 words), row i of trial k from ``fold_in(keys[k], r0 + i)``,
    each times ``scale[k, j]`` when a (t, d) f32 ``scale`` is given."""
    if not isinstance(keys, torch.Tensor) or keys.dtype != torch.int64:
        raise TypeError("row_normals takes (t, 2) int64 torch keys")
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (t, 2), got {tuple(keys.shape)}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_normals runs on cpu or cuda, not "
                         f"{keys.device}")
    r0, r1, d = int(r0), int(r1), int(d)
    if not 0 <= r0 <= r1:
        raise ValueError(f"rows must satisfy 0 <= r0 <= r1, got {r0}, {r1}")
    if not 0 <= d < 1 << 32:
        raise ValueError("at most 2^32 draws a key")
    t = keys.shape[0]
    if scale is not None:
        if not isinstance(scale, torch.Tensor) or \
                scale.dtype != torch.float32:
            raise TypeError("row_normals takes an f32 torch scale")
        if tuple(scale.shape) != (t, d):
            raise ValueError(f"scale must be ({t}, {d}), got "
                             f"{tuple(scale.shape)}")
        if scale.device != keys.device:
            raise ValueError(f"scale on {scale.device}, keys on "
                             f"{keys.device}")
    if keys.device.type == "cpu":
        return ref.row_normals_ref(keys, r0, r1, d, scale)
    keys = keys.contiguous()
    scale = None if scale is None else scale.contiguous()
    out = torch.empty((t, r1 - r0, d), dtype=torch.float32,
                      device=keys.device)
    lib = _build.library("row_normals", {
        "row_normals_f32": [_P, _P, _P, _L, _L, _L, _L, _P]})
    with torch.cuda.device(keys.device):
        check(lib.row_normals_f32(
            keys.data_ptr(), None if scale is None else scale.data_ptr(),
            out.data_ptr(), t, r1 - r0, d, r0,
            torch.cuda.current_stream(keys.device).cuda_stream),
            "row_normals")
    row_normals.launches += 1
    return out


row_normals.launches = 0
