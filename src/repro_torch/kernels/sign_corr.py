"""Gram kernels over quantized codes: wrappers and launch counts.

The central machine's hot spot (paper §4.2 eq. 8 / §5 eq. 32) is
G = U^T V over the received codes. Three CUDA kernels cover the wire
formats (sources in ``csrc/``, built by ``_build``):

* :func:`sign_corr` — int8 values (±1 signs, 0 for masked rows);
* :func:`sign_corr_packed` — bit-packed signs, unpacked to ±1 in-kernel;
* :func:`code_corr` — int8 bin codes with the centroid decode in-kernel.

Each wrapper checks its operands against the kernel's contract on either
device, then takes its plain version from ``ref`` for a CPU tensor; for a
CUDA tensor it launches the kernel or raises. Every launch adds one to the
wrapper's ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._build import check

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _batched(t: torch.Tensor, what: str) -> tuple[torch.Tensor, bool]:
    if t.dim() not in (2, 3):
        raise ValueError(f"{what} must be 2-D or batched 3-D, got shape "
                         f"{tuple(t.shape)}")
    return (t, True) if t.dim() == 3 else (t.unsqueeze(0), False)


def _check_pair(u, v, dtype, what: str):
    for t in (u, v):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} takes torch tensors, got {type(t)!r}")
        if t.dtype != dtype:
            raise TypeError(f"{what} takes {dtype} operands, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{what} operands lie on {u.device} and "
                             f"{t.device}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    if u.dim() != v.dim():
        raise ValueError(f"{what} operands disagree on batching: "
                         f"{tuple(u.shape)} vs {tuple(v.shape)}")


def _strides(t: torch.Tensor, what: str) -> tuple[int, int]:
    """(batch stride, row stride) of a (b, rows, cols) operand whose last
    axis is unit-stride (column slices of wider operands are fine)."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{what} needs a unit-stride last axis, got "
                         f"strides {t.stride()}")
    return (t.stride(0) if t.shape[0] > 1 else 0), t.stride(1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sign_corr(u: torch.Tensor, v: torch.Tensor | None = None) -> torch.Tensor:
    """G = u^T v (v defaults to u) over int8 codes, f32 out.

    u: (n, d_l) or (b, n, d_l) int8; v: (n, d_r) / (b, n, d_r) int8 with
    u's batch and n. Returns (d_l, d_r) / (b, d_l, d_r) f32. Exact in
    int32 and bit-identical to an f32 sum while |G| < 2^24.
    """
    vv = u if v is None else v
    _check_pair(u, vv, torch.int8, "sign_corr")
    ub, batched = _batched(u, "sign_corr u")
    vb, _ = _batched(vv, "sign_corr v")
    b, n, dl = ub.shape
    if vb.shape[:2] != (b, n):
        raise ValueError(f"sign_corr operands disagree on (batch, n): "
                         f"{tuple(u.shape)} vs {tuple(vv.shape)}")
    dr = vb.shape[2]
    u_sb, u_ld = _strides(ub, "sign_corr u")
    v_sb, v_ld = _strides(vb, "sign_corr v")
    if u.device.type == "cpu":
        return ref.sign_corr_ref(u, v)
    out = torch.empty((b, dl, dr), dtype=torch.float32, device=u.device)
    lib = _build.library("sign_corr", {
        "sign_corr_s8": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _P]})
    with torch.cuda.device(u.device):
        check(lib.sign_corr_s8(ub.data_ptr(), vb.data_ptr(), out.data_ptr(),
                               b, n, dl, dr, u_sb, u_ld, v_sb, v_ld,
                               _stream(u)), "sign_corr")
    sign_corr.launches += 1
    return out if batched else out[0]


sign_corr.launches = 0


def _as_words(p: torch.Tensor) -> torch.Tensor:
    """(b, d, nb) uint8 -> (b, d, nw) int32 words over the same bytes, the
    operand and its rows on 16-byte boundaries (what TMA copies): the byte
    axis zero-padded to a multiple of 16 when it is not such a view
    already. Pad bits are samples >= n, which the kernel zeroes."""
    nb = p.shape[-1]
    aligned = (nb % 16 == 0 and p.stride(-1) == 1 and p.stride(1) % 16 == 0
               and (p.shape[0] == 1 or p.stride(0) % 16 == 0)
               and p.data_ptr() % 16 == 0)
    if not aligned:
        p = torch.nn.functional.pad(p, (0, (-nb) % 16)).contiguous()
    return p.view(torch.int32)


def sign_corr_packed(packed: torch.Tensor, n: int,
                     packed_rhs: torch.Tensor | None = None) -> torch.Tensor:
    """Sign Gram straight from bit-packed signs.

    packed: (d_l, nb) or (b, d_l, nb) uint8, feature-major, little bit
    order; packed_rhs likewise with d_r rows. Bits at or past sample ``n``
    drop out, whatever they are. Returns the ±1 Gram of the first ``n``
    samples as f32, integer-exact (int8 tensor cores on the card).
    """
    rhs = packed if packed_rhs is None else packed_rhs
    _check_pair(packed, rhs, torch.uint8, "sign_corr_packed")
    if packed.shape[-1] != rhs.shape[-1]:
        raise ValueError(f"packed operands disagree on byte width: "
                         f"{tuple(packed.shape)} vs {tuple(rhs.shape)}")
    if packed.device.type == "cpu":
        return ref.sign_corr_packed_ref(packed, n, packed_rhs)
    ab, batched = _batched(packed, "sign_corr_packed packed")
    bb, _ = _batched(rhs, "sign_corr_packed packed_rhs")
    if ab.shape[0] != bb.shape[0]:
        raise ValueError("sign_corr_packed operands disagree on batch")
    # the plain version's samples: those below n of the nb * 8 on the wire
    n_eff = max(0, min(int(n), 8 * ab.shape[-1]))
    aw = _as_words(ab)
    bw = aw if packed_rhs is None else _as_words(bb)
    b, dl, nw = aw.shape
    dr = bw.shape[1]
    a_sb, a_ld = _strides(aw, "sign_corr_packed packed")
    b_sb, b_ld = _strides(bw, "sign_corr_packed packed_rhs")
    out = torch.empty((b, dl, dr), dtype=torch.float32, device=packed.device)
    lib = _build.library("sign_corr_packed", {
        "sign_corr_packed_u32":
            [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _P]})
    with torch.cuda.device(packed.device):
        check(lib.sign_corr_packed_u32(
            aw.data_ptr(), bw.data_ptr(), out.data_ptr(), b, n_eff, dl, dr,
            nw, a_sb, a_ld, b_sb, b_ld, _stream(packed)), "sign_corr_packed")
    sign_corr_packed.launches += 1
    return out if batched else out[0]


sign_corr_packed.launches = 0


def code_corr(codes: torch.Tensor, centroids, codes_rhs=None) -> torch.Tensor:
    """G = decode(codes)^T decode(codes_rhs) with the decode in-kernel.

    codes: (n, d_l) or (b, n, d_l) int8 bin indices; codes outside
    [0, L) — the -1 mask sentinel included — decode to 0. centroids:
    (L,) codebook, L <= 128, shared across the batch. Returns f32
    (d_l, d_r) / (b, d_l, d_r).
    """
    rhs = codes if codes_rhs is None else codes_rhs
    _check_pair(codes, rhs, torch.int8, "code_corr")
    cb = torch.as_tensor(centroids, dtype=torch.float32, device=codes.device)
    if cb.dim() != 1 or not 1 <= cb.shape[0] <= 128:
        raise ValueError(f"code_corr needs a (L,) codebook with L <= 128, "
                         f"got shape {tuple(cb.shape)}")
    ub, batched = _batched(codes, "code_corr codes")
    vb, _ = _batched(rhs, "code_corr codes_rhs")
    b, n, dl = ub.shape
    if vb.shape[:2] != (b, n):
        raise ValueError(f"code_corr operands disagree on (batch, n): "
                         f"{tuple(codes.shape)} vs {tuple(rhs.shape)}")
    dr = vb.shape[2]
    u_sb, u_ld = _strides(ub, "code_corr codes")
    v_sb, v_ld = _strides(vb, "code_corr codes_rhs")
    if codes.device.type == "cpu":
        return ref.code_corr_ref(codes, cb, codes_rhs)
    cb = cb.contiguous()
    out = torch.empty((b, dl, dr), dtype=torch.float32, device=codes.device)
    lib = _build.library("code_corr", {
        "code_corr_s8": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                         _P]})
    with torch.cuda.device(codes.device):
        check(lib.code_corr_s8(ub.data_ptr(), vb.data_ptr(), cb.data_ptr(),
                               cb.shape[0], out.data_ptr(), b, n, dl, dr,
                               u_sb, u_ld, v_sb, v_ld, _stream(codes)),
              "code_corr")
    code_corr.launches += 1
    return out if batched else out[0]


code_corr.launches = 0
