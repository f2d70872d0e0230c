"""Plain PyTorch versions of the port's seven kernels.

Each computes the same function as its CUDA kernel; the tiling is the
kernel's own. The wrappers in ``sign_corr.py``, ``quantize.py``,
``flash_prefill.py``, ``decode_attention.py`` and ``row_normals.py``
take these for CPU tensors (the tests run them here), and
``chip_smoke.py`` holds every kernel against its plain version on the
card. ``unpack_signs_s8`` models the tensor-core ``sign_corr_packed``'s
unpack, ``tf32_split`` and ``code_corr_tf32_ref`` the tensor-core
``code_corr``'s arithmetic, for the tests; no wrapper calls them. Nor
does any wrapper call ``decode_split_ranges`` and
``decode_attention_split_ref``, which model the split-KV
``decode_attention`` for the tests.
"""
from __future__ import annotations

import math

import torch

#: upper bound on the bool block the plain encode materialises at once
_ENCODE_BLOCK = 1 << 27


def sign_corr_ref(u: torch.Tensor, v: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """G = u^T v in f32 (v defaults to u); (n, d) or (b, n, d) operands."""
    uf = u.to(torch.float32)
    vf = uf if v is None else v.to(torch.float32)
    return torch.matmul(uf.transpose(-1, -2), vf)


def unpack_signs_pm1(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(..., d, nb) uint8 little-order sign bits -> (..., d, nb*8) f32 ±1
    with every bit at position >= n set to 0 (it drops out of a Gram)."""
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=packed.device)
    bits = (packed.unsqueeze(-1) & weights) > 0
    u = torch.where(bits, 1.0, -1.0).to(torch.float32)
    u = u.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    valid = torch.arange(u.shape[-1], device=packed.device) < n
    return torch.where(valid, u, 0.0)


def sign_corr_packed_ref(packed: torch.Tensor, n: int,
                         packed_rhs: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Unpack (..., d, nb) uint8 sign bits to ±1 (pad bits -> 0), then
    contract in f32: the sign Gram of the first ``n`` samples."""
    uf = unpack_signs_pm1(packed, n)
    vf = uf if packed_rhs is None else unpack_signs_pm1(packed_rhs, n)
    return torch.matmul(uf, vf.transpose(-1, -2))


def unpack_signs_s8(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The CUDA ``sign_corr_packed``'s int8 operand, by its own bit
    arithmetic: (..., d, nb) uint8 -> (..., d, 128 * ceil(nb / 16)) int8,
    ±1 for samples below ``n``, 0 from ``n`` on (pad bits included); ``n``
    is clamped to the 8 nb samples on the wire, as the wrapper clamps it.

    The byte axis is zero-padded to whole 16-byte stages; chunk c (bytes
    2c, 2c + 1, samples 16c .. 16c + 15) splits into nibbles q, spread to
    0/1 bytes by ``(q * 0x00204081) & 0x01010101``, mapped to ±1 by
    ``b * 0xFFFFFF02 + 0xFFFFFFFF`` (mod 2^32) and masked by the same
    spread of the chunk's valid bits times 0xFF. A model for tests; no
    wrapper calls it."""
    m32 = 0xFFFFFFFF

    def spread(q):
        return (q * 0x00204081) & 0x01010101

    n = max(0, min(int(n), 8 * packed.shape[-1]))
    p = torch.nn.functional.pad(packed, (0, (-packed.shape[-1]) % 16))
    p = p.to(torch.int64)
    chunks = p[..., 0::2] | p[..., 1::2] << 8  # (..., d, nb / 2) 16 bits
    first = 16 * torch.arange(chunks.shape[-1], device=packed.device)
    valid = (1 << (n - first).clamp(0, 16)) - 1
    words = []
    for q in range(4):
        w = (spread(chunks >> 4 * q & 0xF) * 0xFFFFFF02 + 0xFFFFFFFF) & m32
        words.append(w & spread(valid >> 4 * q & 0xF) * 0xFF)
    w = torch.stack(words, -1).unsqueeze(-1)  # (..., d, chunks, 4, 1)
    shifts = 8 * torch.arange(4, device=packed.device)
    b = (w >> shifts & 0xFF).to(torch.uint8)
    return b.reshape(*p.shape[:-1], p.shape[-1] * 8).view(torch.int8)


def row_normals_ref(keys: torch.Tensor, r0: int, r1: int, d: int,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """``core.prng``'s normals of rows r0..r1 of each (t, 2) trial key
    (row i from ``fold_in(keys[k], r0 + i)``), times ``scale[:, None, :]``
    when given: (t, r1 - r0, d) f32."""
    from repro_torch.core import prng

    rows = torch.arange(r0, r1, device=keys.device)
    z = prng.normal(prng.fold_in(keys[:, None, :], rows[None, :]), (d,))
    if scale is not None:
        z.mul_(scale[:, None, :])
    return z


def decode_codes(codes: torch.Tensor, centroids: torch.Tensor
                 ) -> torch.Tensor:
    """Centroid decode in f32; codes outside [0, L) — the -1 mask
    sentinel included — decode to 0."""
    cb = centroids.to(device=codes.device, dtype=torch.float32)
    c = codes.to(torch.int64)
    in_range = (c >= 0) & (c < cb.shape[0])
    return torch.where(in_range, cb[c.clamp(0, cb.shape[0] - 1)], 0.0)


def code_corr_ref(codes: torch.Tensor, centroids: torch.Tensor,
                  codes_rhs: torch.Tensor | None = None) -> torch.Tensor:
    """Gram of the centroid-decoded codes, rounded once to f32.

    The decoded values are the f32 centroids; the contraction runs in
    float64, so the result is the f32 rounding of the exact Gram to
    within float64 error — the yardstick the kernel's f32 sum is held to.
    """
    uf = decode_codes(codes, centroids).to(torch.float64)
    vf = uf if codes_rhs is None else decode_codes(
        codes_rhs, centroids).to(torch.float64)
    return torch.matmul(uf.transpose(-1, -2), vf).to(torch.float32)


def tf32_split(centroids) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the CUDA ``code_corr``'s 3xTF32 split of f32 values:
    hi = tf32(c), lo = tf32(c - hi), each rounded to nearest with ties
    away from zero (as ``cvt.rna.tf32.f32``), so both have their low 13
    mantissa bits zero and hi + lo = c to 2^-22 |c|. A model of the
    kernel's arithmetic, for tests; finite inputs."""

    def rna(x: torch.Tensor) -> torch.Tensor:
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    c = torch.as_tensor(centroids, dtype=torch.float32)
    hi = rna(c)
    return hi, rna(c - hi)


def code_corr_tf32_ref(codes: torch.Tensor, centroids,
                       codes_rhs: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The CUDA ``code_corr``'s three tensor-core products, summed exactly:
    hi_u^T hi_v + hi_u^T lo_v + lo_u^T hi_v in float64 over the split
    codebook (``tf32_split``; lo lo is dropped), rounded once to f32.
    What the kernel computes but for its f32 accumulation. For tests."""
    hi, lo = tf32_split(centroids)

    def dec(c, table):
        return decode_codes(c, table).to(torch.float64)

    rhs = codes if codes_rhs is None else codes_rhs
    uh, ul, vh, vl = dec(codes, hi), dec(codes, lo), dec(rhs, hi), dec(rhs, lo)
    t = lambda x: x.transpose(-1, -2)  # noqa: E731
    return (torch.matmul(t(ul), vh) + torch.matmul(t(uh), vl)
            + torch.matmul(t(uh), vh)).to(torch.float32)


def encode_ref(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """int8 bin codes: the count of ``boundaries`` strictly below x.

    A compare-and-sum (not ``searchsorted``, which places NaN elsewhere):
    NaN -> 0, +inf -> len(boundaries), an exact boundary value -> the
    lower bin. A subnormal x counts as 0.0 (``repro``'s XLA flushes
    denormals to zero). Runs over row blocks so the bool block it
    materialises stays under ``_ENCODE_BLOCK`` entries.
    """
    b = boundaries.to(device=x.device, dtype=torch.float32)
    flat = x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)
    rows = max(1, _ENCODE_BLOCK // max(1, flat.shape[-1] * b.numel()))
    out = torch.empty(flat.shape, dtype=torch.int8, device=x.device)
    tiny = torch.finfo(torch.float32).tiny
    for r0 in range(0, flat.shape[0], rows):
        blk = flat[r0:r0 + rows]
        blk = torch.where(blk.abs() < tiny, 0.0, blk)
        out[r0:r0 + rows] = (blk.unsqueeze(-1) > b).sum(-1, dtype=torch.int8)
    return out.reshape(x.shape)


def pack_codes_ref(codes: torch.Tensor, rate: int) -> torch.Tensor:
    """Pack R-bit codes densely into uint8 along the last axis, symbol i
    of a byte at bit i*R (little order). rate | 8; the last axis must be
    a multiple of 8 // rate."""
    if 8 % rate != 0:
        raise ValueError(f"rate {rate} must divide 8")
    per = 8 // rate
    n = codes.shape[-1]
    if n % per != 0:
        raise ValueError(
            f"pad to a multiple of {per} symbols before packing")
    c = codes.to(torch.uint8).reshape(*codes.shape[:-1], n // per, per)
    out = c[..., 0].clone()
    for i in range(1, per):
        out |= c[..., i] << (i * rate)
    return out


def quantize_fused_ref(x: torch.Tensor, boundaries: torch.Tensor,
                       centroids: torch.Tensor, rate: int, *,
                       values: bool = False, pack: bool = False):
    """(codes int8[, values f32][, packed uint8]) of the R-bit quantizer:
    encode, centroid decode and the dense R-bit pack along the last axis."""
    codes = encode_ref(x, boundaries)
    outs = [codes]
    if values:
        outs.append(decode_codes(codes, centroids))
    if pack:
        outs.append(pack_codes_ref(codes, rate))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _masked_softmax_pv(s: torch.Tensor, valid: torch.Tensor,
                       v: torch.Tensor, eq: str) -> torch.Tensor:
    """softmax(s masked to -1e30) @ v in f32; a row with no valid key
    gives 0 (not the mean of v that a plain softmax over -1e30 gives)."""
    p = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)
    p = p * valid.any(-1, keepdim=True)
    return torch.einsum(eq, p, v.to(torch.float32))


def scaled(s: torch.Tensor, dh: int, scale: float | None) -> torch.Tensor:
    """Scores ``s`` times the softmax scale: ``scale``, or 1/sqrt(Dh)
    (divided by sqrt(Dh), as before the scale was a parameter) when it is
    None."""
    return s / math.sqrt(dh) if scale is None else s * scale


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: float | None = None) -> torch.Tensor:
    """Naive masked softmax attention over the full sequence (GQA), math
    in f32, output in q's dtype; scores times ``scale`` (default
    1/sqrt(Dh)).

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh), Hkv | Hq. Key k is
    visible to query i when ``i >= k`` (causal) and ``k > i - window``
    (window > 0)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh).to(torch.float32)
    s = scaled(torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)),
               dh, scale)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= qpos >= kpos
    if window:
        valid &= kpos > qpos - window
    out = _masked_softmax_pv(s, valid, v, "bhgqk,bkhd->bqhgd")
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int, *, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Naive masked softmax attention for one query token per head, math
    in f32, output in q's dtype; scores times ``scale`` (default
    1/sqrt(Dh)).

    q: (B, Hq, Dh); k, v: (B, Hkv, S, Dh). Cache entry i is valid when
    ``i < pos`` and, with a window, ``i >= pos - window``."""
    b, hq, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).to(torch.float32)
    s = scaled(torch.einsum("bhgd,bhsd->bhgs", qg, k.to(torch.float32)),
               dh, scale)
    idx = torch.arange(s_len, device=q.device)
    valid = idx < pos
    if window is not None:
        valid &= idx >= pos - window
    out = _masked_softmax_pv(s, valid, v, "bhgs,bhsd->bhgd")
    return out.reshape(b, hq, dh).to(q.dtype)


#: cache entries per tile of the CUDA decode_attention
DECODE_TILE = 64


def decode_split_ranges(lo: int, hi: int, splits: int,
                        tile: int = DECODE_TILE) -> list[tuple[int, int]]:
    """The CUDA ``decode_attention``'s split of the valid range [lo, hi):
    ceil(tiles / splits) tiles of ``tile`` entries per split, in order,
    the last ones shorter or empty (start == end)."""
    tiles = -(-(hi - lo) // tile) if hi > lo else 0
    per = -(-tiles // splits)
    out = []
    for s in range(splits):
        a = min(hi, lo + s * per * tile) if hi > lo else lo
        out.append((a, max(a, min(hi, a + per * tile))))
    return out


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pos: int, *,
                               window: int | None = None,
                               splits: int = 1) -> torch.Tensor:
    """Split-KV decode attention as the CUDA kernel computes it, in f32:
    each split of ``decode_split_ranges`` gives its partial (max m, sum
    l, accumulator acc) over its entries, and the partials are combined
    in split order: out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M)
    with M the max over splits. A split with no entry has m = -inf, l = 0
    and acc = 0 and adds nothing; with no valid entry at all the output is
    0. Shapes and validity as ``decode_attention_ref``."""
    b, hq, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    lo = 0 if window is None else max(0, pos - window)
    hi = max(0, min(pos, s_len))
    qg = q.reshape(b, hkv, hq // hkv, dh).to(torch.float32) / math.sqrt(dh)
    parts = []
    for a, e in decode_split_ranges(lo, hi, splits):
        if e <= a:
            m = torch.full(qg.shape[:-1], -math.inf, device=q.device)
            parts.append((m, torch.zeros_like(m), torch.zeros_like(qg)))
            continue
        s = torch.einsum("bhgd,bhsd->bhgs", qg, k[:, :, a:e].to(torch.float32))
        m = s.amax(-1)
        p = torch.exp(s - m.unsqueeze(-1))
        parts.append((m, p.sum(-1), torch.einsum(
            "bhgs,bhsd->bhgd", p, v[:, :, a:e].to(torch.float32))))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    total = torch.zeros_like(big)
    acc = torch.zeros_like(qg)
    for m, l_s, a_s in parts:  # in split order
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - big))
        total = total + l_s * w
        acc = acc + a_s * w.unsqueeze(-1)
    out = acc / total.clamp_min(1e-30).unsqueeze(-1)
    return out.reshape(b, hq, dh).to(q.dtype)
