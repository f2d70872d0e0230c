"""Full-sequence GQA flash attention (prefill and training): wrapper,
launch count and gradient.

``repro``'s LM prefill calls its Pallas ``flash_prefill`` on every
attention layer when it runs on its accelerator; the port calls this
wrapper on every attention layer of ``Transformer.prefill`` and of the
training ``Transformer.forward``. The kernel (``csrc/flash_prefill.cu``)
keeps the online softmax in f32 and writes q's dtype. The wrapper takes
the plain version from ``ref`` for a CPU tensor; for a CUDA tensor it
launches the kernel or raises; a meta tensor takes the dry run's
stand-in (``meta``) or raises.

When q, k or v needs a gradient the wrapper runs as a
``torch.autograd.Function``: the same forward on detached inputs, and
:func:`flash_prefill_backward`, the gradient of the same attention in
PyTorch, one query chunk at a time (``repro`` differentiates its jnp
``_flash_attn`` the same way; it has no backward kernel). Under
``torch.utils.checkpoint`` the forward runs again in the backward, and
so launches the kernel again.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, meta, ref
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
        if t.device.type not in ("cpu", "cuda", "meta"):
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


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (chunked loops over
    sequences whose length need not be a power of two)."""
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """GQA attention of every query row over the keys it sees.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) with Hkv | Hq; f32 or bf16,
    each with a unit-stride last axis and any other strides. Key j is
    visible to query i when ``i >= j`` (``causal``) and ``j > i - window``
    (``window > 0``). The softmax is of q.k times ``scale`` (default
    1/sqrt(Dh)). Returns (B, Sq, Hq, Dh) in q's dtype; a row that sees no
    key is 0. Differentiable in q, k and v.
    """
    check_operands("flash_prefill", q, k, v, 4)
    hq, hkv = q.shape[2], k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"flash_prefill: {hkv} KV heads do not divide "
                         f"{hq} query heads")
    window = int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashPrefill.apply(q, k, v, bool(causal), window, scale)
    return _forward(q, k, v, bool(causal), window, scale)


class _FlashPrefill(torch.autograd.Function):
    """The kernel's forward (the plain version on the CPU) and the
    PyTorch gradient of the same attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale):
        out = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_prefill_backward(q, k, v, out, dout,
                                            causal=ctx.causal,
                                            window=ctx.window,
                                            scale=ctx.scale)
        return dq, dk, dv, None, None, None


#: query rows a backward chunk holds (``repro``'s ``_flash_attn`` q_chunk)
Q_CHUNK = 1024


def flash_prefill_backward(q, k, v, out, dout, *, causal: bool = True,
                           window: int = 0, scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_prefill` given its output ``out`` and
    the output's cotangent ``dout``, in the inputs' dtypes.

    One chunk of ``largest_divisor(Sq, Q_CHUNK)`` query rows at a time,
    in f32: recompute the scores of the keys the chunk can see under the
    same mask and their softmax P (a key outside that range has P = 0
    exactly), D = rowsum(dO * O), dV += P^T dO, dS = P * (dO V^T - D),
    dQ = dS K / sqrt(Dh), dK += dS^T Q / sqrt(Dh) (times ``scale`` where
    one is given, as the scores), each summed over the GQA group into its
    KV head. The peak is O(B * Hq * chunk * Skv).
    """
    f32 = torch.float32
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    og = out.reshape(b, sq, hkv, g, dh)
    dog = dout.reshape(b, sq, hkv, g, dh)
    kf, vf = k.to(f32), v.to(f32)
    dq = torch.zeros((b, sq, hkv, g, dh), dtype=f32, device=q.device)
    dk = torch.zeros((b, skv, hkv, dh), dtype=f32, device=q.device)
    dv = torch.zeros((b, skv, hkv, dh), dtype=f32, device=q.device)
    qc = largest_divisor(sq, Q_CHUNK)
    for i0 in range(0, sq, qc):
        i1 = i0 + qc
        lo = max(0, i0 - window + 1) if window else 0
        hi = min(skv, i1) if causal else skv
        if hi <= lo:
            continue    # no row of the chunk sees a key: its gradient is 0
        qi, doi = qg[:, i0:i1].to(f32), dog[:, i0:i1].to(f32)
        kc, vc = kf[:, lo:hi], vf[:, lo:hi]
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        valid = torch.ones((qc, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            valid &= qpos >= kpos
        if window:
            valid &= kpos > qpos - window
        s = ref.scaled(torch.einsum("bqhgd,bkhd->bhgqk", qi, kc), dh, scale)
        p = torch.softmax(s.masked_fill_(~valid, -1e30), dim=-1)
        del s
        p.mul_(valid.any(-1, keepdim=True))
        dsum = (doi * og[:, i0:i1].to(f32)).sum(-1).permute(0, 2, 3, 1)
        dv[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, doi)
        ds = torch.einsum("bqhgd,bkhd->bhgqk", doi, vc)
        ds.sub_(dsum[..., None]).mul_(p)
        del p
        dq[:, i0:i1] = ref.scaled(torch.einsum("bhgqk,bkhd->bqhgd", ds, kc),
                                  dh, scale)
        dk[:, lo:hi] += ref.scaled(torch.einsum("bhgqk,bqhgd->bkhd", ds, qi),
                                   dh, scale)
    return (dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs :func:`flash_prefill` computes: key j
    visible to query i as its mask says."""
    i = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(i + 1, max=skv) if causal else torch.full_like(i, skv)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_prefill_cost(q, k, v, causal: bool = True, window: int = 0
                       ) -> tuple[int, int]:
    """(FLOPs, bytes) of one :func:`flash_prefill` forward: 4 Dh FLOPs a
    visible pair and query head (q.k and p.v), and q, k, v read once and
    the output written once. The dry run counts a kernel call by it; torch's
    FLOP counter does not see the kernel's launch."""
    b, sq, hq, dh = q.shape
    pairs = visible_pairs(sq, k.shape[1], causal, int(window))
    return 4 * b * hq * dh * pairs, meta.nbytes(q, k, v, q)


def _forward(q, k, v, causal: bool, window: int, scale: float | None = None
             ) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one, the
    dry run's stand-in on a meta one."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type == "meta":
        return meta.stand_in("flash_prefill", torch.empty_like(q),
                             flash_prefill_cost(q, k, v, causal, window))
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
            int(bool(causal)), window,
            1.0 / math.sqrt(dh) if scale is None else float(scale),
            torch.cuda.current_stream(q.device).cuda_stream),
            "flash_prefill")
    flash_prefill.launches += 1
    if meta.observer is not None:
        meta.observer("flash_prefill",
                      *flash_prefill_cost(q, k, v, causal, window))
    return out


flash_prefill.launches = 0
