"""The wire's collectives on ``torch.distributed`` (the port of the wire
half of ``repro.comm.collectives``).

``repro`` writes these for use inside ``jax.shard_map`` bodies over a
mesh axis name; here every rank is a process that calls them with the
process group of that axis (``DeviceMesh.get_group(axis)``). Each one is
a real collective on every rank count, one rank included, and moves
tensors on the device they lie on: NCCL for CUDA tensors, gloo for CPU
tensors (or for CUDA tensors under a ``"cuda:gloo"`` backend, gloo's own
transport).

* :func:`all_gather` — the tiled all-gather: every rank's block,
  concatenated along ``dim`` in rank order.
* :func:`psum` — the sum over a group.
* :func:`superposed_psum` — the multiple-access channel's sum of every
  machine's partial statistic.
* :func:`erasure_all_gather` — the gather with per-feature erasure: a
  dropped machine's entries arrive as the format's :func:`neutral_fill`.

And the compressed gradient collectives (the port of ``repro``'s
``collectives.py:26-130``): the paper's per-symbol codec applied to
gradients. A tensor is standardised by its RMS (one f32 scale) and
encoded to R-bit int8 codes by ``PerSymbolQuantizer.encode`` — the
``quantize_fused`` kernel on a CUDA tensor — so the wire carries int8
codes and one float a rank.

* :func:`quantize_tensor` / :func:`dequantize_tensor` — the codec.
* :func:`compressed_psum` — two-phase compressed all-reduce: an
  all-to-all of the codes of each rank's chunks, decode and reduce
  locally, re-quantize the reduced chunk, all-gather its codes.
* :func:`compressed_pmean`, :func:`compressed_pmean_1stage` — the mean;
  the one-stage form all-gathers the codes of the whole tensor, so each
  rank's total distortion is its own encode error.
* :func:`error_feedback_init` / :func:`error_feedback_apply` —
  error feedback (EF-SGD): compress g + e, keep the new residual.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Tiled all-gather over ``group``: the ranks' ``x`` concatenated along
    ``dim`` in rank order (``jax.lax.all_gather(..., tiled=True)``).
    gloo has no tiled gather along an inner axis, so the blocks arrive as
    a list and are concatenated; a one-rank group returns its received
    copy as it is."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' ``x`` over ``group``, on every rank (a new
    tensor; ``x`` is left as it was)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def neutral_fill(method: str, dtype) -> int:
    """The wire format's masked value — what an erased (dropped) machine's
    entries must arrive as so the center's masked estimators treat them
    as never sent: ``quantizers.MASKED_CODE`` for per-symbol int8 bin
    codes (code 0 is a real bin), 0 for signs, packed bits and raw
    values (all of which contract to nothing). The one copy of this rule:
    every channel's erasure path (:func:`erasure_all_gather` through
    ``Channel.transmit``) consults it."""
    from repro_torch.core.quantizers import MASKED_CODE

    if method == "persymbol" and dtype == torch.int8:
        return MASKED_CODE
    return 0


def superposed_psum(partial: torch.Tensor, group) -> torch.Tensor:
    """The multiple-access channel's collective: the center receives the
    SUPERPOSITION (sum) of every machine's transmitted signal — here the
    ranks' partial statistics — never the individual payloads
    (``comm.channel.MACChannel``, arXiv 1812.10437). For the
    integer-valued sign Grams the MAC plane superposes, f32 addition is
    exact in any order (values < 2^24), so the sum is bit-identical
    across rank counts."""
    return psum(partial, group)


def erasure_all_gather(payload: torch.Tensor, group, keep: torch.Tensor, *,
                       axis: int, fill: int | float = 0) -> torch.Tensor:
    """All-gather with per-feature channel ERASURE — the wire-plane form
    of machine dropout (``core.faults.FaultPlan``).

    The collective still runs (every rank takes part), but entries of
    features whose ``keep`` flag is False arrive at the center as
    ``fill``. ``keep`` is this rank's ``(..., d_loc)`` bool flags over
    its feature block (leading batch axes align with the payload's),
    aligned to ``axis``, the payload's feature axis: the last for
    sample-major int8/f32 payloads, the second-to-last for feature-major
    packed ones. ``fill`` must be the format's :func:`neutral_fill`, so
    an erased machine is bit-identical to masking before the gather.
    """
    lead = keep.ndim - 1
    shape = list(keep.shape[:lead]) + [1] * (payload.ndim - lead)
    shape[axis] = keep.shape[-1]
    masked = torch.where(
        keep.reshape(shape), payload,
        torch.tensor(fill, dtype=payload.dtype, device=payload.device))
    return all_gather(masked, group, axis)


# ---------------------------------------------------------------------------
# Compressed gradient collectives
# ---------------------------------------------------------------------------

def _standardize(g: torch.Tensor):
    g = g.to(torch.float32)
    scale = torch.sqrt(torch.mean(torch.square(g)) + 1e-30)
    return g / scale, scale


def _quantizer(rate: int):
    from repro_torch.core.quantizers import PerSymbolQuantizer

    return PerSymbolQuantizer(rate)


def quantize_tensor(g: torch.Tensor, rate: int):
    """-> (int8 codes, f32 0-d scale): ``g`` over its RMS, encoded by the
    R-bit per-symbol quantizer. The codes decode to about g / scale."""
    gn, scale = _standardize(g)
    return _quantizer(rate).encode(gn.contiguous()), scale


def dequantize_tensor(codes: torch.Tensor, scale, rate: int
                      ) -> torch.Tensor:
    """The codes' centroids times ``scale`` (f32)."""
    return _quantizer(rate).decode(codes) * scale


def _gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` stacked on a new leading axis, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def compressed_psum(g: torch.Tensor, group, rate: int) -> torch.Tensor:
    """Two-phase compressed all-reduce of ``g`` over ``group``.

    Phase 1 (reduce-scatter shape): split g into |group| chunks along
    axis 0, all-to-all the *quantized* chunks, locally reduce the decoded
    chunks. Phase 2 (all-gather shape): re-quantize the reduced chunk,
    all-gather the codes, decode. Both wire phases carry int8 codes, so
    the payload is R/32 of a float all-reduce (plus one float a rank).
    ``g``'s leading dim must be divisible by the group's size.
    """
    size = dist.get_world_size(group)
    n = g.shape[0]
    if n % size:
        raise ValueError(f"leading dim {n} not divisible by the group's "
                         f"size {size}")
    gs = g.reshape(size, n // size, *g.shape[1:])
    codes, scale = quantize_tensor(gs, rate)
    codes_x = torch.empty_like(codes)
    dist.all_to_all_single(codes_x, codes.contiguous(), group=group)
    scales = _gather_stack(scale, group)                       # (size,)
    vals = dequantize_tensor(codes_x, 1.0, rate)
    chunk = torch.sum(vals * scales.view((-1,) + (1,) * (vals.dim() - 1)),
                      dim=0)
    c2, s2 = quantize_tensor(chunk, rate)
    c2_all = _gather_stack(c2, group)
    s2_all = _gather_stack(s2, group)
    out = dequantize_tensor(c2_all, 1.0, rate) * s2_all.view(
        (-1,) + (1,) * chunk.dim())
    return out.reshape(g.shape)


def compressed_pmean(g: torch.Tensor, group, rate: int) -> torch.Tensor:
    return compressed_psum(g, group, rate) / dist.get_world_size(group)


def compressed_pmean_1stage(g: torch.Tensor, group, rate: int
                            ) -> torch.Tensor:
    """Single-quantization compressed mean: all-gather the codes of g and
    decode and average locally. Each rank's total distortion is exactly
    its own encode error — what error feedback needs (the two-stage path
    re-quantizes the reduced chunk, an error no single rank owns)."""
    codes, scale = quantize_tensor(g, rate)
    codes_all = _gather_stack(codes, group)                    # (size, n)
    scales = _gather_stack(scale, group)                       # (size,)
    vals = dequantize_tensor(codes_all, 1.0, rate)
    vals = vals * scales.view((-1,) + (1,) * (vals.dim() - 1))
    return torch.mean(vals, dim=0)


def _map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def error_feedback_init(grads):
    """Zero residuals shaped as ``grads``."""
    return _map(torch.zeros_like, grads)


def error_feedback_apply(grads, residuals, group, rate: int):
    """Compress (g + e) per leaf, communicate (the one-stage mean), keep
    the new residual: (the communicated gradients, the residuals)."""

    def one(g, e):
        target = (g + e).reshape(-1)
        reduced = compressed_pmean_1stage(target, group, rate)
        codes, scale = quantize_tensor(target, rate)
        new_e = target - dequantize_tensor(codes, scale, rate)
        return reduced.reshape(g.shape), new_e.reshape(g.shape)

    pairs = []
    _map(lambda g, e: pairs.append(one(g, e)), grads, residuals)
    sent, kept = (iter([p[i] for p in pairs]) for i in (0, 1))
    return _map(lambda _: next(sent), grads), _map(lambda _: next(kept),
                                                    grads)
