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

The compressed gradient collectives (``compressed_psum`` and the
error-feedback pair) belong to LM training, which the port does not
have yet.
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
