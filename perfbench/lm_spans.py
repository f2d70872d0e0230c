"""The program's LM spans (``repro_torch.trace``) over a traced run's
profiled prefills, for the ``*.hybrid`` span readers: each
``repro_torch.prefill`` root is one call. A program without the module
or the spans reads nothing.
"""
from __future__ import annotations

import statistics

from . import spans

ROOT = "repro_torch.prefill"


def per_prefill(ctx, fn):
    """The median over the profiled prefills of ``fn(spans of one
    call)`` (None where ``fn`` reads nothing), or None off the card,
    outside an LM cell, without a profile or without spans."""
    if ctx.unit != "token" or ctx.profile is None or not ctx.on_card:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    vals = [fn(g) for g in trace.roots(trace.records(), ROOT)]
    vals = [v for v in vals if v is not None]
    return statistics.median(vals) if vals else None


def stage_ms(ctx, name: str):
    """The summed CUDA-event ms of the spans ``name`` in one prefill
    (every layer's), median over the profiled prefills."""
    s = per_prefill(ctx, lambda g: spans.stage_s(g, name))
    return None if s is None else 1e3 * s


def stage_share(ctx, name: str, count: str, peaks: dict):
    """``count``'s floor (``ctx.counts[count]``: operations and bytes a
    prefill) over the summed time of the spans ``name`` in one prefill,
    in %, median over the profiled prefills."""
    from . import roofline

    c = ctx.counts.get(count)
    if c is None:
        return None
    return per_prefill(ctx, lambda g: roofline.share(
        c[0], c[1], spans.stage_s(g, name), ctx.device_name, peaks))
