"""The program's own spans (``repro_torch.trace``) over a traced run's
profiled calls, for the ``entry_*``, ``edges_ms.tree`` and
``host_reads.*`` readers.

The harness profiles whole calls of the timed entry; spans record only
while a profiler session is active, so the program's ring then holds
those calls alone (its warm and staged calls run with the profiler off).
A program without ``repro_torch.trace`` reads nothing.
"""
from __future__ import annotations

import statistics

#: the root call of each cell unit
ROOTS = {"tree": "repro_torch.learn_structure",
         "trial": "repro_torch.run_trials"}


def per_root(ctx, unit: str, fn):
    """The median over the profiled calls of ``fn(spans of one call)``
    (None where ``fn`` reads nothing), or None off the card, outside
    ``unit``'s cells, without a profile or without spans."""
    if ctx.unit != unit or ctx.profile is None or not ctx.on_card:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    vals = [fn(g) for g in trace.roots(trace.records(), ROOTS[unit])]
    vals = [v for v in vals if v is not None]
    return statistics.median(vals) if vals else None


def stage_s(spans, *names, clock: str = "seconds"):
    """The summed seconds of the spans named ``names`` (CUDA events,
    or with ``clock="host_s"`` the host clock), None if there is none."""
    got = [getattr(s, clock) for s in spans if s.name in names]
    return sum(got) if got else None


def root_count(spans, name: str) -> int:
    """Counter ``name``'s delta over the root call."""
    root = next(s for s in spans if s.id == s.root)
    return root.counts.get(name, 0)
