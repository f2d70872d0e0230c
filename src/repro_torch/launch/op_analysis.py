"""Per-rank FLOPs, bytes, collectives and memory of one step, counted
while it runs.

The counterpart of ``repro.launch.hlo_analysis``. ``repro`` lowers and
compiles a program to XLA and parses the optimized HLO text, whose
shapes are per device after SPMD partitioning, weighting each while
body by its loop's trip count. The port has no HLO to parse: a step is
eager PyTorch on one rank, so its per-rank quantities are counted as the
step dispatches, on meta tensors for the dry run's production ranks
(nothing is allocated) or on real ones:

* ``dot_flops``: ``torch.utils.flop_counter``'s formulas, the registry
  ``FlopCounterMode`` applies, over the aten ops (matmuls, bmm, einsum's
  products), applied in the count's own dispatch mode: ``FlopCounterMode``
  itself tracks modules with multi-grad hooks, which keep each
  microbatch's checkpointed tensors alive until the step ends, so the
  peak would count them. The attention kernels' own FLOPs, which no
  formula sees (a ``ctypes`` launch), come from each wrapper's report by
  its formula (``kernels.meta``).
* ``hbm_bytes``: ``analyze``'s proxy, each op's input and output bytes,
  views and allocations skipped; ``copy_`` (a cache write into a slice)
  counts its source and the slice, not the buffer, as ``analyze``
  counts a dynamic-update-slice; the kernels' bytes by their formula.
* ``collectives``: {total_bytes, by_op, count}, the rank's result bytes
  of each all-gather, reduce-scatter and all-reduce, counted where the
  port calls them (``models.sharding``'s three collectives, the only
  ones on the LM's path).
* ``peak_bytes``: the most bytes the tensors the step made (not its
  arguments) held at once; ``largest``: the largest of them
  (``largest_shapes``' counterpart).

``repro``'s programs scan their layers (and a train step its
microbatches), and ``analyze`` weights a loop body by its trip count.
:func:`extrapolate` does the same from counts of the step over one and
two superblocks (and one and two microbatches).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import heapq
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta
from repro_torch.models import sharding

aten = torch.ops.aten

#: ops that move no bytes: allocations without a fill and metadata
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.lift_fresh.default,
               aten.detach.default, aten.alias.default}


@dataclasses.dataclass
class Count:
    """What one count saw."""
    dot_flops: float = 0.0
    kernel_flops: float = 0.0
    hbm_bytes: float = 0.0
    kernels: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0]))
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    coll_count: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    peak_bytes: int = 0
    largest: list = dataclasses.field(default_factory=list)

    @property
    def flops(self) -> float:
        return self.dot_flops + self.kernel_flops

    def collectives(self) -> dict:
        return {"total_bytes": float(sum(self.coll_bytes.values())),
                "by_op": dict(self.coll_bytes),
                "count": dict(self.coll_count)}

    def largest_tensors(self, top: int = 12) -> list:
        """[(bytes, "dtype[dims] op")] of the ``top`` largest tensors the
        step made, largest first."""
        return sorted(self.largest, reverse=True)[:top]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Ops(TorchDispatchMode):
    """Counts each aten op's bytes and tracks the storages ops make."""

    def __init__(self, count: Count, args, top: int):
        super().__init__()
        self.count, self.top = count, top
        self.held = {t.untyped_storage()._cdata for t in args}
        #: storage key -> its weak reference, whose callback frees its bytes
        self.live: dict = {}
        self.cur = 0

    def _freed(self, key, nbytes):
        def done(_):
            self.cur -= nbytes
            self.live.pop(key, None)
        return done

    def _made(self, func, outs):
        """Track the storages ``func`` made (the peak of their bytes): a
        storage's bytes count from its first op to its release."""
        c = self.count
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.held or key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = weakref.ref(st, self._freed(key, n))
            self.cur += n
            item = (n, f"{str(t.dtype).replace('torch.', '')}"
                       f"{list(t.shape)} {func.__name__}")
            if len(c.largest) < self.top:
                heapq.heappush(c.largest, item)
            elif item > c.largest[0]:
                heapq.heapreplace(c.largest, item)
        c.peak_bytes = max(c.peak_bytes, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out              # c10d: counted as collectives
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self._made(func, outs)
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            self.count.dot_flops += flops(*args, **kwargs, out_val=out)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        if func is aten.copy_.default:
            nbytes = _nbytes(args[0]) + _nbytes(args[1])
        else:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.count.hbm_bytes += nbytes
        return out


@contextlib.contextmanager
def counting(args=(), top: int = 12):
    """Count what runs inside: yields a :class:`Count`, complete when the
    block exits. ``args``: the step's arguments (parameters, moments,
    batch, cache), whose storages the peak leaves out. The garbage
    collector is paused inside (after a collection), so a tensor that a
    reference cycle holds counts until the block ends: the peak is the
    same on every run, and no lower than with collections at any time."""
    count = Count()
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()

    def kernel(name, flops, nbytes):
        k = count.kernels[name]
        k[0], k[1], k[2] = k[0] + 1, k[1] + flops, k[2] + nbytes
        count.kernel_flops += flops
        count.hbm_bytes += nbytes

    def collective(op, result):
        count.coll_bytes[op] += _nbytes(result)
        count.coll_count[op] += 1

    prev = sharding.collective_observer
    sharding.collective_observer = collective
    try:
        with meta.observing(kernel), _Ops(count, args, top):
            yield count
    finally:
        sharding.collective_observer = prev
        if was_enabled:
            gc.enable()


def extrapolate(counts: dict, depth: int, trips: int = 1,
                base: int = 1) -> Count:
    """The count of a step over ``depth`` superblocks whose microbatch loop
    runs ``trips`` times, from ``counts`` {(superblocks, trips): Count} at
    ``base`` and ``base + 1`` superblocks and 1 and 2 trips (only one of
    each where the target is 1): a step's counts are bilinear in the two,
    since every superblock and every microbatch repeats the same ops, so
    ``analyze``'s trip-count weighting of a while body is ``c(k0, 1) +
    dk (c(k1, 1) - c(k0, 1)) + dt (c(k0, 2) - c(k0, 1)) + dk dt (c(k1, 2)
    - c(k1, 1) - c(k0, 2) + c(k0, 1))``, dk = depth - base, dt = trips -
    1. The peak is linear in the superblocks, from those where it falls
    where it falls at full depth (a train step's, at the optimizer, from
    two on), over the runs of the most trips: every microbatch after the
    first repeats the second's peak."""
    k0 = base if depth > 1 else 1
    dk, dt = depth - k0, trips - 1

    def at(k, t):
        return counts[k0 + min(k - 1, 1 if dk else 0), min(t, 2 if dt else 1)]

    def lin(get):
        c11, c21, c12, c22 = (get(at(k, t)) for k, t in
                              ((1, 1), (2, 1), (1, 2), (2, 2)))
        return c11 + dk * (c21 - c11) + dt * (c12 - c11) \
            + dk * dt * (c22 - c21 - c12 + c11)

    out = Count(dot_flops=lin(lambda c: c.dot_flops),
                kernel_flops=lin(lambda c: c.kernel_flops),
                hbm_bytes=lin(lambda c: c.hbm_bytes),
                peak_bytes=at(1, 2).peak_bytes + dk * (
                    at(2, 2).peak_bytes - at(1, 2).peak_bytes),
                largest=list(at(2, 2).largest))
    for name in {n for c in counts.values() for n in c.kernels}:
        out.kernels[name] = [lin(lambda c, i=i: c.kernels[name][i])
                             for i in range(3)]
    for op in {o for c in counts.values() for o in c.coll_bytes}:
        out.coll_bytes[op] = lin(lambda c: c.coll_bytes[op])
        out.coll_count[op] = lin(lambda c: c.coll_count[op])
    return out
