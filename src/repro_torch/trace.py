"""Spans and counters at the port's layer boundaries.

A span names one stage of a call (``repro_torch.encode``, ``.gram``,
``.weights``, ``.mst``, ``.edges``; ``.sample``, ``.stats``,
``.readback``; the LM plane's ``.mamba``, ``.ssd``, ``.moe``,
``.experts``) under its root call (``repro_torch.learn_structure``,
``repro_torch.run_trials``, ``repro_torch.prefill``). Each record holds its name, its id, its
parent's and its root's ids, the host clock's start and end
(``time.perf_counter_ns``), its attributes and the deltas of the
counters over its interval (:func:`count`'s and the kernel wrappers'
``launches``). On a CUDA device it also holds a ``torch.cuda.Event`` pair
on the current stream, resolved only when read, so a span adds no
synchronisation.

Spans are off by default: :func:`span` then returns one shared no-op
object after a single check. They turn on inside :func:`recording` (the
operator's and the tests' entry, which yields the records) and while a
``torch.profiler`` session is active. Each span also enters
``torch.profiler.record_function``, so an operator's profiler trace
(``export_chrome_trace``) carries the spans on the device trace's own
timeline. Records go to a bounded ring (:func:`records`).

:func:`count` counters are always on (a Python int add). ``host_reads``
counts the program's explicit reads of a device tensor into a host value
(``.cpu()``, ``int(t)``): one a Boruvka round with early exit, one for a
tree's edge indices, one a sweep's read-back. ``moe_rows`` counts the
token-expert rows an MoE layer computes and ``ssd_chunks`` the chunks a
Mamba2 scan takes, both known on the host.

The state is the module's, as the kernel wrappers' ``launches`` are: the
spans sit deep in the stage functions, and every caller gets them
without passing anything down.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch

#: records the ring keeps (a sweep makes ~90 spans, a tree ~7)
RING = 4096

_ring: collections.deque = collections.deque(maxlen=RING)
_counts: collections.Counter = collections.Counter()
_ids = itertools.count(1)
_local = threading.local()
#: open :func:`recording` blocks, each a list the records go to as well
_sinks: list[list] = []
_profiler_enabled = torch._C._autograd._profiler_enabled


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the always-on counter ``name``."""
    _counts[name] += k


def counts() -> dict[str, int]:
    """The counters' values now."""
    return dict(_counts)


def _snapshot() -> dict[str, int]:
    from repro_torch.kernels import launches

    return {**_counts, **launches()}


@dataclasses.dataclass
class Span:
    """One closed span."""

    name: str
    id: int
    parent: int | None
    root: int
    attrs: dict
    t0_ns: int
    t1_ns: int = 0
    counts: dict = dataclasses.field(default_factory=dict)
    events: tuple | None = None

    @property
    def host_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def seconds(self) -> float:
        """The CUDA events' time where the span has them (waiting for the
        end event), else the host clock's."""
        if self.events is None:
            return self.host_s
        a, b = self.events
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    def offsets(self, other: "Span") -> tuple[float, float]:
        """``other``'s start and end, in seconds after this span's start,
        on the clock :attr:`seconds` uses."""
        if self.events is not None and other.events is not None:
            a = self.events[0]
            other.events[1].synchronize()
            return (a.elapsed_time(other.events[0]) / 1e3,
                    a.elapsed_time(other.events[1]) / 1e3)
        return ((other.t0_ns - self.t0_ns) / 1e9,
                (other.t1_ns - self.t0_ns) / 1e9)


class _Open:
    """A span while it is open."""

    __slots__ = ("rec", "cuda", "fn", "before")

    def __init__(self, name: str, device, attrs: dict):
        stack = _stack()
        parent = stack[-1].rec if stack else None
        sid = next(_ids)
        self.rec = Span(name, sid, parent.id if parent else None,
                        parent.root if parent else sid, attrs, 0)
        if device is None:
            self.cuda = stack[-1].cuda if stack else None
        else:
            dev = torch.device(device)
            self.cuda = dev if dev.type == "cuda" else None

    def __enter__(self):
        _stack().append(self)
        self.before = _snapshot()
        self.fn = torch.profiler.record_function(self.rec.name)
        self.fn.__enter__()
        if self.cuda is not None:
            a = torch.cuda.Event(enable_timing=True)
            a.record(torch.cuda.current_stream(self.cuda))
            self.rec.events = (a,)
        self.rec.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1_ns = time.perf_counter_ns()
        if self.cuda is not None:
            b = torch.cuda.Event(enable_timing=True)
            b.record(torch.cuda.current_stream(self.cuda))
            rec.events = (rec.events[0], b)
        self.fn.__exit__(*exc)
        after = _snapshot()
        rec.counts = {k: v - self.before.get(k, 0) for k, v in after.items()
                      if v != self.before.get(k, 0)}
        _stack().pop()
        _ring.append(rec)
        for sink in _sinks:
            sink.append(rec)
        return False


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoOp()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def span(name: str, device=None, **attrs):
    """A context manager that records one span of ``name`` (``device``:
    the device the stage runs on, the parent's where not given), or
    :data:`NOOP` while spans are off. A span opened directly inside an
    open span of the same name is folded into it."""
    if not (_sinks or _profiler_enabled()):
        return NOOP
    stack = _stack()
    if stack and stack[-1].rec.name == name:
        return NOOP
    return _Open(name, device, attrs)


@contextlib.contextmanager
def recording():
    """Turn spans on for the block; yields the list of its records, in
    the order they close (children before their parent)."""
    sink: list = []
    _sinks.append(sink)
    try:
        yield sink
    finally:
        _sinks.remove(sink)


def records() -> list[Span]:
    """The ring's records, oldest first."""
    return list(_ring)


def clear() -> None:
    """Empty the ring."""
    _ring.clear()


def roots(recs, name: str) -> list[list[Span]]:
    """The records of each root call named ``name``, one list a root in
    the order the roots closed."""
    by_root: dict[int, list[Span]] = {}
    for r in recs:
        by_root.setdefault(r.root, []).append(r)
    return [group for group in by_root.values()
            if any(r.id == r.root and r.name == name for r in group)]


def self_s(rec: Span, recs) -> float:
    """``rec``'s duration less the part of it its child spans cover."""
    iv = sorted(rec.offsets(c) for c in recs if c.parent == rec.id)
    covered, end = 0.0, 0.0
    for s, e in iv:
        s = max(s, end)
        if e > s:
            covered += e - s
            end = e
    return rec.seconds - covered
