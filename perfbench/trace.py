"""Spans and the device trace of a traced run.

:class:`Spans` times the stages the benchmark calls one by one: CUDA
events on a card (the host clock on the CPU, for rehearsals), summed
within a repetition. :func:`profile` runs whole calls under
``torch.profiler`` and reads the device's busy time, the window and the
breakdown the result line carries.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

WINDOW = "perfbench.window"
#: idle gaps shorter than this (us) are summed under one name
SHORT_GAP_US = 20.0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Seconds by stage, summed within each repetition."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.reps: list[dict[str, float]] = []
        self._pending: list[tuple[str, object, object]] = []

    def repetition(self) -> None:
        """Close the current repetition (if any) and open a new one."""
        self._collect()
        self.reps.append({})

    def _collect(self) -> None:
        if not self._pending:
            return
        sync(self.device)
        cur = self.reps[-1]
        for name, a, b in self._pending:
            s = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            cur[name] = cur.get(name, 0.0) + s
        self._pending = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self._pending.append((name, a, b))

    def median(self, name: str) -> float | None:
        """Median over repetitions of a stage's seconds (None if never
        timed)."""
        self._collect()
        vals = [r[name] for r in self.reps if name in r]
        return statistics.median(vals) if vals else None


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set, not the device's copy
    of a host annotation."""
    return ("CUDA" in str(getattr(e, "device_type", ""))
            and not getattr(e, "is_user_annotation", False)
            and e.name != WINDOW)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _on_host(e) -> bool:
    return "CPU" in str(getattr(e, "device_type", ""))


def profile(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler`` on the card: {"busy_s",
    "window_s", "device_ops", "idle_gaps", "ops"}. ``busy_s`` is the union
    of the device's operations inside the window; ``device_ops`` the ten
    that took most time, ``ops`` every one's total seconds by its full
    name; an idle gap is named after the innermost host operation running
    at its middle, or ``(host: no operation)`` where the host ran Python or
    NumPy outside any."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW and _on_host(e)]
    if not win:
        raise RuntimeError("the profiler recorded no window")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
           for e in events if _is_device(e)]
    busy = _union([iv for iv in dev if iv[1] > iv[0]])
    busy_us = sum(e - s for s, e in busy)
    by_op: dict[str, float] = {}
    for e in events:
        if _is_device(e):
            by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]

    host = [e for e in events if _on_host(e) and e.name != WINDOW]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    gaps: dict[str, float] = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        name = "(short gaps)"
        if g1 - g0 >= SHORT_GAP_US:
            mid = 0.5 * (g0 + g1)
            cover = (starts <= mid) & (ends >= mid)
            name = "(host: no operation)"
            if cover.any():
                i = int(np.flatnonzero(cover)[np.argmax(starts[cover])])
                name = host[i].name
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[k[:160], v / 1e6] for k, v in device_ops],
            "idle_gaps": [[k[:160], v / 1e6] for k, v in idle],
            "ops": {k: v / 1e6 for k, v in by_op.items()}}
