"""Exactly-once ingest: wire payloads, bounded queues, sequence cursors.

A copy of ``repro.serve.ingest`` (host numpy, no device code).

The serving plane's first property is that data folds EXACTLY ONCE no
matter what the wire does. Machines stamp every payload with a
per-(tenant, machine) monotone sequence number; the center keeps one
int64 cursor per stream and accepts a payload only when it advances the
cursor. Three wire pathologies map onto that rule:

* **duplicates / replays** — ``seq <= cursor`` folds zero times (the
  dedup window is the whole history: cursors are monotone, so any replay
  of an accepted payload is recognizably old);
* **reordering** — a payload arriving early (``seq > cursor + 1``) parks
  in a bounded per-stream reorder buffer and folds, in order, when the
  gap fills;
* **loss** — a gap that outlives the reorder window (buffer overflow or
  the ``reorder_ticks`` deadline) is DECLARED: the cursor jumps past the
  missing numbers, the buffered survivors fold, and the tenant's sample
  count simply doesn't include the lost rows. That is the fault plane's
  masked n_eff degradation specialized to horizontal (sample-split) machines —
  ``estimators.weights_from_gram`` normalizes by the folded count, so a
  lossy tenant degrades gracefully instead of stalling the tick.

The same cursors make crash recovery idempotent: the fold journal
(:mod:`repro_torch.serve.journal`) records accepted payloads in acceptance
order, and replaying any superset of it through :meth:`IngestLog.replay`
folds each record at most once.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Payload:
    """One machine's quantized block on the wire.

    Exactly one of ``codes`` / ``packed`` is set:

    * ``codes`` — (n, d) int8: sign values {-1, 0, +1} (0 = masked
      entry, e.g. a faulted wire symbol — it drops out of the
      contraction), {0, 1} wire bits when ``bits=True`` (mapped to ±1 at
      fold time; 0 here is a legitimate -1, never a mask), or R-bit
      per-symbol bin indices;
    * ``packed`` — (d, ceil(n/8)) uint8: 1-bit packed signs in the
      ``quantizers.pack_codes`` layout (feature-major, little bit order,
      zero tail bits) with ``n`` giving the sample count.

    ``seq`` is 1-based and monotone per (tenant, machine) stream.
    """

    tenant: int
    machine: int
    seq: int
    codes: np.ndarray | None = None
    packed: np.ndarray | None = None
    n: int = 0
    bits: bool = False

    def __post_init__(self):
        if (self.codes is None) == (self.packed is None):
            raise ValueError("exactly one of codes/packed must be set")
        if self.bits and self.codes is None:
            raise ValueError("bits=True describes unpacked sign codes")
        if self.seq < 1:
            raise ValueError(f"seq is 1-based, got {self.seq}")
        if self.codes is not None:
            object.__setattr__(self, "codes",
                               np.ascontiguousarray(self.codes, np.int8))
            object.__setattr__(self, "n", int(self.codes.shape[0]))
        else:
            object.__setattr__(self, "packed",
                               np.ascontiguousarray(self.packed, np.uint8))
            if not 0 < self.n <= 8 * self.packed.shape[1]:
                raise ValueError(
                    f"packed payload needs 0 < n <= {8 * self.packed.shape[1]}"
                    f", got {self.n}")

    @property
    def kind(self) -> str:
        return "codes" if self.codes is not None else "packed"

    @property
    def d(self) -> int:
        return int(self.codes.shape[1] if self.codes is not None
                   else self.packed.shape[0])


class BoundedQueue:
    """Thread-safe bounded ingest queue with non-blocking backpressure.

    ``offer`` REJECTS (returns False) when full instead of blocking — the
    producer sees backpressure immediately and the tick loop is never
    blocked by a slow or bursty stream. ``drain`` pops at most
    ``max_items`` in FIFO order (the per-tick fold budget).
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self.rejected = 0

    def offer(self, item) -> bool:
        with self._lock:
            if len(self._q) >= self.capacity:
                self.rejected += 1
                return False
            self._q.append(item)
            return True

    def drain(self, max_items: int) -> list:
        out = []
        with self._lock:
            while self._q and len(out) < max_items:
                out.append(self._q.popleft())
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class IngestLog:
    """Per-(tenant, machine) exactly-once cursors + bounded reorder buffers.

    State that must survive a crash is the ``cursors`` array alone (it
    rides the snapshot); buffered out-of-order payloads are deliberately
    volatile — they were never acked, so the upstream re-delivers them.
    """

    def __init__(self, tenants: int, machines: int, *,
                 reorder_window: int = 64, reorder_ticks: int = 4):
        self.tenants = int(tenants)
        self.machines = int(machines)
        self.reorder_window = int(reorder_window)
        self.reorder_ticks = int(reorder_ticks)
        self.cursors = np.zeros((tenants, machines), np.int64)
        self.lost = np.zeros((tenants, machines), np.int64)
        self.duplicates = np.zeros(tenants, np.int64)
        self.reordered = np.zeros(tenants, np.int64)
        self._buffers: dict[tuple[int, int], dict[int, tuple[Payload, int]]]
        self._buffers = {}

    # -- live path ----------------------------------------------------------

    def offer(self, p: Payload, tick: int) -> list[Payload]:
        """Admit one delivery; returns the payloads that fold NOW, in
        fold order (the offered payload plus any buffered successors it
        unblocks). Duplicates return []."""
        t, m = p.tenant, p.machine
        if not (0 <= t < self.tenants and 0 <= m < self.machines):
            raise ValueError(f"unknown stream ({t}, {m})")
        cur = int(self.cursors[t, m])
        if p.seq <= cur:
            self.duplicates[t] += 1
            return []
        buf = self._buffers.setdefault((t, m), {})
        if p.seq in buf:
            self.duplicates[t] += 1
            return []
        if p.seq == cur + 1:
            self.cursors[t, m] = p.seq
            return [p] + self._drain_buffer(t, m)
        buf[p.seq] = (p, tick)
        if len(buf) > self.reorder_window:
            return self._declare_gap(t, m)
        return []

    def flush_overdue(self, tick: int) -> list[Payload]:
        """Expire reorder buffers whose oldest entry outlived the
        ``reorder_ticks`` deadline: declare the gap and fold the buffered
        survivors — late data degrades the tenant, never stalls it."""
        out: list[Payload] = []
        for (t, m), buf in list(self._buffers.items()):
            if not buf:
                continue
            oldest = min(entry_tick for _, entry_tick in buf.values())
            if tick - oldest >= self.reorder_ticks:
                out.extend(self._declare_gap(t, m))
        return out

    def _declare_gap(self, t: int, m: int) -> list[Payload]:
        buf = self._buffers[(t, m)]
        first = min(buf)
        self.lost[t, m] += first - int(self.cursors[t, m]) - 1
        self.cursors[t, m] = first
        p, _ = buf.pop(first)
        return [p] + self._drain_buffer(t, m)

    def _drain_buffer(self, t: int, m: int) -> list[Payload]:
        buf = self._buffers.get((t, m), {})
        out: list[Payload] = []
        while int(self.cursors[t, m]) + 1 in buf:
            q, _ = buf.pop(int(self.cursors[t, m]) + 1)
            out.append(q)
            self.cursors[t, m] += 1
            self.reordered[t] += 1
        return out

    # -- replay path --------------------------------------------------------

    def replay(self, tenant: int, machine: int, seq: int) -> bool:
        """Journal-replay admission: True iff the record still needs to
        fold (it advances the cursor). Records at or below the cursor were
        already in the restored snapshot — replaying any superset of the
        journal is therefore idempotent, which is what makes the
        crash-between-snapshot-and-rotation window safe. Gap jumps in the
        journal are reproduced exactly (the cursor jumps with them), and
        the skipped numbers are re-counted as lost so the degradation
        telemetry survives restarts too."""
        cur = int(self.cursors[tenant, machine])
        if seq <= cur:
            return False
        self.lost[tenant, machine] += seq - cur - 1
        self.cursors[tenant, machine] = seq
        return True

    # -- introspection ------------------------------------------------------

    def buffered(self) -> int:
        return sum(len(b) for b in self._buffers.values())

    def degraded_tenants(self) -> np.ndarray:
        """(T,) bool — tenants that have declared at least one lost
        payload (their estimates run from reduced effective counts)."""
        return (self.lost > 0).any(axis=1)


def split_kinds(payloads: Sequence[Payload]) -> tuple[list[Payload], list[Payload]]:
    """Stable partition into (codes, packed) — the canonical fold order
    within one batch. Both the live tick and journal replay group a
    batch this way, so the per-tenant accumulation order is identical."""
    codes = [p for p in payloads if p.kind == "codes"]
    packed = [p for p in payloads if p.kind == "packed"]
    return codes, packed
