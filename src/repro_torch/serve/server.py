"""StructureServer: the crash-safe multi-tenant estimation service.

The port of ``repro.serve.server``. Its snapshots and journal segments
are ``repro``'s formats, so either package recovers the other's
directory.

One object ties the serving plane together around a single invariant —
**every delivered sample folds exactly once**, across duplicates,
reordering, loss, backpressure and kill -9:

* producers ``submit`` payloads into a bounded queue (non-blocking
  backpressure when full);
* each ``tick`` drains a bounded budget through the exactly-once ingest
  cursors, journals the accepted payloads (append + fsync) BEFORE
  folding them — the write-ahead ordering — then folds them through one
  batched launch per payload kind and acks the producers;
* materially-changed tenants are re-solved incrementally (batched
  weights -> Boruvka) and per-tenant structure drift is counted; a
  watchdog forces a (possibly degraded) solve for tenants that missed
  their deadline so no tenant's estimate goes stale silently;
* every ``snapshot_every`` ticks the full durable state (accumulators +
  ingest cursors) is written atomically via ``checkpoint.ckpt`` and the
  journal rotates to a fresh segment.

Recovery is the same code path in reverse: load the latest snapshot,
replay surviving journal records tick-group by tick-group through the
same cursors and the same fold routine. Because accepted order is the
journal order and the fold grouping is canonical, the recovered
accumulators are BIT-IDENTICAL to the uninterrupted run's — the
acceptance gate this plane is built around.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import signal
import time

import numpy as np
import torch

from ..checkpoint import ckpt
from ..core.gram import GramEngine, resolve_engine
from .ingest import BoundedQueue, IngestLog, Payload
from .journal import (FoldJournal, prune_segments, scan_segments,
                      segment_path)
from .table import TenantTable


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static shape + policy of one serving process."""

    tenants: int
    machines: int              # streams per tenant
    d: int
    method: str = "sign"
    rate: int = 1
    block_n: int = 64          # canonical payload row bucket
    max_slots: int = 64        # largest batched fold / solve launch
    queue_capacity: int = 1024
    fold_budget: int = 256     # payload admissions per tick
    snapshot_every: int = 8    # ticks between durable snapshots
    keep_segments: int = 2     # journal segments surviving a prune
    reorder_window: int = 64   # buffered out-of-order payloads per stream
    reorder_ticks: int = 4     # ticks before a gap is declared lost
    watchdog_ticks: int = 16   # solve-deadline per tenant with fresh data
    resolve_min_new: int = 1
    resolve_fraction: float = 0.0
    #: CUSUM change-point detector on each tenant's structure-drift
    #: channel (the per-solve edge Hamming distance ``table.resolve``
    #: already counts): every solve updates
    #: ``s <- max(0, s + hamming - cusum_k)`` and an alarm fires (and
    #: resets s) when s exceeds ``cusum_h``. ``cusum_k`` is the drift
    #: allowance — the hamming a stationary tenant's re-solves may jitter
    #: by without accumulating; ``cusum_h <= 0`` disables the detector
    #: (the default — telemetry-identical to pre-CUSUM servers).
    cusum_k: float = 0.0
    cusum_h: float = 0.0
    engine: GramEngine | None = None  # None = the default (cuda) engine
    use_mesh: bool = False     # shard batched launches over local devices
    crash_after_journal_records: int | None = None  # test hook: SIGKILL


class StructureServer:
    """Durable ingest -> exactly-once fold -> incremental solve loop."""

    def __init__(self, config: ServeConfig, directory: str):
        self.config = config
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        mesh = None
        if config.use_mesh:
            from ..launch.mesh import make_tenant_mesh

            # every local card; a CPU engine's one device
            dev = resolve_engine(config.engine).device
            cpu = dev is not None and torch.device(dev).type == "cpu"
            mesh = make_tenant_mesh(config.tenants,
                                    devices=[dev] if cpu else None)
        self.table = TenantTable(
            tenants=config.tenants, d=config.d, method=config.method,
            rate=config.rate, block_n=config.block_n,
            max_slots=config.max_slots, engine=config.engine, mesh=mesh,
            resolve_min_new=config.resolve_min_new,
            resolve_fraction=config.resolve_fraction)
        self.log = IngestLog(
            config.tenants, config.machines,
            reorder_window=config.reorder_window,
            reorder_ticks=config.reorder_ticks)
        self.queue = BoundedQueue(config.queue_capacity)
        self.tick = 0
        self.snapshot_step = 0
        self.last_solve_tick = np.zeros(config.tenants, np.int64)
        self.watchdog_fires = np.zeros(config.tenants, np.int64)
        # CUSUM drift alarms: per-tenant running statistic + fired count
        # (durable — they ride the snapshot so recovery keeps the alarm
        # history, like the watchdog counters)
        self.cusum_stat = np.zeros(config.tenants, np.float64)
        self.cusum_alarms = np.zeros(config.tenants, np.int64)
        self._journaled = 0
        self.recovered_records = 0
        self.recovery_seconds = 0.0
        self.torn_segments = 0
        self.torn_bytes_dropped = 0
        self._recover()
        self.journal = FoldJournal(
            segment_path(directory, self.snapshot_step))

    # -- ingest -------------------------------------------------------------

    def submit(self, p: Payload) -> bool:
        """Producer-side entry; False = backpressure (queue full)."""
        return self.queue.offer(p)

    # -- the tick loop ------------------------------------------------------

    def run_tick(self) -> dict:
        """One service tick; returns the tick's telemetry dict."""
        self.tick += 1
        t0 = time.perf_counter()
        accepted: list[Payload] = []
        for p in self.queue.drain(self.config.fold_budget):
            accepted.extend(self.log.offer(p, self.tick))
        accepted.extend(self.log.flush_overdue(self.tick))

        # WAL ordering: durable journal BEFORE the fold touches state.
        for p in accepted:
            self.journal.append(p, self.tick)
            self._journaled += 1
            self._maybe_crash()
        if accepted:
            self.journal.sync()
        rows = self.table.fold(accepted)
        t_fold = time.perf_counter() - t0

        solve = self._solve_due()
        if self.config.snapshot_every and (
                self.tick % self.config.snapshot_every == 0):
            self.save_snapshot()
        return {
            "tick": self.tick, "accepted": len(accepted), "rows": rows,
            "fold_seconds": t_fold, "queue_depth": len(self.queue),
            "rejected": self.queue.rejected,
            "duplicates": int(self.log.duplicates.sum()),
            "reordered": int(self.log.reordered.sum()),
            "lost": int(self.log.lost.sum()),
            "degraded_tenants": int(self.log.degraded_tenants().sum()),
            "watchdog_fires": int(self.watchdog_fires.sum()),
            "cusum_alarms": int(self.cusum_alarms.sum()),
            **solve,
        }

    def _solve_due(self) -> dict:
        due = self.table.needs_resolve()
        overdue = (
            (self.table.n > self.table.solved_n)
            & (self.tick - self.last_solve_tick
               >= self.config.watchdog_ticks))
        fired = overdue & ~due
        self.watchdog_fires[fired] += 1
        due |= overdue
        idx = np.flatnonzero(due)
        stats = self._resolve_with_cusum(idx)
        self.last_solve_tick[idx] = self.tick
        return stats

    def _resolve_with_cusum(self, idx: np.ndarray) -> dict:
        """Run ``table.resolve`` and feed each solved tenant's drift
        DELTA (the edge Hamming distance of this solve vs its previous
        structure) through the CUSUM recursion. Only solved tenants
        observe — CUSUM state decays on observations, not on ticks."""
        before = self.table.drift[idx].copy()
        # a tenant's FIRST solve goes empty -> first tree (hamming = its
        # whole edge set) — a cold-start artifact, not drift: skip it
        warm = self.table.solves[idx] > 0
        stats = self.table.resolve(idx)
        if self.config.cusum_h > 0 and len(idx):
            ham = (self.table.drift[idx] - before).astype(np.float64)
            s = np.maximum(
                0.0, self.cusum_stat[idx]
                + np.where(warm, ham, 0.0) - self.config.cusum_k)
            fired = s > self.config.cusum_h
            self.cusum_alarms[idx] += fired
            s[fired] = 0.0
            self.cusum_stat[idx] = s
        return stats

    def _maybe_crash(self) -> None:
        hook = self.config.crash_after_journal_records
        if hook is not None and self._journaled >= hook:
            # Crash test hook: make the journaled-but-not-folded state
            # durable, then die without any cleanup path running.
            self.journal.sync()
            os.kill(os.getpid(), signal.SIGKILL)

    # -- durability ---------------------------------------------------------

    def _state_tree(self) -> dict:
        return {
            "table": self.table.state_tree(),
            "cursors": self.log.cursors, "lost": self.log.lost,
            "duplicates": self.log.duplicates,
            "reordered": self.log.reordered,
            "last_solve_tick": self.last_solve_tick,
            "watchdog_fires": self.watchdog_fires,
            "cusum_stat": self.cusum_stat,
            "cusum_alarms": self.cusum_alarms,
            "tick": np.asarray(self.tick, np.int64),
        }

    def save_snapshot(self) -> str:
        """Atomic snapshot + journal rotation.

        The snapshot captures everything the folds up to this tick
        produced, so the NEXT segment starts empty; older segments are
        pruned (crashing between snapshot and prune only leaves extra
        records, which replay skips via the cursors)."""
        path = ckpt.save_checkpoint(
            self.directory, self.tick, self._state_tree())
        self.snapshot_step = self.tick
        self.journal.close()
        self.journal = FoldJournal(
            segment_path(self.directory, self.snapshot_step))
        prune_segments(self.directory, self.config.keep_segments)
        return path

    def _recover(self) -> None:
        """Latest snapshot + journal replay -> bit-identical state.

        A torn tail on the newest segment (crash mid-append) is
        TRUNCATED to its last intact frame before the segment is
        reopened for append: without the repair, records appended after
        the torn garbage would be invisible to the next recovery's scan
        — acked and folded payloads silently lost on a second crash. A
        torn frame in any older segment raises
        ``JournalCorruptionError`` (see ``journal.scan_segments``).
        """
        t0 = time.perf_counter()
        step = ckpt.latest_step(self.directory)
        if step is not None:
            state = ckpt.load_checkpoint(
                self.directory, step, self._state_tree(), to_numpy=True)
            self.table.load_state(state["table"])
            self.log.cursors[...] = state["cursors"]
            self.log.lost[...] = state["lost"]
            self.log.duplicates[...] = state["duplicates"]
            self.log.reordered[...] = state["reordered"]
            self.last_solve_tick[...] = state["last_solve_tick"]
            self.watchdog_fires[...] = state["watchdog_fires"]
            self.cusum_stat[...] = state["cusum_stat"]
            self.cusum_alarms[...] = state["cusum_alarms"]
            self.tick = int(state["tick"])
            self.snapshot_step = step
        # Replay every surviving journal record through the cursors,
        # grouped by the tick it originally folded in — the fold batches
        # (and so the accumulation order) match the live run exactly.
        scans = scan_segments(self.directory)
        for scan in scans:
            if scan.torn:      # scan_segments: only the newest can be
                self.torn_segments += 1
                self.torn_bytes_dropped += (
                    scan.total_bytes - scan.valid_bytes)
                os.truncate(scan.path, scan.valid_bytes)
        for tick, group in itertools.groupby(
                (r for scan in scans for r in scan.records),
                key=lambda r: r[0]):
            replayed = [
                p for _, p in group
                if self.log.replay(p.tenant, p.machine, p.seq)]
            self.recovered_records += len(replayed)
            if replayed:
                self.table.fold(replayed)
            self.tick = max(self.tick, tick)
        self.recovery_seconds = time.perf_counter() - t0

    # -- terminal -----------------------------------------------------------

    def force_resolve(self) -> dict:
        """Solve every tenant with data (terminal / comparison state)."""
        idx = np.flatnonzero(self.table.n > 0)
        stats = self._resolve_with_cusum(idx)
        self.last_solve_tick[idx] = self.tick
        return stats

    def close(self) -> None:
        self.journal.close()

    def comparable_state(self) -> dict:
        """The bit-identity comparison surface: accumulators, counts,
        cursors and solved structures. Deliberately excludes duplicate /
        reorder / watchdog telemetry — those describe the delivery PATH,
        which a crash legitimately changes; the ESTIMATE must not."""
        return {
            "gram": self.table.gram.copy(), "n": self.table.n.copy(),
            "cursors": self.log.cursors.copy(),
            "lost": self.log.lost.copy(),
            "adj": self.table.adj.copy(),
        }
