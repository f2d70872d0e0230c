"""Crash-safe multi-tenant structure-estimation service (the serving
plane), the port of ``repro.serve``.

Many tenants' Gram accumulators stack on a leading batch axis
(:class:`~repro_torch.serve.table.TenantTable`), every ingest tick folds
through one batched kernel launch per payload kind, and the durable
state is d^2 floats and a few int64 counters per tenant. Around that
core: exactly-once ingest cursors (:mod:`~repro_torch.serve.ingest`), a
write-ahead fold journal (:mod:`~repro_torch.serve.journal`), atomic
snapshots and replay recovery, watchdogs and incremental re-solves
(:class:`~repro_torch.serve.server.StructureServer`), and a deterministic
traffic generator (:mod:`~repro_torch.serve.traffic`). Snapshots and
journal segments are byte-compatible with ``repro.serve``'s.
"""
from .ingest import BoundedQueue, IngestLog, Payload, split_kinds
from .journal import (FoldJournal, JournalCorruptionError, iter_records,
                      read_journal, scan_segments)
from .server import ServeConfig, StructureServer
from .table import TenantTable
from .traffic import TrafficConfig, make_trace, unique_payloads

__all__ = [
    "BoundedQueue", "FoldJournal", "IngestLog", "JournalCorruptionError",
    "Payload", "ServeConfig", "StructureServer", "TenantTable",
    "TrafficConfig", "iter_records", "make_trace", "read_journal",
    "scan_segments", "split_kinds", "unique_payloads",
]
