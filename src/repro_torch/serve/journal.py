"""Append-only fold journal: the write-ahead log between snapshots.

A copy of ``repro.serve.journal``: the frame format is the same byte for
byte, so each package replays the other's segments.

Durability story of the serving plane, in order per tick:

1. accepted payloads are APPENDED here (length + CRC32 framed npz
   records) and the file is fsynced — only then
2. do they fold into the accumulator stack, and only then
3. are their sequence numbers acked upstream.

A crash at any point leaves one of two disk states: a fully-framed
record (its payload is durable and will re-fold on replay) or a torn
tail (length/CRC check fails — the record never happened; the upstream
never saw an ack and re-delivers). Restore = load the latest snapshot,
then replay every surviving journal record through the ingest cursors —
records already captured by the snapshot are skipped by the cursor
check, so replaying any superset is idempotent. A torn tail must then
be TRUNCATED before the segment is reopened for append: bytes written
after torn garbage would be unreachable to the next recovery (the
scanner stops at the first corrupt frame), silently dropping acked
folds on a second crash. ``scan_segments`` reports the valid-prefix
byte offset for exactly this repair, and enforces the append-only
invariant that only the NEWEST segment may be torn — a torn older
segment was closed and fsynced before its snapshot rotated it out, so
corruption there is disk damage, not crash residue, and raises
:class:`JournalCorruptionError` instead of silently under-replaying.

Journals are SEGMENTED by snapshot step (``journal_<step>.log`` holds
the folds after snapshot ``step``); a snapshot rotates to a fresh
segment and prunes all but the last ``keep`` — the journal stays small
because the accumulator state it protects is compact (the whole point
of the paper's sufficient-statistic center).
"""
from __future__ import annotations

import dataclasses
import io
import os
import re
import struct
import zlib
from typing import Iterator

import numpy as np

from .ingest import Payload

_MAGIC = b"GJ"
_HEADER = struct.Struct("<2sII")  # magic, blob length, crc32(blob)

_KINDS = ("codes", "packed")


class JournalCorruptionError(RuntimeError):
    """A journal segment that cannot be crash residue is damaged (torn
    frame in a non-final, already-rotated segment)."""


def _encode(p: Payload, tick: int) -> bytes:
    bio = io.BytesIO()
    data = p.codes if p.codes is not None else p.packed
    np.savez(bio,
             meta=np.asarray([p.tenant, p.machine, p.seq, tick, p.n,
                              _KINDS.index(p.kind), int(p.bits)], np.int64),
             data=data)
    return bio.getvalue()


def _decode(blob: bytes) -> tuple[int, Payload]:
    with np.load(io.BytesIO(blob)) as z:
        tenant, machine, seq, tick, n, kind, bits = (
            int(v) for v in z["meta"])
        data = z["data"]
    if _KINDS[kind] == "codes":
        return tick, Payload(tenant, machine, seq, codes=data,
                             bits=bool(bits))
    return tick, Payload(tenant, machine, seq, packed=data, n=n)


class FoldJournal:
    """Writer half: append accepted payloads, fsync once per tick."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")
        self.records = 0

    def append(self, p: Payload, tick: int) -> None:
        blob = _encode(p, tick)
        self._f.write(_HEADER.pack(_MAGIC, len(blob), zlib.crc32(blob)))
        self._f.write(blob)
        self.records += 1

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self.sync()
        finally:
            self._f.close()


def read_journal(path: str) -> tuple[list[tuple[int, Payload]], bool, int]:
    """Scan one segment; returns (records, torn_tail, valid_bytes).

    Stops at the first incomplete or CRC-corrupt frame — everything
    before it is intact by construction (append-only writes), everything
    from it on was a torn in-flight write and is ignored.
    ``valid_bytes`` is the byte offset of the end of the last intact
    frame: truncating the file there removes the torn garbage so the
    segment is safe to reopen for append.
    """
    records: list[tuple[int, Payload]] = []
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    while off < len(raw):
        if off + _HEADER.size > len(raw):
            return records, True, off
        magic, length, crc = _HEADER.unpack_from(raw, off)
        blob = raw[off + _HEADER.size: off + _HEADER.size + length]
        if magic != _MAGIC or len(blob) < length or zlib.crc32(blob) != crc:
            return records, True, off
        records.append(_decode(blob))
        off += _HEADER.size + length
    return records, False, off


def segment_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"journal_{step:08d}.log")


def list_segments(directory: str) -> list[tuple[int, str]]:
    """(step, path) of every journal segment, ascending by step."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in os.listdir(directory):
        m = re.fullmatch(r"journal_(\d+)\.log", f)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, f)))
    return sorted(out)


def prune_segments(directory: str, keep: int) -> None:
    """Drop all but the newest ``keep`` segments (their folds are covered
    by the snapshot the newest segments follow)."""
    segs = list_segments(directory)
    for _, path in segs[:max(0, len(segs) - keep)]:
        os.unlink(path)


@dataclasses.dataclass(frozen=True)
class SegmentScan:
    """One segment's recovery-relevant scan result."""

    step: int
    path: str
    records: list[tuple[int, Payload]]
    torn: bool
    valid_bytes: int    # end of the last intact frame
    total_bytes: int    # on-disk size (> valid_bytes iff torn)


def scan_segments(directory: str) -> list[SegmentScan]:
    """Scan every segment, oldest first, enforcing the torn-tail policy.

    Only the newest segment was open for append at crash time — every
    older one was closed and fsynced before the snapshot that rotated it
    out. A torn frame anywhere but the newest segment would silently
    truncate that segment's replay while later segments still fold
    (wrong accumulators, no telemetry), so it raises
    :class:`JournalCorruptionError` instead.
    """
    scans = []
    for step, path in list_segments(directory):
        records, torn, valid = read_journal(path)
        scans.append(SegmentScan(step, path, records, torn, valid,
                                 os.path.getsize(path)))
    for scan in scans[:-1]:
        if scan.torn:
            raise JournalCorruptionError(
                f"non-final journal segment {scan.path} has a torn frame "
                f"at byte {scan.valid_bytes} — rotated segments are "
                f"closed+fsynced, so this is disk corruption, not crash "
                f"residue; refusing a silently incomplete replay")
    return scans


def iter_records(directory: str) -> Iterator[tuple[int, Payload]]:
    """Every surviving record across all segments, oldest segment first.

    Cursor-based replay makes cross-segment duplicates harmless, so the
    reader does not need to know which snapshot each segment follows.
    Applies the ``scan_segments`` policy: a torn non-final segment
    raises rather than yielding a silently truncated stream.
    """
    for scan in scan_segments(directory):
        yield from scan.records
