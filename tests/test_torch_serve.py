"""The port's serving plane on the CPU: ingest, journal, tenant table and
structure server, held to ``repro.serve`` on shared inputs.

Sign and packed accumulators are bit-identical to ``repro``'s, per-symbol
R >= 2 within rtol=1e-5, atol=1e-5*n; whole server runs give the same
per-tick telemetry (all but ``fold_seconds``) and ``comparable_state()``;
each package recovers the other's snapshot + journal directory; and a
server that SIGKILLs itself mid-tick, in a child that imports only
``repro_torch``, recovers bit for bit.
"""
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.streaming import StreamingGram as JStream
from repro.serve import FoldJournal as JJournal
from repro.serve import ServeConfig as JConfig
from repro.serve import StructureServer as JServer
from repro.serve import TenantTable as JTable
from repro.serve import TrafficConfig as JTraffic
from repro.serve import make_trace as j_trace
from repro_torch.core import StreamingGram
from repro_torch.core.gram import GramEngine
from repro_torch.core.quantizers import pack_codes
from repro_torch.serve import (BoundedQueue, FoldJournal, IngestLog,
                               JournalCorruptionError, Payload, ServeConfig,
                               StructureServer, TenantTable, TrafficConfig,
                               make_trace, read_journal, split_kinds,
                               unique_payloads)
from repro_torch.serve.journal import (iter_records, list_segments,
                                       prune_segments, scan_segments,
                                       segment_path)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CPU = GramEngine(device="cpu")


def _codes(rng, n=16, d=6):
    return rng.choice(np.asarray([-1, 1], np.int8), size=(n, d))


def _packed_payload(rng, tenant, machine, seq, n=16, d=6):
    bits = rng.integers(0, 2, size=(n, d)).astype(np.uint8)
    bits = np.concatenate([bits, np.zeros(((-n) % 8, d), np.uint8)])
    return Payload(tenant, machine, seq,
                   packed=pack_codes(torch.from_numpy(bits.T), 1).numpy(),
                   n=n)


def _same_payload(p, q) -> bool:
    return ((p.tenant, p.machine, p.seq, p.kind, p.n, p.bits)
            == (q.tenant, q.machine, q.seq, q.kind, q.n, q.bits)
            and np.array_equal(p.codes if p.kind == "codes" else p.packed,
                               q.codes if q.kind == "codes" else q.packed))


# -- ingest: repro's unit cases on the port -----------------------------------

def _payload_validation(rng):
    c = _codes(rng)
    for bad in (dict(), dict(codes=c, packed=np.zeros((6, 2), np.uint8), n=3),
                dict(packed=np.zeros((6, 2), np.uint8), n=99),
                dict(packed=np.zeros((6, 2), np.uint8), n=3, bits=True)):
        with pytest.raises(ValueError):
            Payload(0, 0, 1, **bad)
    with pytest.raises(ValueError):
        Payload(0, 0, 0, codes=c)                   # seq is 1-based
    p = Payload(3, 1, 2, codes=c)
    assert (p.kind, p.d, p.n) == ("codes", 6, 16)
    q = _packed_payload(rng, 0, 0, 1)
    assert (q.kind, q.d, q.n) == ("packed", 6, 16)


def _bounded_queue_backpressure(rng):
    q = BoundedQueue(2)
    assert q.offer(1) and q.offer(2)
    assert not q.offer(3) and q.rejected == 1       # reject, never block
    assert q.drain(10) == [1, 2] and len(q) == 0


def _split_kinds_stable(rng):
    ps = [Payload(0, 0, 1, codes=_codes(rng)),
          _packed_payload(rng, 0, 1, 1),
          Payload(0, 0, 2, codes=_codes(rng))]
    codes, packed = split_kinds(ps)
    assert [p.seq for p in codes] == [1, 2] and packed == [ps[1]]


def _duplicates_fold_zero_times(rng):
    log = IngestLog(2, 2)
    p = Payload(0, 0, 1, codes=_codes(rng))
    assert log.offer(p, tick=1) == [p]
    assert log.offer(p, tick=1) == [] and log.offer(p, tick=5) == []
    early = Payload(0, 0, 3, codes=_codes(rng))
    assert log.offer(early, tick=5) == [] and log.offer(early, tick=6) == []
    assert int(log.duplicates[0]) == 3


def _reorder_folds_in_order(rng):
    log = IngestLog(1, 1)
    p1, p2, p3 = (Payload(0, 0, s, codes=_codes(rng)) for s in (1, 2, 3))
    assert log.offer(p3, 1) == [] and log.offer(p2, 1) == []
    assert log.offer(p1, 1) == [p1, p2, p3]
    assert int(log.cursors[0, 0]) == 3
    assert int(log.reordered[0]) == 2 and int(log.lost[0, 0]) == 0


def _window_overflow_declares_gap(rng):
    log = IngestLog(1, 1, reorder_window=3)
    ps = {s: Payload(0, 0, s, codes=_codes(rng)) for s in (3, 4, 5, 6)}
    for s in (3, 4, 5):
        assert log.offer(ps[s], 1) == []
    assert log.offer(ps[6], 1) == [ps[3], ps[4], ps[5], ps[6]]
    assert int(log.lost[0, 0]) == 2
    assert log.degraded_tenants().tolist() == [True]


def _deadline_flushes_overdue(rng):
    log = IngestLog(1, 1, reorder_ticks=2)
    p2 = Payload(0, 0, 2, codes=_codes(rng))
    assert log.offer(p2, tick=1) == []
    assert log.flush_overdue(tick=2) == []
    assert log.flush_overdue(tick=3) == [p2]
    assert int(log.lost[0, 0]) == 1 and log.buffered() == 0


def _replay_is_idempotent(rng):
    log = IngestLog(1, 1)
    assert log.replay(0, 0, 1) and log.replay(0, 0, 2)
    assert not log.replay(0, 0, 2) and not log.replay(0, 0, 1)
    assert log.replay(0, 0, 5) and int(log.lost[0, 0]) == 2
    assert int(log.cursors[0, 0]) == 5


@pytest.mark.parametrize("case", [
    _payload_validation, _bounded_queue_backpressure, _split_kinds_stable,
    _duplicates_fold_zero_times, _reorder_folds_in_order,
    _window_overflow_declares_gap, _deadline_flushes_overdue,
    _replay_is_idempotent], ids=lambda f: f.__name__.strip("_"))
def test_ingest_case(case):
    case(np.random.default_rng(0))


# -- journal: repro's unit cases, and the same bytes as repro's ---------------

def _journal_roundtrip_both_kinds(tmp_path, rng):
    path = str(tmp_path / "j.log")
    sent = [Payload(1, 0, 1, codes=_codes(rng)),
            _packed_payload(rng, 2, 1, 7),
            Payload(3, 2, 4, codes=(_codes(rng) > 0).astype(np.int8),
                    bits=True)]
    j = FoldJournal(path)
    for i, p in enumerate(sent):
        j.append(p, tick=10 + i)
    j.close()
    records, torn, valid = read_journal(path)
    assert not torn and valid == os.path.getsize(path)
    assert [t for t, _ in records] == [10, 11, 12]
    assert all(_same_payload(got, p) for (_, got), p in zip(records, sent))


def _journal_torn_tail_truncates(tmp_path, rng):
    path = str(tmp_path / "j.log")
    j = FoldJournal(path)
    for s in (1, 2, 3):
        j.append(Payload(0, 0, s, codes=_codes(rng)), tick=s)
    j.close()
    raw = open(path, "rb").read()
    _, _, intact_valid = read_journal(path)
    open(path, "wb").write(raw[:len(raw) - 11])     # torn mid-record
    records, torn, valid = read_journal(path)
    assert torn and [p.seq for _, p in records] == [1, 2]
    os.truncate(path, valid)
    records, torn, _ = read_journal(path)
    assert not torn and [p.seq for _, p in records] == [1, 2]
    open(path, "wb").write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))  # bad CRC
    records, torn, valid = read_journal(path)
    assert torn and [p.seq for _, p in records] == [1, 2]
    assert valid < intact_valid == os.path.getsize(path)


def _journal_segments_rotate_and_prune(tmp_path, rng):
    d = str(tmp_path)
    for step, seq in ((0, 1), (4, 2), (8, 3)):
        j = FoldJournal(segment_path(d, step))
        j.append(Payload(0, 0, seq, codes=_codes(rng)), tick=step + 1)
        j.close()
    assert [s for s, _ in list_segments(d)] == [0, 4, 8]
    assert [p.seq for _, p in iter_records(d)] == [1, 2, 3]
    prune_segments(d, keep=2)
    assert [s for s, _ in list_segments(d)] == [4, 8]


def _scan_rejects_torn_middle_segment(tmp_path, rng):
    d = str(tmp_path)
    for step, seq in ((0, 1), (8, 2)):
        j = FoldJournal(segment_path(d, step))
        j.append(Payload(0, 0, seq, codes=_codes(rng)), tick=step + 1)
        j.close()
    with open(segment_path(d, 0), "ab") as f:
        f.write(b"torn")
    with pytest.raises(JournalCorruptionError):
        scan_segments(d)
    os.truncate(segment_path(d, 0), os.path.getsize(segment_path(d, 0)) - 4)
    with open(segment_path(d, 8), "ab") as f:
        f.write(b"torn")
    scans = scan_segments(d)
    assert [s.torn for s in scans] == [False, True]
    assert scans[1].total_bytes - scans[1].valid_bytes == 4


@pytest.mark.parametrize("case", [
    _journal_roundtrip_both_kinds, _journal_torn_tail_truncates,
    _journal_segments_rotate_and_prune, _scan_rejects_torn_middle_segment],
    ids=lambda f: f.__name__.strip("_"))
def test_journal_case(case, tmp_path):
    case(tmp_path, np.random.default_rng(1))


class _FrozenClock:
    """zipfile stamps each npz member with the wall clock; freeze it so
    two writers' frames can be compared byte for byte."""

    @staticmethod
    def time():
        return 1.7e9

    @staticmethod
    def localtime(t=None):
        import time

        return time.gmtime(1.7e9)


def test_journal_bytes_match_repro(tmp_path, monkeypatch):
    monkeypatch.setattr(zipfile, "time", _FrozenClock)
    rng = np.random.default_rng(2)
    sent = [Payload(1, 0, 1, codes=_codes(rng)),
            _packed_payload(rng, 2, 1, 7, n=13),
            Payload(3, 2, 4, codes=(_codes(rng) > 0).astype(np.int8),
                    bits=True)]
    paths = []
    for cls, name in ((FoldJournal, "port.log"), (JJournal, "repro.log")):
        j = cls(str(tmp_path / name))
        for i, p in enumerate(sent):
            j.append(p, tick=i + 1)
        j.close()
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()


# -- traffic -----------------------------------------------------------------

TRAFFIC = {
    "sign": dict(packed_fraction=0.5),
    "bits": dict(packed_fraction=0.3, bit_fraction=0.5),
    "packed": dict(packed_fraction=1.0, n=13),
    "persymbol": dict(method="persymbol", rate=3),
    "permuted": dict(permutation=(1, 0, 3, 2, 5, 4), permute_from_tick=2),
}


@pytest.mark.parametrize("kind", sorted(TRAFFIC))
def test_make_trace_matches_repro(kind):
    cfg = dict(tenants=2, machines=2, ticks=4, n=16, d=6, p_duplicate=0.3,
               p_reorder=0.3, p_drop=0.1, seed=5)
    cfg.update(TRAFFIC[kind])
    mine, ref = make_trace(TrafficConfig(**cfg)), j_trace(JTraffic(**cfg))
    assert [len(b) for b in mine] == [len(b) for b in ref]
    for b0, b1 in zip(mine, ref):
        for p, q in zip(b0, b1):
            assert _same_payload(p, q)
            data = p.codes if p.kind == "codes" else p.packed
            ref_data = q.codes if q.kind == "codes" else q.packed
            assert data.dtype == ref_data.dtype
            assert data.tobytes() == ref_data.tobytes()


# -- TenantTable --------------------------------------------------------------

def _fold_reference(payloads, d, method="sign", rate=1):
    refs = {}
    for p in payloads:
        sg = refs.setdefault(p.tenant, StreamingGram(
            d=d, method=method, rate=rate, engine=CPU))
        if p.kind == "codes":
            c = ((2 * p.codes.astype(np.int8) - 1).astype(np.int8)
                 if p.bits else p.codes)
            sg.update_codes(c)
        else:
            sg.update_packed(p.packed, p.n)
    return refs


def _mixed_payloads(rng, tenants=4, d=6, block_n=24, count=13):
    ps = []
    for i in range(count):
        tenant, n = int(rng.integers(0, tenants)), int(
            rng.integers(1, block_n + 1))
        if rng.random() < 0.5:
            ps.append(Payload(tenant, 0, i + 1, codes=_codes(rng, n=n, d=d)))
        else:
            ps.append(_packed_payload(rng, tenant, 1, i + 1, n=n, d=d))
    return ps


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_table_fold_matches_repro_and_streaming_bitwise(backend):
    rng = np.random.default_rng(0)
    ps = _mixed_payloads(rng)
    t = TenantTable(tenants=4, d=6, block_n=24, max_slots=4,
                    engine=GramEngine(backend=backend, device="cpu"))
    j = JTable(tenants=4, d=6, block_n=24, max_slots=4)
    assert t.fold(ps) == j.fold(ps) == sum(p.n for p in ps)
    np.testing.assert_array_equal(t.gram, j.gram)
    np.testing.assert_array_equal(t.n, j.n)
    for tenant, sg in _fold_reference(ps, d=6).items():
        np.testing.assert_array_equal(sg.gram.numpy().astype(np.float64),
                                      t.gram[tenant])
        assert sg.n == int(t.n[tenant])
    idx = np.flatnonzero(t.n)
    assert t.resolve(idx) == j.resolve(idx)
    np.testing.assert_array_equal(t.adj, j.adj)
    np.testing.assert_array_equal(t.drift, j.drift)


def test_table_fold_grouping_invariance():
    rng = np.random.default_rng(1)
    ps = [Payload(int(rng.integers(0, 3)), 0, i + 1,
                  codes=_codes(rng, n=int(rng.integers(1, 17))))
          for i in range(12)]
    a = TenantTable(tenants=3, d=6, block_n=16, max_slots=2, engine=CPU)
    b = TenantTable(tenants=3, d=6, block_n=16, max_slots=8, engine=CPU)
    a.fold(ps)
    for lo in range(0, 12, 3):
        b.fold(ps[lo:lo + 3])
    assert np.array_equal(a.gram, b.gram) and np.array_equal(a.n, b.n)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("rate", [1, 2, 4])
def test_table_fold_persymbol_matches_repro(backend, rate):
    rng = np.random.default_rng(rate)
    kw = dict(tenants=2, d=5, method="persymbol", rate=rate, block_n=16,
              max_slots=4)
    ps = [Payload(i % 2, 0, i + 1,
                  codes=rng.integers(0, 1 << rate, size=(
                      int(rng.integers(1, 17)), 5)).astype(np.int8))
          for i in range(6)]
    t = TenantTable(**kw, engine=GramEngine(backend=backend, device="cpu"))
    j = JTable(**kw)
    t.fold(ps)
    j.fold(ps)
    if rate == 1:      # c^2 * integer: exact on both
        np.testing.assert_array_equal(t.gram, j.gram)
    else:
        for k in range(2):
            np.testing.assert_allclose(t.gram[k], j.gram[k], rtol=1e-5,
                                       atol=1e-5 * int(t.n[k]))
    t2 = TenantTable(**kw, engine=GramEngine(backend=backend, device="cpu"))
    t2.fold(ps)
    assert np.array_equal(t.gram, t2.gram)      # deterministic re-fold
    idx = np.arange(2)
    assert t.resolve(idx) == j.resolve(idx)
    np.testing.assert_array_equal(t.adj, j.adj)


def _masked_zero_codes_drop_out(rng):
    c = _codes(rng, n=12, d=6)
    c[np.asarray(rng.random(c.shape) < 0.3)] = 0
    t = TenantTable(tenants=1, d=6, block_n=16, engine=CPU)
    t.fold([Payload(0, 0, 1, codes=c)])
    want = c.astype(np.int64).T @ c.astype(np.int64)
    assert np.array_equal(t.gram[0], want.astype(np.float64))
    assert int(t.n[0]) == 12


def _bit_codes_fold_as_signs(rng):
    bits = rng.integers(0, 2, size=(10, 6)).astype(np.int8)
    t = TenantTable(tenants=1, d=6, block_n=16, engine=CPU)
    t.fold([Payload(0, 0, 1, codes=bits, bits=True)])
    pm1 = 2 * bits.astype(np.int64) - 1
    assert np.array_equal(t.gram[0], (pm1.T @ pm1).astype(np.float64))


def _rejects_bad_payloads(rng):
    t = TenantTable(tenants=2, d=6, block_n=16, engine=CPU)
    for bad in (Payload(0, 0, 1, codes=_codes(rng, n=17)),
                Payload(5, 0, 1, codes=_codes(rng)),
                Payload(0, 0, 1, codes=_codes(rng, d=4)),
                Payload(0, 0, 1, codes=np.full((4, 6), 2, np.int8)),
                Payload(0, 0, 1, codes=-np.ones((4, 6), np.int8),
                        bits=True)):
        with pytest.raises(ValueError):
            t.fold([bad])
    with pytest.raises(ValueError):
        TenantTable(tenants=1, d=6, method="persymbol", rate=2, block_n=16,
                    engine=CPU).fold(
            [Payload(0, 0, 1, codes=np.ones((4, 6), np.int8), bits=True)])


def _corr_gram(corr, n):
    return np.sin(np.asarray(corr) * np.pi / 2) * n


def _chain_corr(d, rho=0.8):
    i = np.arange(d)
    return rho ** np.abs(i[:, None] - i[None, :])


def _resolve_counts_drift(rng):
    d, n = 8, 1000
    t = TenantTable(tenants=1, d=d, engine=CPU)
    t.gram[0] = _corr_gram(_chain_corr(d), n)
    t.n[0] = n
    assert t.resolve(np.asarray([0])) == {"solved": 1, "drifted": 1,
                                          "drift_edges": d - 1}
    chain = t.adj[0].copy()
    star = np.full((d, d), 0.05)
    star[0, :] = star[:, 0] = 0.9
    np.fill_diagonal(star, 1.0)
    t.gram[0] = _corr_gram(star, n)
    s = t.resolve(np.asarray([0]))
    assert t.adj[0, 0].sum() == d - 1
    sym_diff = int((t.adj[0] ^ chain).sum()) // 2
    assert s["drift_edges"] == sym_diff > 0
    assert int(t.drift[0]) == (d - 1) + sym_diff


def _resolve_cadence(rng):
    t = TenantTable(tenants=2, d=4, resolve_min_new=10, engine=CPU)
    assert not t.needs_resolve().any()
    t.gram[0] = _corr_gram(_chain_corr(4), 5)
    t.n[0] = 5
    assert not t.needs_resolve().any()
    t.n[0] = 10
    assert t.needs_resolve().tolist() == [True, False]
    t.resolve(np.flatnonzero(t.needs_resolve()))
    assert not t.needs_resolve().any()


def _resolve_counts_exact_past_f32(rng):
    d = 8
    t = TenantTable(tenants=2, d=d, engine=CPU)
    for slot, n in enumerate(((1 << 24), (1 << 24) + 1)):
        t.gram[slot] = _corr_gram(_chain_corr(d), n)
        t.n[slot] = n
    t.resolve(np.arange(2))
    i = np.arange(d)
    chain = np.abs(i[:, None] - i[None, :]) == 1
    assert np.array_equal(t.adj[0], chain) and np.array_equal(t.adj[1], chain)


def _degraded_tenant_solves_finite(rng):
    t = TenantTable(tenants=1, d=4, engine=CPU)
    t.n[0] = 1
    t.gram[0] = np.eye(4)
    t.resolve(np.asarray([0]))
    assert t.adj[0].sum() == 2 * 3


def _state_roundtrip_and_streaming_export(rng):
    t = TenantTable(tenants=3, d=6, block_n=16, engine=CPU)
    ps = [Payload(i % 3, 0, i + 1, codes=_codes(rng)) for i in range(6)]
    t.fold(ps)
    t.resolve(np.arange(3))
    u = TenantTable(tenants=3, d=6, block_n=16, engine=CPU)
    u.load_state(t.state_tree())
    for k, v in t.state_tree().items():
        assert np.array_equal(v, u.state_tree()[k]), k
    merged = t.to_streaming(0).merge(t.to_streaming(1)).merge(
        t.to_streaming(2))
    want = sum(r.gram.numpy().astype(np.float64)
               for r in _fold_reference(ps, d=6).values())
    assert np.array_equal(merged.gram.numpy().astype(np.float64), want)
    assert merged.n == int(t.n.sum())


@pytest.mark.parametrize("case", [
    _masked_zero_codes_drop_out, _bit_codes_fold_as_signs,
    _rejects_bad_payloads, _resolve_counts_drift, _resolve_cadence,
    _resolve_counts_exact_past_f32, _degraded_tenant_solves_finite,
    _state_roundtrip_and_streaming_export],
    ids=lambda f: f.__name__.strip("_"))
def test_table_case(case):
    case(np.random.default_rng(3))


def test_table_needs_cuda_by_default_and_has_no_mesh(monkeypatch):
    """A tenant mesh splits a fold over its devices (here two CPU
    devices): the table folds to the bits of one without a mesh."""
    from repro_torch.launch.mesh import make_tenant_mesh

    mesh = make_tenant_mesh(2, devices=["cpu", "cpu"])
    tables = [TenantTable(tenants=2, d=4, engine=CPU, mesh=m)
              for m in (None, mesh)]
    signs = np.random.default_rng(0).choice(np.array([-1, 1], np.int8),
                                            (2, 8, 4))
    for t in tables:
        t.fold([Payload(tenant=i, machine=0, seq=1, codes=signs[i])
                for i in range(2)])
    assert tables[1].mesh.size == 2
    np.testing.assert_array_equal(tables[0].gram, tables[1].gram)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TenantTable(tenants=1, d=4)


# -- StructureServer ----------------------------------------------------------

_TCFG = dict(tenants=5, machines=3, ticks=10, n=24, d=8, bit_fraction=0.25,
             p_duplicate=0.25, p_reorder=0.25, p_drop=0.1, seed=7)
_SCFG = dict(tenants=5, machines=3, d=8, block_n=24, snapshot_every=3,
             reorder_ticks=2, keep_segments=2)


def _port(directory, **kw):
    return StructureServer(ServeConfig(**{**_SCFG, **kw}, engine=CPU),
                           str(directory))


def _drive(srv, trace, extra_ticks=4):
    tele = []
    for batch in trace:
        for p in batch:
            srv.submit(p)
        tele.append(srv.run_tick())
    for _ in range(extra_ticks):
        tele.append(srv.run_tick())
    srv.force_resolve()
    return tele


def _no_clock(tele):
    return [{k: v for k, v in t.items() if k != "fold_seconds"}
            for t in tele]


def _same_state(a, b):
    sa, sb = a.comparable_state(), b.comparable_state()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


@pytest.mark.parametrize("method,rate", [("sign", 1), ("persymbol", 2)])
def test_server_run_matches_repro(tmp_path, method, rate):
    tcfg = dict(_TCFG, method=method, rate=rate)
    scfg = dict(_SCFG, method=method, rate=rate)
    mine = _port(tmp_path / "port", method=method, rate=rate)
    ref = JServer(JConfig(**scfg), str(tmp_path / "repro"))
    t_mine = _drive(mine, make_trace(TrafficConfig(**tcfg)))
    t_ref = _drive(ref, j_trace(JTraffic(**tcfg)))
    assert _no_clock(t_mine) == _no_clock(t_ref)
    if method == "sign":
        _same_state(mine, ref)
    else:
        sa, sb = mine.comparable_state(), ref.comparable_state()
        np.testing.assert_allclose(sa.pop("gram"), sb.pop("gram"),
                                   rtol=1e-5, atol=1e-5 * int(sa["n"].max()))
        assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    mine.close(), ref.close()


def test_server_folds_trace_exactly_once(tmp_path):
    trace = make_trace(TrafficConfig(**_TCFG))
    srv = _port(tmp_path)
    _drive(srv, trace)
    for tenant, sg in _fold_reference(unique_payloads(trace), d=8).items():
        assert np.array_equal(sg.gram.numpy().astype(np.float64),
                              srv.table.gram[tenant])
        assert sg.n == int(srv.table.n[tenant])
    assert int(srv.log.duplicates.sum()) > 0
    assert int(srv.log.reordered.sum()) > 0
    assert int(srv.log.lost.sum()) > 0 and srv.log.degraded_tenants().any()
    assert srv.log.buffered() == 0
    srv.close()


def test_server_restart_without_crash_is_bit_identical(tmp_path):
    trace = make_trace(TrafficConfig(**_TCFG))
    a = _port(tmp_path / "a")
    _drive(a, trace)
    b = _port(tmp_path / "b")
    half = len(trace) // 2
    for batch in trace[:half]:
        for p in batch:
            b.submit(p)
        b.run_tick()
    b.close()
    b = _port(tmp_path / "b")
    for p in [q for batch in trace[:half] for q in batch]:
        b.submit(p)
    b.run_tick()
    _drive(b, trace[half:])
    _same_state(a, b)
    a.close(), b.close()


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_cross_recovery(tmp_path, writer):
    """A directory one package's server wrote (snapshots + journal) is
    recovered by the other's to the state the writer's own recovery
    reaches, and both then finish the trace alike."""
    trace = make_trace(TrafficConfig(**_TCFG))
    first = tmp_path / "first"
    srv = (JServer(JConfig(**_SCFG), str(first)) if writer == "repro"
           else _port(first))
    for batch in trace[:7]:      # snapshots at ticks 3, 6; journal after
        for p in batch:
            srv.submit(p)
        srv.run_tick()
    srv.close()
    shutil.copytree(first, tmp_path / "second")
    mine = _port(first)
    ref = JServer(JConfig(**_SCFG), str(tmp_path / "second"))
    assert mine.snapshot_step == ref.snapshot_step == 6
    assert mine.recovered_records == ref.recovered_records > 0
    assert mine.tick == ref.tick
    _same_state(mine, ref)
    for srv in (mine, ref):
        for p in [q for batch in trace[:7] for q in batch]:
            srv.submit(p)        # everything unacked comes again
        srv.run_tick()
        _drive(srv, trace[7:])
    _same_state(mine, ref)
    mine.close(), ref.close()


def test_recovery_truncates_torn_tail_so_later_appends_survive(tmp_path):
    rng = np.random.default_rng(4)
    cfg = dict(tenants=1, machines=1, d=6, block_n=16, snapshot_every=0)
    payloads = [Payload(0, 0, s + 1, codes=_codes(rng)) for s in range(6)]
    srv = StructureServer(ServeConfig(**cfg, engine=CPU), str(tmp_path))
    for p in payloads[:3]:
        srv.submit(p)
    srv.run_tick()
    srv.close()
    with open(segment_path(str(tmp_path), 0), "ab") as f:
        f.write(b"GJ" + b"\xee")    # torn in-flight frame
    srv = StructureServer(ServeConfig(**cfg, engine=CPU), str(tmp_path))
    assert srv.torn_segments == 1 and srv.torn_bytes_dropped == 3
    assert srv.recovered_records == 3
    for p in payloads[3:]:
        srv.submit(p)
    srv.run_tick()
    srv.close()
    srv = StructureServer(ServeConfig(**cfg, engine=CPU), str(tmp_path))
    assert srv.torn_segments == 0 and srv.recovered_records == 6
    ref = _fold_reference(payloads, d=6)[0]
    assert np.array_equal(ref.gram.numpy().astype(np.float64),
                          srv.table.gram[0])
    srv.close()


def test_server_watchdog_and_backpressure(tmp_path):
    rng = np.random.default_rng(5)
    srv = StructureServer(ServeConfig(
        tenants=2, machines=1, d=6, block_n=16, resolve_min_new=10 ** 6,
        watchdog_ticks=3, snapshot_every=0, engine=CPU), str(tmp_path / "w"))
    srv.submit(Payload(0, 0, 1, codes=_codes(rng)))
    assert srv.run_tick()["solved"] == 0
    assert sum(srv.run_tick()["solved"] for _ in range(3)) == 1
    assert int(srv.watchdog_fires.sum()) == 1 and srv.table.adj[0].any()
    srv.close()
    srv = StructureServer(ServeConfig(
        tenants=1, machines=1, d=6, block_n=16, queue_capacity=2,
        snapshot_every=0, engine=CPU), str(tmp_path / "b"))
    oks = [srv.submit(Payload(0, 0, s + 1, codes=_codes(rng)))
           for s in range(5)]
    assert oks == [True, True, False, False, False]
    assert srv.run_tick()["rejected"] == 3
    srv.close()


def test_server_cusum_alarms_and_survive_recovery(tmp_path):
    d = 8
    perm = tuple(range(0, d, 2)) + tuple(range(1, d, 2))
    base = dict(tenants=2, machines=2, ticks=24, n=64, d=d, rho=0.75,
                packed_fraction=0.0, seed=13)
    scfg = dict(tenants=2, machines=2, d=d, block_n=64, snapshot_every=4,
                cusum_k=0.5, cusum_h=1.0, engine=CPU)
    still = StructureServer(ServeConfig(**scfg), str(tmp_path / "still"))
    _drive(still, make_trace(TrafficConfig(**base)))
    moved = StructureServer(ServeConfig(**scfg), str(tmp_path / "moved"))
    _drive(moved, make_trace(TrafficConfig(
        **base, permutation=perm, permute_from_tick=12)))
    assert int(still.cusum_alarms.sum()) == 0
    assert int(moved.cusum_alarms.sum()) >= 1
    alarms, stat = moved.cusum_alarms.copy(), moved.cusum_stat.copy()
    still.close(), moved.close()
    back = StructureServer(ServeConfig(**scfg), str(tmp_path / "moved"))
    assert np.array_equal(back.cusum_alarms, alarms)
    assert np.array_equal(back.cusum_stat, stat)
    back.close()


def test_server_needs_cuda_by_default_and_has_no_mesh(tmp_path, monkeypatch):
    """``use_mesh`` builds the tenant mesh: a CPU engine's one device."""
    srv = StructureServer(ServeConfig(**_SCFG, engine=CPU, use_mesh=True),
                          str(tmp_path / "m"))
    assert srv.table.mesh is not None and srv.table.mesh.size == 1
    srv.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StructureServer(ServeConfig(**_SCFG), str(tmp_path / "c"))


_CHILD = """\
import sys
sys.path.insert(0, {src!r})
from repro_torch.core.gram import GramEngine
from repro_torch.serve import (ServeConfig, StructureServer, TrafficConfig,
                               make_trace)

srv = StructureServer(ServeConfig(**{scfg!r}, engine=GramEngine(device="cpu"),
                                  crash_after_journal_records={crash}),
                      sys.argv[1])
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               or m == "repro" for m in sys.modules), "imports jax or repro"
for batch in make_trace(TrafficConfig(**{tcfg!r})):
    for p in batch:
        srv.submit(p)
    srv.run_tick()
print("SURVIVED")  # the hook must SIGKILL the child before this
sys.exit(3)
"""


@pytest.mark.parametrize("crash_after", [17, 55])
def test_crash_recovery_bit_identity(tmp_path, crash_after):
    """SIGKILL mid-tick (between journal append and fold) in a child that
    imports only repro_torch; the restarted server, fed everything
    unacked again, equals the uninterrupted run bit for bit."""
    trace = make_trace(TrafficConfig(**_TCFG))
    clean = _port(tmp_path / "clean")
    _drive(clean, trace)
    crash_dir = str(tmp_path / "crash")
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(src=SRC, scfg=_SCFG, tcfg=_TCFG,
                                    crash=crash_after))
    r = subprocess.run([sys.executable, str(script), crash_dir],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == -9, (r.returncode, r.stdout, r.stderr)
    srv = _port(crash_dir)
    assert srv.recovered_records > 0 or srv.snapshot_step > 0
    _drive(srv, trace)
    _same_state(clean, srv)
    clean.close(), srv.close()
