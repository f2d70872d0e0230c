"""The readers of the program's own spans and counters
(``metrics/entry_*``, ``edges_*``, ``host_reads.*``) on a CPU context with
a hand-built profile and span records, and on the records of real calls.
CPU only:

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, roofline  # noqa: E402
from repro_torch import trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
H100 = "NVIDIA H100 80GB HBM3"
NEW = ["entry_encode_roofline.tree", "entry_gram_roofline.tree",
       "entry_mwst_ms.tree", "edges_ms.tree", "edges_idle_share.tree",
       "host_reads.tree", "entry_sample_ms.sweep", "entry_weights_ms.sweep",
       "entry_mst_ms.sweep", "host_reads.sweep"]
MS = 1_000_000  # ns


def _span(name, sid, root, t0_ms, t1_ms, counts=None, parent=None):
    return trace.Span(name, sid, root if parent is None and sid != root
                      else parent, root, {}, t0_ms * MS, t1_ms * MS,
                      counts or {})


def _tree(root, t0, edges_ms, reads):
    """One tree's spans: encode 10 ms, Gram 20, weights 2, MST 3, edges."""
    names = [("repro_torch.encode", 10), ("repro_torch.gram", 20),
             ("repro_torch.weights", 2), ("repro_torch.mst", 3),
             ("repro_torch.edges", edges_ms)]
    out, t = [], t0
    for i, (name, ms) in enumerate(names, 1):
        out.append(_span(name, root + i, root, t, t + ms))
        t += ms
    out.append(_span("repro_torch.learn_structure", root, root, t0, t,
                     {"host_reads": reads}))
    return out


def _sweep(root, t0, scale):
    out, t, sid = [], t0, root
    for _ in range(2):  # two points
        for name, ms in (("repro_torch.sample", 100), ("repro_torch.stats",
                                                        20),
                         ("repro_torch.mst", 30)):
            sid += 1
            out.append(_span(name, sid, root, t, t + ms * scale))
            t += ms * scale
    out.append(_span("repro_torch.readback", sid + 1, root, t, t + 1))
    out.append(_span("repro_torch.run_trials", root, root, t0, t + 1,
                     {"host_reads": 1}))
    return out


@pytest.fixture
def records(monkeypatch):
    recs = []
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    return recs


def _ctx(unit, window_s=1.0, gaps=()):
    ctx = harness.Context(unit=unit, device="cuda", device_name=H100)
    ctx.profile = {"busy_s": 0.5, "window_s": window_s, "device_ops": [],
                   "idle_gaps": [list(g) for g in gaps]}
    ctx.counts = {"encode": (0, roofline.encode_bytes(1 << 20, 4096, 1)),
                  "gram": (roofline.gram_ops(1 << 20, 4096),
                           roofline.gram_bytes(1 << 20, 4096, 1))}
    return ctx


def _read(name, ctx):
    return harness.reader(name)(ctx)


def test_new_metrics_are_appended_with_their_cells():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    names = [m["name"] for m in BENCH["per_layer"]]
    first = names.index(NEW[0])
    assert names[first:first + len(NEW)] == NEW
    for name in NEW:
        cells = per[name]["workloads"]
        sweep = name.endswith(".sweep")
        assert cells == (["fig3-d1024-sweep"] if sweep
                         else ["production-sign", "production-r4"])
        assert per[name]["moves"] == ("trials_per_s" if sweep else "tree_s")


def test_tree_readers(records):
    # three trees: the medians are the middle tree's
    for k, (edges, reads) in enumerate(((90, 5), (70, 4), (110, 6))):
        records += _tree(100 * (k + 1), 1000 * k, edges, reads)
    ctx = _ctx("tree", window_s=0.5, gaps=[("repro_torch.edges", 0.3),
                                           ("(short gaps)", 0.01)])
    assert _read("entry_encode_roofline.tree", ctx) == pytest.approx(
        roofline.share(*ctx.counts["encode"], 0.010, H100))
    assert _read("entry_gram_roofline.tree", ctx) == pytest.approx(
        roofline.share(*ctx.counts["gram"], 0.020, H100))
    assert _read("entry_mwst_ms.tree", ctx) == pytest.approx(2 + 3 + 90)
    assert _read("edges_ms.tree", ctx) == pytest.approx(90)
    assert _read("edges_idle_share.tree", ctx) == pytest.approx(60.0)
    assert _read("host_reads.tree", ctx) == 5
    for name in NEW:
        if name.endswith(".sweep"):
            assert _read(name, ctx) is None, name


def test_sweep_readers(records):
    for k, scale in enumerate((1, 2, 3)):
        records += _sweep(100 * (k + 1), 10_000 * k, scale)
    records += _tree(900, 50_000, 80, 3)  # another root is not read
    ctx = _ctx("trial")
    assert _read("entry_sample_ms.sweep", ctx) == pytest.approx(400)
    assert _read("entry_weights_ms.sweep", ctx) == pytest.approx(80)
    assert _read("entry_mst_ms.sweep", ctx) == pytest.approx(120)
    assert _read("host_reads.sweep", ctx) == 1
    for name in NEW:
        if name.endswith(".tree"):
            assert _read(name, ctx) is None, name


def test_readers_read_nothing_off_the_card_or_without_a_profile(records):
    records += _tree(100, 0, 90, 5) + _sweep(200, 1000, 1)
    for unit in ("tree", "trial"):
        off = _ctx(unit, gaps=[("repro_torch.edges", 0.3)])
        off.device = "cpu"
        bare = _ctx(unit)
        bare.profile = None
        for name in NEW:
            assert _read(name, off) is None, name
            assert _read(name, bare) is None, name


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    """The parent of the spans: ``repro_torch.trace`` cannot be imported,
    and the trace names no idle gap after a span."""
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    for unit in ("tree", "trial"):
        ctx = _ctx(unit, gaps=[("(host: no operation)", 0.3)])
        for name in NEW:
            assert _read(name, ctx) is None, name


def test_readers_read_the_programs_own_spans(records):
    """The span names the readers look for are the program's: real CPU
    calls recorded, read as a card's would be."""
    import torch

    from repro_torch.core import chow_liu, experiments
    from repro_torch.core.strategy import Strategy

    x = torch.randn(256, 8, generator=torch.Generator().manual_seed(0))
    plan = experiments.TrialPlan(d=8, ns=(32,), reps=2,
                                 strategies=(Strategy(),))
    with trace.recording() as got:
        chow_liu.learn_structure(x, strategy=Strategy(mst="boruvka"),
                                 device="cpu")
        experiments.run_trials(plan, device="cpu")
    records += got
    tree, sweep = _ctx("tree"), _ctx("trial")
    for name in NEW:
        ctx = sweep if name.endswith(".sweep") else tree
        if name == "edges_idle_share.tree":
            continue  # the device trace's, not the spans'
        v = _read(name, ctx)
        assert v is not None and v >= 0, name
    assert _read("host_reads.sweep", sweep) == 1
    assert _read("host_reads.tree", tree) >= 2
