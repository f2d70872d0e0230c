"""The port's spans and counters (``repro_torch.trace``) on the CPU: off
by default, on under ``trace.recording()`` and under ``torch.profiler``;
the span tree of ``learn_structure`` and ``run_trials``; the
``host_reads`` counter against the reads the tensors saw; results
bit-identical with spans on and off.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core import chow_liu, experiments
from repro_torch.core.strategy import Strategy
from repro_torch.data import GGMDataset

D, N = 12, 400
BORUVKA = Strategy(mst="boruvka")
PLAN = dict(d=8, ns=(48, 100), reps=3,
            strategies=(Strategy(), Strategy("persymbol", rate=2)))
STAGES = ["repro_torch.encode", "repro_torch.gram", "repro_torch.weights",
          "repro_torch.mst", "repro_torch.edges"]


def _x(seed=0):
    return GGMDataset(d=D, seed=seed).sample(N, device="cpu")


def _plan():
    return experiments.TrialPlan(**PLAN)


def _root(recs, name):
    (group,) = trace.roots(recs, name)
    (root,) = [r for r in group if r.id == r.root]
    return root, group


def _reads(monkeypatch) -> list:
    """Every ``.cpu()``, ``int(t)``, ``.item()`` and ``.tolist()`` of a
    tensor from here on, by name: an independent count of host reads."""
    seen = []
    for name in ("cpu", "__int__", "item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            seen.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return seen


def test_spans_off_record_nothing():
    trace.clear()
    assert trace.span("repro_torch.x") is trace.NOOP
    chow_liu.learn_structure(_x(), strategy=BORUVKA, device="cpu")
    experiments.run_trials(_plan(), device="cpu")
    assert trace.records() == []


def test_learn_structure_span_tree():
    with trace.recording() as recs:
        edges = chow_liu.learn_structure(_x(), strategy=BORUVKA,
                                         device="cpu")
    assert len(edges) == D - 1
    root, group = _root(recs, "repro_torch.learn_structure")
    assert len(group) == len(recs) == 1 + len(STAGES)
    children = sorted((r for r in group if r is not root),
                      key=lambda r: r.t0_ns)
    assert [r.name for r in children] == STAGES
    for r in children:
        assert r.parent == root.id and r.root == root.id
        assert root.t0_ns <= r.t0_ns <= r.t1_ns <= root.t1_ns
        assert r.events is None
    assert root.attrs == {"n": N, "d": D, "strategy": "sign"}
    assert 0.0 <= trace.self_s(root, group) <= root.seconds


def test_kruskal_tree_has_one_mst_span():
    with trace.recording() as recs:
        chow_liu.learn_structure(_x(), device="cpu")
    _, group = _root(recs, "repro_torch.learn_structure")
    assert sorted(r.name for r in group) == sorted(
        ["repro_torch.learn_structure"] + STAGES[:4])


def test_run_trials_span_tree():
    plan = _plan()
    with trace.recording() as recs:
        experiments.run_trials(plan, device="cpu")
    root, group = _root(recs, "repro_torch.run_trials")
    assert len(group) == len(recs)
    top = sorted((r for r in group if r.parent == root.id),
                 key=lambda r: r.t0_ns)
    per_point = ["repro_torch.sample", "repro_torch.stats",
                 "repro_torch.mst"]
    assert [r.name for r in top] == (per_point * len(plan.ns)
                                     + ["repro_torch.readback"])
    S = len(plan.strategies)
    for stats in (r for r in top if r.name == "repro_torch.stats"):
        inner = [r.name for r in group if r.parent == stats.id]
        assert sorted(inner) == sorted(STAGES[:3] * S)
    assert 0.0 <= trace.self_s(root, group) <= root.seconds


def test_host_reads_over_a_sweep_is_one(monkeypatch):
    plan = _plan()
    experiments.run_trials(plan, device="cpu")  # the plan's set-up
    seen = _reads(monkeypatch)
    with trace.recording() as recs:
        experiments.run_trials(plan, device="cpu")
    root, _ = _root(recs, "repro_torch.run_trials")
    assert root.counts == {"host_reads": 1}
    assert seen == ["cpu"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_reads_over_a_boruvka_tree(seed, monkeypatch):
    """One read a Boruvka round (the early exit) and one for the
    adjacency, each a read the tensors saw."""
    x = _x(seed)
    seen = _reads(monkeypatch)
    before = trace.counts().get("host_reads", 0)
    with trace.recording() as recs:
        chow_liu.learn_structure(x, strategy=BORUVKA, device="cpu")
    root, group = _root(recs, "repro_torch.learn_structure")
    rounds = seen.count("__int__")
    assert sorted(seen) == ["__int__"] * rounds + ["cpu"]
    assert 1 <= rounds < D
    assert root.counts["host_reads"] == 1 + rounds
    assert trace.counts()["host_reads"] - before == 1 + rounds
    by = {r.name: r.counts.get("host_reads", 0) for r in group}
    assert by["repro_torch.mst"] == rounds and by["repro_torch.edges"] == 1


def test_host_reads_of_a_two_round_chain():
    """0-1 and 2-3 join in round 1, the two pairs in round 2."""
    w = torch.zeros(4, 4)
    for (j, k), v in {(0, 1): 4.0, (2, 3): 3.0, (1, 2): 1.0}.items():
        w[j, k] = w[k, j] = v
    before = trace.counts().get("host_reads", 0)
    assert chow_liu.chow_liu(w, "boruvka") == [(0, 1), (1, 2), (2, 3)]
    assert trace.counts()["host_reads"] - before == 3


def test_results_identical_with_spans_on_and_off():
    x, plan = _x(), _plan()
    off = (chow_liu.learn_structure(x, strategy=BORUVKA, device="cpu"),
           experiments.run_trials(plan, device="cpu"))
    with trace.recording():
        on = (chow_liu.learn_structure(x, strategy=BORUVKA, device="cpu"),
              experiments.run_trials(plan, device="cpu"))
    assert on[0] == off[0]
    assert on[1].error_rate == off[1].error_rate
    assert on[1].edit_distance == off[1].edit_distance


def test_spans_are_the_profilers_user_annotations():
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chow_liu.learn_structure(_x(), strategy=BORUVKA, device="cpu")
    kept = trace.records()
    assert sorted(r.name for r in kept) == sorted(
        ["repro_torch.learn_structure"] + STAGES)
    events = {e.name: e for e in prof.events()}
    for name in STAGES:
        e, chain = events[name], []
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        assert chain[1] == "repro_torch.learn_structure", chain
    # the profiler's session is over: spans are off again
    chow_liu.learn_structure(_x(), strategy=BORUVKA, device="cpu")
    assert trace.records() == kept


def test_ring_is_bounded_and_same_name_spans_fold():
    trace.clear()
    with trace.recording() as recs:
        for _ in range(trace.RING + 5):
            with trace.span("a"):
                with trace.span("a"):
                    trace.count("trace_test", 2)
    assert len(recs) == trace.RING + 5
    assert len(trace.records()) == trace.RING
    assert trace.records()[-1] is recs[-1]
    assert all(r.parent is None and r.counts == {"trace_test": 2}
               for r in recs)
    trace.clear()


def test_self_time_is_less_the_childrens_union():
    def rec(sid, parent, t0, t1):
        return trace.Span("s", sid, parent, 1, {}, t0, t1)

    root = rec(1, None, 0, 100)
    kids = [rec(2, 1, 10, 40), rec(3, 1, 30, 50), rec(4, 1, 70, 80),
            rec(5, 2, 0, 100)]
    assert trace.self_s(root, [root] + kids) == pytest.approx(50e-9)
