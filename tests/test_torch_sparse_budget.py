"""The port's sparse trial plane under memory budgets (solve slabs, points
solved apart, ``metrics_chunk``) against ``repro``'s, on the CPU (moved
here from ``test_torch_trials.py``, names and bodies unchanged). Sweeps
are held by ``tests/_sparse_parity.py``'s threshold rule; integer pieces
exactly.
"""
import dataclasses

import pytest

from repro.core import experiments as je
from repro.core import strategy as j_strategy
from repro_torch.core import experiments as te
from repro_torch.core import path as t_path
from repro_torch.core.strategy import Strategy
from repro_torch.interop import strategy_from_fields

J_SPARSE = (j_strategy.Strategy("sign", structure="sparse", lam=0.08),
            j_strategy.Strategy("persymbol", rate=4, structure="sparse",
                                lam=0.06))


def _port(s) -> Strategy:
    return strategy_from_fields(dataclasses.asdict(s))


def _sparse_plans(strategies=J_SPARSE, **kw):
    base = dict(d=10, ns=(300, 900), tree="sparse", density=0.25, reps=6,
                glasso_steps=150)
    base.update(kw)
    return (je.TrialPlan(strategies=strategies, **base),
            te.TrialPlan(strategies=tuple(_port(s) for s in strategies),
                         **base))


@pytest.mark.parametrize("path", [None, "ebic"])
def test_sparse_points_solve_apart_when_together_would_not_fit(
        path, monkeypatch):
    """A budget that holds one point's S*reps solve but not every point's
    at once: repro's tiling, one solve a point, repro's metrics, and the
    combined solve's results bit for bit."""
    import _sparse_parity

    jp, tp = _sparse_plans()
    if path is not None:
        jp = dataclasses.replace(jp, path=je.PathPlan(n_lams=4))
        tp = dataclasses.replace(tp, path=t_path.PathPlan(n_lams=4))
    per_trial = (40 + (0 if path is None else 4)) * tp.d ** 2
    lanes = len(tp.strategies) * tp.reps
    budget = 3 * lanes * per_trial  # half of it: 1.5 points' scratch
    jp, tp = (dataclasses.replace(p, memory_budget_bytes=budget)
              for p in (jp, tp))
    assert tp.metrics_chunk() is None and not te._solve_points_together(tp)
    name = "_sparse_metric_sums" if path is None else \
        "_sparse_path_metric_sums"
    calls, orig = [], getattr(te, name)

    def spy(corr, *a, **k):
        calls.append(corr.shape[0])
        return orig(corr, *a, **k)

    monkeypatch.setattr(te, name, spy)
    got = te.run_trials(tp, device="cpu")
    assert calls == [1] * len(tp.ns)
    monkeypatch.setattr(te, "_solve_points_together", lambda plan: True)
    together = te.run_trials(tp, device="cpu")
    assert calls[len(tp.ns):] == [len(tp.ns)]
    for f in _sparse_parity.METRICS:
        assert getattr(got, f) == getattr(together, f), f
    assert got.path == together.path
    _sparse_parity.assert_sparse_sweeps_agree(jp, tp, je.run_trials(jp), got)


def test_sparse_metrics_chunk_is_repros():
    for budget in (1 << 16, 1 << 20, None):
        jp, tp = _sparse_plans(memory_budget_bytes=budget)
        assert tp.metrics_chunk() == jp.metrics_chunk()
        jpp = dataclasses.replace(jp, path=je.PathPlan(n_lams=6))
        tpp = dataclasses.replace(tp, path=t_path.PathPlan(n_lams=6))
        assert tpp.metrics_chunk() == jpp.metrics_chunk()


def test_sparse_tiny_budget_metric_identity():
    """A budget small enough to slab the glasso solve: repro's slab size,
    and the unbudgeted sweep's metrics bit for bit."""
    jp, tp = _sparse_plans(ns=(300,), reps=4, glasso_steps=60,
                           memory_budget_bytes=1 << 15)
    assert tp.metrics_chunk() == jp.metrics_chunk() is not None
    got = te.run_trials(tp, device="cpu")
    whole = te.run_trials(dataclasses.replace(tp, memory_budget_bytes=None),
                          device="cpu")
    assert got.tiling["metrics_chunk"] == tp.metrics_chunk()
    assert whole.tiling["metrics_chunk"] is None
    for field in ("error_rate", "edit_distance", "edge_f1", "precision",
                  "recall"):
        assert getattr(got, field) == getattr(whole, field), field
