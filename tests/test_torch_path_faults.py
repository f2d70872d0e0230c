"""The parity rule catches a planted path fault (``test_torch_path.py``'s
check, moved here with its name and body unchanged): a sweep that hands
EBIC the wrong point's sample count, or StARS the wrong lanes, must fail
``tests/_sparse_parity.py``'s check.
"""
import dataclasses

import pytest

from repro.core import experiments as je
from repro.core import path as jpath
from repro.core import strategy as j_strategy
from repro_torch.core import experiments as te
from repro_torch.core import path as tpath
from repro_torch.interop import strategy_from_fields

import _sparse_parity


STRAT = j_strategy.Strategy("sign", structure="sparse", lam=0.08)


def _plans(path_kw, **kw):
    base = dict(d=10, ns=(200, 800), tree="sparse", density=0.2,
                strategies=(STRAT,), reps=8, glasso_steps=150)
    base.update(kw)
    port = dict(base, strategies=tuple(
        strategy_from_fields(dataclasses.asdict(s))
        for s in base["strategies"]))
    return (je.TrialPlan(path=jpath.PathPlan(**path_kw), **base),
            te.TrialPlan(path=tpath.PathPlan(**path_kw), **port))


def _planted(monkeypatch, name, wrong):
    """Replace experiments.<name> with ``wrong(original, *args)``."""
    orig = getattr(te, name)
    monkeypatch.setattr(te, name, lambda *a, **k: wrong(orig, *a, **k))


@pytest.mark.parametrize("fault", ["n-order", "stars-groups"])
def test_parity_catches_a_planted_path_fault(fault, monkeypatch):
    """A sweep that hands EBIC the wrong point's sample count, or StARS
    the wrong lanes as a strategy's subsample batch, gives metrics its
    points solved alone do not: the parity check must fail on it, even
    where the per-lam supports agree with repro's near the threshold."""
    if fault == "n-order":
        path_kw, kw = dict(n_lams=5, lam_min_ratio=0.05), dict(ns=(60, 4000))
        _planted(monkeypatch, "_sparse_path_metric_sums",
                 lambda f, corr, adj, ns, *a, **k: f(corr, adj, ns[::-1],
                                                     *a, **k))
    else:
        path_kw = dict(n_lams=4, lam_min_ratio=0.1, select="stars",
                       stars_beta=0.2)
        kw = dict(ns=(100, 4000), reps=4)
        # the points' lanes interleaved: each group mixes both points
        _planted(monkeypatch, "_sparse_path_metric_sums",
                 lambda f, corr, *a, **k: f(
                     corr.transpose(0, 2).reshape(corr.shape), *a, **k))
    jplan, tplan = _plans(path_kw, **kw)
    want = je.run_trials(jplan)
    got = te.run_trials(tplan, device="cpu")
    with pytest.raises(AssertionError, match="is not the point's own"):
        _sparse_parity.assert_sparse_sweeps_agree(jplan, tplan, want, got)
