"""The port's path trial plane (``run_trials`` of ``PathPlan`` sweeps,
``sparse_point``, ``path.parting_faults``) against ``repro``'s, on the
CPU at test_path.py's plans (moved here from ``test_torch_path.py``,
names and bodies unchanged). Sweeps are held by
``tests/_sparse_parity.py``'s threshold rule.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import experiments as je
from repro.core import path as jpath
from repro.core import strategy as j_strategy
from repro_torch.core import experiments as te
from repro_torch.core import glasso as tg
from repro_torch.core import path as tpath
from repro_torch.interop import strategy_from_fields

import _sparse_parity


# --------------------------------------------------------------------------
# The path trial plane: test_path.py's plans
# --------------------------------------------------------------------------

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


@pytest.mark.parametrize("name,path_kw,kw", [
    ("ebic", dict(n_lams=5, lam_min_ratio=0.08), {}),
    ("stars", dict(n_lams=5, lam_min_ratio=0.1, select="stars",
                   stars_beta=0.2), dict(ns=(400,), glasso_steps=120)),
    ("two-strategies", dict(n_lams=4, lam_min_ratio=0.1),
     dict(strategies=(STRAT, j_strategy.Strategy(
         "persymbol", rate=4, structure="sparse", lam=0.06)), reps=4)),
])
def test_path_trial_plane_matches_repro(name, path_kw, kw):
    jplan, tplan = _plans(path_kw, **kw)
    want = je.run_trials(jplan)
    got = te.run_trials(tplan, device="cpu")
    _sparse_parity.assert_sparse_sweeps_agree(jplan, tplan, want, got)
    # a lane stops where its solver reaches the plateau: the step counts
    # of one trial can part by tens, so only their range is held
    for lab, curves in got.path["iters"].items():
        assert all(0 < v <= tplan.glasso_steps for row in curves
                   for v in row)
    if name == "stars":  # one pick a strategy: a point mass
        hist = np.asarray(got.path["selected_hist"][STRAT.label][0])
        assert hist.max() == tplan.reps


def test_path_trial_plane_tiny_budget_metric_identity():
    """A tiny memory budget slabs the path solve; the metrics and the
    path telemetry equal the unbudgeted sweep's bit for bit."""
    kw = dict(ns=(200,), glasso_steps=120)
    path_kw = dict(n_lams=4, lam_min_ratio=0.1)
    _, tplan = _plans(path_kw, **kw)
    jtiny, tiny = _plans(path_kw, memory_budget_bytes=1 << 16, **kw)
    assert tiny.metrics_chunk() == jtiny.metrics_chunk() is not None
    ref = te.run_trials(tplan, device="cpu")
    got = te.run_trials(tiny, device="cpu")
    assert got.tiling["metrics_chunk"] == tiny.metrics_chunk()
    for f in _sparse_parity.METRICS:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.path == ref.path


def test_parity_tracers_hold_a_point():
    """The near-threshold rule's two halves on points whose metrics agree:
    the point solved alone gives exactly what the sweep gave it (fixed lam
    and on a path), and with no support parted and no pick tied, a metric
    difference would stand unexplained."""
    jplan, tplan = _plans(dict(n_lams=4, lam_min_ratio=0.1), ns=(200,),
                          reps=4)
    jfix = dataclasses.replace(jplan, path=None)
    tfix = dataclasses.replace(tplan, path=None)
    for jp, tp in ((jplan, tplan), (jfix, tfix)):
        got = te.run_trials(tp, device="cpu")
        point = te.sparse_point(tp, 200, 0, device="cpu")
        assert point.mismatches(got, 0) == []
        theta, picks, scores = _sparse_parity.repro_point(jp)(0, 0)
        diff, faults = tpath.parting_faults(
            point.support, theta, tp.glasso_tol,
            picks=None if point.picks is None else point.picks.numpy(),
            ref_picks=picks, ref_scores=scores)
        assert diff == 0
        assert faults == ["the results differ but no support entry parted"]


def _theta_with_partial(p: float, d: int = 4) -> np.ndarray:
    """A (d, d) precision whose (0, 1) partial correlation is ``p``, every
    other off-diagonal entry 0."""
    theta = np.eye(d, dtype=np.float32)
    theta[0, 1] = theta[1, 0] = -p
    return theta


@pytest.mark.parametrize("case", [
    "equal", "parted-near", "parted-far", "ebic-tie", "ebic-apart",
    "ebic-parted", "stars-equal", "stars-parted"])
def test_parting_faults_rule(case):
    """path.parting_faults on planted results: a support may part only at
    a partial correlation within THRESHOLD_BAND of tol, something must
    part (or an EBIC pick tie) to explain a difference, and a differing
    pick needs a parted support or (EBIC) tied scores."""
    tol, band = tg.SUPPORT_TOL, tg.THRESHOLD_BAND
    near = _theta_with_partial(tol + band / 2)
    far = _theta_with_partial(tol + 4 * band)
    theta = np.stack([near, far])                                # (r=2,)
    est = tg.support_from_theta(torch.from_numpy(theta), tol).numpy()
    if case == "equal":
        diff, faults = tpath.parting_faults(est, theta, tol)
        assert (diff, faults) == (
            0, ["the results differ but no support entry parted"])
        return
    if case.startswith("parted"):
        lane = 0 if case == "parted-near" else 1
        est[lane, 0, 1] = est[lane, 1, 0] = False
        diff, faults = tpath.parting_faults(est, theta, tol)
        assert diff == 2
        assert faults == ([] if lane == 0 else [
            "2 support entries part away from the threshold"])
        return
    # a path of K = 2 lams: the same supports at both
    thetas, sups = np.stack([theta, theta]), np.stack([est, est])
    picks, ref_picks = np.array([0, 1]), np.array([0, 0])
    if case.startswith("stars"):
        picks = np.array([1, 1])
        if case == "stars-parted":
            sups[1, 0, 0, 1] = sups[1, 0, 1, 0] = False
        diff, faults = tpath.parting_faults(sups, thetas, tol, picks=picks,
                                            ref_picks=ref_picks)
        faults_of = {"stars-equal": [
            "StARS picks 1 vs 0 with every support equal",
            "the results differ but no support entry parted"],
            "stars-parted": []}
        assert faults == faults_of[case]
        return
    scores = np.array([[10.0, 10.0], [10.0, 10.0 + 1e-2]])
    if case == "ebic-tie":
        scores[1, 1] = 10.0 * (1 + tpath.SCORE_RTOL / 2)
    if case == "ebic-parted":
        sups[0, 1, 0, 1] = sups[0, 1, 1, 0] = False
        theta_far = thetas.copy()
        theta_far[0, 1] = _theta_with_partial(tol + band / 4)
        thetas = theta_far
    diff, faults = tpath.parting_faults(sups, thetas, tol, picks=picks,
                                        ref_picks=ref_picks,
                                        ref_scores=scores)
    want = {"ebic-tie": [], "ebic-parted": [], "ebic-apart": [
        "trial 1: EBIC picks 1 vs 0 (scores 10.01, 10.0) "
        "with its supports equal",
        "the results differ but no support entry parted"]}
    assert faults == want[case], faults
