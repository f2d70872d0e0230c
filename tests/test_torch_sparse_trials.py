"""The port's sparse trial plane (``run_trials`` of sparse plans,
``sparse_ground_truth``, the sparse validation and support channels)
against ``repro``'s, on the CPU at d = 10-16 (moved here from
``test_torch_trials.py``, names and bodies unchanged; the memory-budget
cases are in ``test_torch_sparse_budget.py``). Sweeps are held by
``tests/_sparse_parity.py``'s threshold rule; integer pieces exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import experiments as je
from repro.core import sampler as j_sampler
from repro.core import strategy as j_strategy
from repro_torch.core import experiments as te
from repro_torch.core.strategy import Strategy
from repro_torch.interop import strategy_from_fields


def _port(s) -> Strategy:
    return strategy_from_fields(dataclasses.asdict(s))


def _comm(result):
    return {k: [dataclasses.asdict(r) for r in v]
            for k, v in result.comm.items()}


def _key_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# --------------------------------------------------------------------------
# The sparse plane: tests/test_experiments.py's sparse plans
# --------------------------------------------------------------------------

J_SPARSE = (j_strategy.Strategy("sign", structure="sparse", lam=0.08),
            j_strategy.Strategy("persymbol", rate=4, structure="sparse",
                                lam=0.06))


def _sparse_plans(strategies=J_SPARSE, **kw):
    base = dict(d=10, ns=(300, 900), tree="sparse", density=0.25, reps=6,
                glasso_steps=150)
    base.update(kw)
    return (je.TrialPlan(strategies=strategies, **base),
            te.TrialPlan(strategies=tuple(_port(s) for s in strategies),
                         **base))


@pytest.mark.parametrize("buckets", ["pow2", None])
def test_sparse_run_trials_matches_repro(buckets):
    import _sparse_parity

    jp, tp = _sparse_plans(n_buckets=buckets)
    want = je.run_trials(jp)
    got = te.run_trials(tp, device="cpu")
    _sparse_parity.assert_sparse_sweeps_agree(jp, tp, want, got)
    assert _comm(got) == _comm(want)
    assert got.path is None and got.buckets == want.buckets
    for lab in got.edge_f1:
        for f1, p, r in zip(got.edge_f1[lab], got.precision[lab],
                            got.recall[lab]):
            assert abs(f1 - 2 * p * r / max(p + r, 1e-9)) < 1e-5


def test_sparse_sweep_with_more_strategies_and_wires():
    """The sparse plane's four methods and both wires at d = 16."""
    import _sparse_parity

    strategies = (j_strategy.Strategy("sign", wire="packed",
                                      structure="sparse", lam=0.06),
                  j_strategy.Strategy("persymbol", rate=2,
                                      structure="sparse", lam=0.06),
                  j_strategy.Strategy("original", structure="sparse",
                                      lam=0.06))
    jp, tp = _sparse_plans(strategies, d=16, ns=(250, 1000), reps=4,
                           density=0.18, rho_min=0.25, rho_max=0.45,
                           glasso_steps=300)
    want = je.run_trials(jp)
    got = te.run_trials(tp, device="cpu")
    _sparse_parity.assert_sparse_sweeps_agree(jp, tp, want, got)
    assert _comm(got) == _comm(want)


def test_parity_catches_a_planted_lam_order(monkeypatch):
    """A sweep that hands each strategy's trials another strategy's
    penalty gives metrics its points solved alone do not: the parity
    check must fail on it, however close the supports come to repro's."""
    import _sparse_parity

    strategies = (j_strategy.Strategy("sign", structure="sparse", lam=0.3),
                  j_strategy.Strategy("persymbol", rate=4,
                                      structure="sparse", lam=0.03))
    jp, tp = _sparse_plans(strategies, reps=4)
    want = je.run_trials(jp)
    orig = te._sparse_metric_sums
    monkeypatch.setattr(te, "_sparse_metric_sums",
                        lambda corr, adj, lams, *a, **k: orig(
                            corr, adj, lams[::-1], *a, **k))
    got = te.run_trials(tp, device="cpu")
    with pytest.raises(AssertionError, match="is not the point's own"):
        _sparse_parity.assert_sparse_sweeps_agree(jp, tp, want, got)


def test_sparse_ground_truth_and_keys_are_repros():
    jp, tp = _sparse_plans(seed0=7)
    for a, b in zip(je.sparse_ground_truth(jp),
                    te.sparse_ground_truth(tp, device="cpu")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(te.trial_keys(tp, device="cpu").numpy(),
                                  _key_data(je.trial_keys(jp)))
    chols, adj = te.sparse_ground_truth(tp, device="cpu")
    assert chols.dtype == torch.float32 and adj.dtype == torch.bool


def _sparse_validation_cases():
    sign = j_strategy.Strategy("sign", structure="sparse", lam=0.1)
    return [
        dict(tree="sparse", strategies=(j_strategy.Strategy("sign"), sign)),
        dict(tree="random", strategies=(sign,)),
        dict(tree="sparse", strategies=(j_strategy.Strategy("sign"),)),
        dict(tree="sparse", strategies=(sign,), density=0.0),
        dict(tree="sparse", strategies=(sign,), density=1.5),
        dict(strategies=(j_strategy.Strategy("sign"),), path="ebic"),
    ]


@pytest.mark.parametrize("case", range(6))
def test_sparse_plan_validation_is_repros(case):
    kw = _sparse_validation_cases()[case]
    tkw = dict(kw, strategies=tuple(_port(s) for s in kw["strategies"]))
    with pytest.raises((ValueError, TypeError)) as want:
        je.TrialPlan(d=10, ns=(100,), **kw)
    with pytest.raises(want.type) as got:
        te.TrialPlan(d=10, ns=(100,), **tkw)
    assert str(got.value) == str(want.value)


def test_sparse_plans_reject_host_kruskal_as_repro_does():
    jp, tp = _sparse_plans()
    with pytest.raises(ValueError) as want:
        je.run_trials(jp, mst="host_kruskal")
    with pytest.raises(ValueError) as got:
        te.run_trials(tp, mst="host_kruskal", device="cpu")
    assert str(got.value) == str(want.value)


def test_sparse_evaluate_strategies_matches_repro():
    from repro.core import glasso as jg

    jp, _ = _sparse_plans(reps=1, d=12, density=0.2)
    chols, adj = je.sparse_ground_truth(jp)
    x = np.array(j_sampler.sample_ggm_rows_batch(
        je.trial_keys(jp), 2000, chols))[0]
    strategies = J_SPARSE + (j_strategy.Strategy(
        "original", structure="sparse", lam=0.05),)
    want = je.evaluate_strategies(jnp.asarray(x), adj[0], strategies,
                                  glasso_steps=300)
    got = te.evaluate_strategies(x, np.asarray(adj[0]),
                                 [_port(s) for s in strategies],
                                 glasso_steps=300, device="cpu")
    for s in strategies:
        est = te.learned_adjacency(torch.from_numpy(x), _port(s),
                                   glasso_steps=300)
        ref = je.learned_adjacency(jnp.asarray(x), s, glasso_steps=300)
        if got[s.label] != want[s.label] or not np.array_equal(
                est.numpy(), np.asarray(ref)):
            from repro.core import estimators as je_est
            corr = je_est.strategy_corr(jnp.asarray(x), s)
            theta = jg.glasso_batch(corr[None], s.lam, n_steps=300)[0]
            from repro_torch.core import glasso as tg
            assert tg.far_mismatches(est, np.asarray(theta)) == 0, s.label


def test_sparse_setup_cache_serves_and_clears():
    te.clear_compile_caches()
    _, tp = _sparse_plans(ns=(64,), reps=2, glasso_steps=10)
    te.run_trials(tp, device="cpu")
    assert te.compile_cache_size() == 2  # the host truths and the bundle
    te.run_trials(dataclasses.replace(tp, ns=(80,)), device="cpu")
    te.trial_keys(tp, device="cpu")
    assert te.compile_cache_size() == 2
    assert te.clear_compile_caches() == 2


def test_support_metric_channels_are_repros_bit_for_bit():
    rng = np.random.default_rng(11)
    est = rng.random((3, 5, 9, 9)) < 0.3
    true = rng.random((5, 9, 9)) < 0.25
    for a in (est, true):
        a |= np.swapaxes(a, -1, -2)
        a[..., np.arange(9), np.arange(9)] = False
    want = np.asarray(je._support_metric_channels(jnp.asarray(est),
                                                  jnp.asarray(true)[None]))
    got = te._support_metric_channels(torch.from_numpy(est),
                                      torch.from_numpy(true)[None])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 5)
