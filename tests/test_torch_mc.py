"""The port's single-dataset and scalar Monte-Carlo engines
(``evaluate_strategies``, ``learned_adjacency``, ``mc_sign_crossover``,
``mc_persymbol_corr_error``) and ``core.bounds`` against ``repro``'s, on
the CPU (moved here from ``test_torch_trials.py``, names and bodies
unchanged). Counts are equal; f32 means within ``rtol=1e-5``.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bounds as j_bounds
from repro.core import experiments as je
from repro.core import sampler as j_sampler
from repro.core import strategy as j_strategy
from repro_torch.core import bounds as t_bounds
from repro_torch.core import experiments as te
from repro_torch.core.strategy import Strategy
from repro_torch.interop import strategy_from_fields

D, NS, REPS = 20, (100, 250), 8
J_FIG3 = tuple(j_strategy.FIG3_STRATEGIES)


def _port(s) -> Strategy:
    return strategy_from_fields(dataclasses.asdict(s))


def _plans(strategies, **kw):
    base = dict(d=D, ns=NS, reps=REPS)
    base.update(kw)
    return (je.TrialPlan(strategies=strategies, **base),
            te.TrialPlan(strategies=tuple(_port(s) for s in strategies),
                         **base))


# --------------------------------------------------------------------------
# Single-dataset and scalar engines, bounds
# --------------------------------------------------------------------------

def test_evaluate_strategies_matches_repro():
    jp, _ = _plans(J_FIG3, reps=1)
    par, rho, adj = je.stacked_trees(jp)
    x = np.asarray(j_sampler.sample_tree_ggm_rows_batch(
        je.trial_keys(jp), 300, par, rho))[0]
    want = je.evaluate_strategies(jnp.asarray(x), adj[0], J_FIG3)
    got = te.evaluate_strategies(x, np.asarray(adj[0]),
                                 [_port(s) for s in J_FIG3], device="cpu")
    assert got == want
    est = te.learned_adjacency(torch.from_numpy(x), _port(J_FIG3[0]))
    np.testing.assert_array_equal(
        est.numpy(), np.asarray(je.learned_adjacency(jnp.asarray(x),
                                                     J_FIG3[0])))


@pytest.mark.parametrize("n,rho_e,rho_ep,seed", [(200, 0.6, 0.5, 3),
                                                 (64, 0.8, 0.75, 0)])
def test_mc_sign_crossover_matches_repro(n, rho_e, rho_ep, seed):
    """Every count in it is a sign test on samples within a few ulps of
    repro's: equal unless a sample sits within ulps of 0 (none here)."""
    want = je.mc_sign_crossover(n, rho_e, rho_ep, 256, seed=seed)
    got = te.mc_sign_crossover(n, rho_e, rho_ep, 256, seed=seed,
                               device="cpu")
    assert got == want
    assert 0.0 < got < 1.0


@pytest.mark.parametrize("rate", [1, 2, 4])
@pytest.mark.parametrize("against_empirical", [False, True])
def test_mc_persymbol_corr_error_matches_repro(rate, against_empirical):
    """f32 means summed in another order: within rtol 1e-5."""
    kw = dict(against_empirical=against_empirical, seed=2)
    want = je.mc_persymbol_corr_error(300, 0.7, rate, 128, **kw)
    got = te.mc_persymbol_corr_error(300, 0.7, rate, 128, device="cpu",
                                     **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bounds_are_repros():
    n = np.array([10, 100, 1000])
    for fn, args in [("h_alpha_beta", (0.5, 0.8)),
                     ("theorem1_bound", (n, 20, 0.5, 0.8)),
                     ("crossover_hoeffding", (n, 0.7, 0.6)),
                     ("shared_node_probs", (0.7, 0.5)),
                     ("crossover_chernoff", (n, 0.5, 0.3, 0.2)),
                     ("chernoff_exponent", (0.5, 0.3, 0.2)),
                     ("crossover_exact", (40, 0.5, 0.3, 0.2)),
                     ("theorem2_bound", (0.1, 0.2)),
                     ("union_bound_recovery", (n, [0.8, 0.7], [0.6, 0.65]))]:
        np.testing.assert_array_equal(getattr(t_bounds, fn)(*args),
                                      getattr(j_bounds, fn)(*args))
    for rate in range(1, 8):
        assert (t_bounds.persymbol_est_error_bound(rate, 500, 0.6)
                == j_bounds.persymbol_est_error_bound(rate, 500, 0.6))
