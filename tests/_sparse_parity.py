"""Hold a sparse sweep of the port to ``repro``'s on the same plan.

Every metric must be equal, or differ only as
``repro_torch.core.experiments.sparse_sweep_faults`` allows: the point,
solved alone by the port, gives exactly what the port's sweep gave it,
and its supports part from ``repro``'s own solve of the point (each
package's corr stage, each package's solver) only at entries whose
partial correlations sit within ``glasso.THRESHOLD_BAND`` of
``glasso_tol`` (ROADMAP §3), or, on a path, at EBIC picks whose scores
tie.
"""
import numpy as np
import jax.numpy as jnp

from repro.core import experiments as je
from repro.core import glasso as jg
from repro.core import path as jpath
from repro.core.faults import fault_trial_keys as j_fault_keys
from repro.core.gram import resolve_engine as j_engine
from repro_torch.core import experiments as te

METRICS = ("error_rate", "edit_distance", "edge_f1", "precision", "recall")


def repro_corr(jplan, n):
    """``repro``'s (S, r, d, d) statistics of one point, as numpy."""
    chols, _, keys = je._sparse_plan_setup(*je._sparse_setup_key(jplan))
    lead = () if jplan.faults is None else (
        j_fault_keys(jplan.faults, jplan.reps),)
    out = je._corr_stage(jplan.strategies, jplan.bucket_for(n),
                         j_engine(None), jplan.faults)(
        keys, *lead, chols, jnp.asarray(n, jnp.int32))
    return np.asarray(out if jplan.faults is None else out[0])


def repro_point(jplan):
    """``ref_point`` of ``sparse_sweep_faults``: ``repro``'s own solve of
    strategy i at ``jplan.ns[j]`` -> (thetas, picks, EBIC scores)."""
    def point(i, j):
        n = jplan.ns[j]
        S = jnp.asarray(repro_corr(jplan, n)[i])
        if jplan.path is None:
            return np.asarray(jg.glasso_batch(
                S, jplan.strategies[i].lam, n_steps=jplan.glasso_steps)), \
                None, None
        plan = jplan.path
        solve = jpath.glasso_path_batch(
            S, jpath.path_lambdas(plan, S), n_steps=jplan.glasso_steps,
            conv_tol=plan.conv_tol, support_tol=jplan.glasso_tol,
            keep_thetas=True)
        picks = np.asarray(jpath.path_select(solve, plan, n, jplan.d))
        scores = None if plan.select == "stars" else np.asarray(
            jpath.ebic_scores(solve.logdet, solve.tr_s_theta, solve.edges,
                              n, jplan.d, plan.ebic_gamma))
        return np.asarray(solve.thetas), picks, scores
    return point


def assert_sparse_sweeps_agree(jplan, tplan, want, got):
    """``got`` (the port's TrialResult) against ``want`` (repro's)."""
    assert got.host_syncs == want.host_syncs == 1
    assert got.buckets == want.buckets
    assert got.tiling == want.tiling
    assert got.faults == want.faults
    _, faults = te.sparse_sweep_faults(tplan, got, want, repro_point(jplan),
                                       device="cpu")
    assert not faults, faults
    assert (got.path is None) == (want.path is None)
    if want.path is None:
        return
    assert got.path.keys() == want.path.keys()
    assert (got.path["select"], got.path["k"]) == (want.path["select"],
                                                   want.path["k"])
    for key in ("lams", "error_rate", "edge_f1", "iters", "selected_hist"):
        for lab, curves in want.path[key].items():
            assert np.shape(got.path[key][lab]) == np.shape(curves), key
    for lab, grids in want.path["lams"].items():
        # per-trial grids summed over the reps in another order
        np.testing.assert_allclose(got.path["lams"][lab], grids, rtol=1e-6)
    for lab, hist in got.path["selected_hist"].items():
        assert all(sum(row) == tplan.reps for row in hist)
