"""The port's trial plane (``repro_torch.core.experiments``) against
``repro``'s, on the CPU at Fig. 3's width (d = 20). The scalar engines
and bounds are in ``test_torch_mc.py``, the sparse plane's sweeps in
``test_torch_sparse_trials.py``.

Samples are held to ``repro``'s within ``SAMPLE_TOL`` (the normals are
within a few ulps, the mixing product sums in another order); the
integer Grams bit for bit; the weights to ``WEIGHT_TOL`` (ROADMAP §3);
the sweeps' metrics, buckets, communication reports and host syncs
exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import estimators as j_est
from repro.core import experiments as je
from repro.core import sampler as j_sampler
from repro.core import strategy as j_strategy
from repro_torch.core import chow_liu as t_chow_liu
from repro_torch.core import estimators as t_est
from repro_torch.core import experiments as te
from repro_torch.core import path as t_path
from repro_torch.core import sampler as t_sampler
from repro_torch.core.strategy import Strategy
from repro_torch.interop import strategy_from_fields

SAMPLE_TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHT_TOL = dict(rtol=1e-6, atol=2.5e-7)
GRAM_TOL_PER_N = 1e-5  # f32 float Grams: rtol 1e-5, atol 1e-5 * n
D, NS, REPS = 20, (100, 250), 8

#: the Fig. 3 suite, and the packed wires as a second plan: their labels
#: ("sign", "R2") are the suite's own, and a plan's labels are unique
J_FIG3 = tuple(j_strategy.FIG3_STRATEGIES)
J_PACKED = (j_strategy.Strategy("sign", wire="packed"),
            j_strategy.Strategy("persymbol", rate=2, wire="packed"))
J_ALL = J_FIG3 + J_PACKED


def _port(s) -> Strategy:
    return strategy_from_fields(dataclasses.asdict(s))


def _plans(strategies, **kw):
    base = dict(d=D, ns=NS, reps=REPS)
    base.update(kw)
    return (je.TrialPlan(strategies=strategies, **base),
            te.TrialPlan(strategies=tuple(_port(s) for s in strategies),
                         **base))


def _comm(result):
    return {k: [dataclasses.asdict(r) for r in v]
            for k, v in result.comm.items()}


def _key_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# --------------------------------------------------------------------------
# Samplers and setup
# --------------------------------------------------------------------------

def test_row_samplers_prefix_stable_and_match_repro():
    d, t = 13, 3
    jp, tp = _plans(J_FIG3, d=d, reps=t)
    par, rho, _ = je.stacked_trees(jp)
    jkeys = je.trial_keys(jp)
    tpar, trho, _ = te.stacked_trees(tp, device="cpu")
    tkeys = te.trial_keys(tp, device="cpu")
    got = t_sampler.sample_tree_ggm_rows_batch(tkeys, 40, tpar, trho)
    want = np.asarray(j_sampler.sample_tree_ggm_rows_batch(jkeys, 40, par,
                                                           rho))
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)
    # the first m rows of an (n, d) draw are the (m, d) draw, bit for bit
    head = t_sampler.sample_tree_ggm_rows_batch(tkeys, 17, tpar, trho)
    assert torch.equal(head, got[:, :17])
    one = t_sampler.sample_tree_ggm_rows(tkeys[1], 9, tpar[1], trho[1])
    assert torch.equal(one, got[1, :9])
    # the generic row-keyed sampler through Cholesky factors
    rng = np.random.default_rng(4)
    a = rng.standard_normal((t, d, d)).astype(np.float32) * 0.3
    chol = np.tril(a) + np.eye(d, dtype=np.float32)
    got = t_sampler.sample_ggm_rows_batch(tkeys, 25, torch.from_numpy(chol))
    want = np.asarray(j_sampler.sample_ggm_rows_batch(jkeys, 25,
                                                      jnp.asarray(chol)))
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)
    assert torch.equal(t_sampler.sample_ggm_rows(tkeys[0], 11,
                                                 torch.from_numpy(chol[0])),
                       got[0, :11])


@pytest.mark.parametrize("tree", ["random", "star", "chain", "skeleton"])
def test_stacked_trees_and_keys_are_repros(tree):
    jp, tp = _plans(J_FIG3, tree=tree, reps=5, seed0=3)
    for a, b in zip(je.stacked_trees(jp), te.stacked_trees(tp, device="cpu")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(te.trial_keys(tp, device="cpu").numpy(),
                                  _key_data(je.trial_keys(jp)))


# --------------------------------------------------------------------------
# The weights stage
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", J_ALL, ids=lambda s: f"{s.label}-{s.wire}")
def test_weights_stage_on_repros_samples(s):
    """repro's bucketed samples through the port's batched weights: the
    integer Grams bit for bit, the float Grams and all weights within the
    stated tolerances."""
    jp, _ = _plans(J_FIG3)
    par, rho, _ = je.stacked_trees(jp)
    x = np.asarray(j_sampler.sample_tree_ggm_rows_batch(
        je.trial_keys(jp), 128, par, rho))
    n = 100
    ts = _port(s)
    want_g = np.asarray(j_est.payload_gram(
        j_est.strategy_payload(jnp.asarray(x), s, n_valid=n), s, n_valid=n))
    got_g = t_est.payload_gram(
        t_est.strategy_payload(torch.from_numpy(x), ts, n_valid=n), ts,
        n_valid=n).numpy()
    if s.method == "sign" or (s.method == "persymbol" and s.rate == 1):
        np.testing.assert_array_equal(got_g, want_g)
    else:
        np.testing.assert_allclose(got_g, want_g, rtol=GRAM_TOL_PER_N,
                                   atol=GRAM_TOL_PER_N * n)
    want = np.asarray(j_est.strategy_weights_batch(jnp.asarray(x), s,
                                                   n_valid=n))
    got = t_est.strategy_weights_batch(torch.from_numpy(x), ts, n_valid=n)
    np.testing.assert_allclose(got.numpy(), want, **WEIGHT_TOL)


@pytest.mark.parametrize("s", J_ALL, ids=lambda s: f"{s.label}-{s.wire}")
@pytest.mark.parametrize("n", [96, 100, 125])
def test_payload_layout_is_the_payloads(s, n):
    """CommReport's wire bytes come from the payload layout; it is the
    real payload's shape and dtype."""
    ts = _port(s)
    x = torch.randn(n, 24, generator=torch.Generator().manual_seed(n))
    payload = t_est.strategy_payload(x, ts)
    assert t_est.payload_layout(ts, n, 24) == (tuple(payload.shape),
                                               payload.dtype)


# --------------------------------------------------------------------------
# Whole sweeps
# --------------------------------------------------------------------------

SWEEPS = {
    "fig3-pow2": (J_FIG3, "pow2"),
    "fig3-exact": (J_FIG3, None),
    "packed-pow2": (J_PACKED, "pow2"),
    "packed-exact": (J_PACKED, None),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_run_trials_matches_repro(name):
    strategies, buckets = SWEEPS[name]
    jp, tp = _plans(strategies, n_buckets=buckets)
    want = je.run_trials(jp)
    got = te.run_trials(tp, device="cpu")
    # every metric is a ratio of integer channel sums: equal, not close
    for field in ("error_rate", "edit_distance", "edge_f1", "precision",
                  "recall", "buckets", "host_syncs", "faults", "tiling"):
        assert getattr(got, field) == getattr(want, field), field
    assert _comm(got) == _comm(want)
    assert got.host_syncs == 1
    # not a degenerate sweep: some trials recover the tree, some do not
    rates = [v for vs in got.error_rate.values() for v in vs]
    assert min(rates) < 1.0 and max(rates) > 0.0
    assert got.compile_cache_size >= 2


def test_host_kruskal_equals_device():
    _, tp = _plans(J_FIG3[1:3] + J_PACKED[:1], reps=4)
    dev = te.run_trials(tp, device="cpu")
    host = te.run_trials(tp, device="cpu", mst="host_kruskal")
    for field in ("error_rate", "edit_distance", "edge_f1", "buckets"):
        assert getattr(host, field) == getattr(dev, field), field
    assert host.host_syncs == 1


def test_fixed_round_boruvka_equals_synced():
    gen = torch.Generator().manual_seed(5)
    w = torch.rand(6, 37, 37, generator=gen)
    w = w + w.transpose(1, 2)
    tied = torch.randint(0, 4, (5, 29, 29), generator=gen).float()
    tied = tied + tied.transpose(1, 2)
    for batch in (w, tied):
        synced = t_chow_liu.boruvka_mst_batch(batch)
        for chunk in (None, 1, 4):
            fixed = t_chow_liu.boruvka_mst_batch(batch, chunk,
                                                 early_exit=False)
            assert torch.equal(fixed, synced)
        for i in range(batch.shape[0]):
            edges = t_chow_liu.kruskal_mst(batch[i])
            est = torch.zeros_like(synced[i])
            for j, k in edges:
                est[j, k] = est[k, j] = True
            assert torch.equal(est, synced[i])


def test_chunk_path_under_a_small_memory_budget():
    """A budget small enough to tile the Gram, back off the pow2 padding
    and slab the MWST stage: the knobs are repro's, and the metrics equal
    the unbudgeted sweep's."""
    strategies = (j_strategy.Strategy("sign"),
                  j_strategy.Strategy("persymbol", rate=2),
                  j_strategy.Strategy("original"))
    kw = dict(d=130, ns=(70,), reps=4)
    budget = 600_000
    jp, tp = _plans(strategies, memory_budget_bytes=budget, **kw)
    assert tp.metrics_chunk() == jp.metrics_chunk() is not None
    assert tp.bucket_for(70) == jp.bucket_for(70) == 72
    jeng = jp.budget_engine(je.GramEngine())
    teng = tp.budget_engine(te.GramEngine(), device="cpu")
    assert (teng.d_tile, teng.n_chunk) == (jeng.d_tile, jeng.n_chunk)
    assert teng.d_tile == 128
    got = te.run_trials(tp, device="cpu")
    assert got.tiling == {"memory_budget_bytes": budget, "d_tile": 128,
                          "n_chunk": teng.n_chunk,
                          "metrics_chunk": jp.metrics_chunk()}
    _, free = _plans(strategies, memory_budget_bytes=1 << 34,
                     n_buckets=(72,), **kw)
    whole = te.run_trials(free, device="cpu")
    assert whole.tiling["metrics_chunk"] is None
    for field in ("error_rate", "edit_distance", "edge_f1"):
        assert getattr(got, field) == getattr(whole, field), field


# --------------------------------------------------------------------------
# Validation, and the planes that are not ported yet
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(tree="tangle"), dict(tree="skeleton", d=21), dict(reps=0),
    dict(d=1), dict(n_buckets="pow3"), dict(n_buckets=()),
    dict(n_buckets=(64,)), dict(memory_budget_bytes=0),
])
def test_trial_plan_validation_is_repros(kw):
    base = dict(d=D, ns=NS, reps=REPS)
    base.update(kw)
    with pytest.raises(ValueError) as want:
        je.TrialPlan(**base)
    with pytest.raises(ValueError) as got:
        te.TrialPlan(**base)
    assert str(got.value) == str(want.value)


def test_unported_planes_raise():
    """No plane raises now: the sparse plane's doors (sparse sweeps, path
    plans, sparse learned adjacencies) run, and so does the mesh door —
    one-rank gloo meshes (a data mesh and a wire mesh) give the mesh-less
    sweep, tree and sparse, with the wire mesh's collectives on the
    reports."""
    from repro_torch.launch.mesh import make_trial_mesh

    sparse = Strategy("sign", structure="sparse", lam=0.1)
    plan = te.TrialPlan(d=8, ns=(64,), strategies=(sparse,), tree="sparse",
                        reps=2, glasso_steps=20)
    assert te.run_trials(plan, device="cpu").host_syncs == 1
    with pytest.raises(ValueError, match="sparse_ground_truth"):
        te.stacked_trees(plan, device="cpu")
    assert te.sparse_ground_truth(plan, device="cpu")[0].shape == (2, 8, 8)
    est = te.learned_adjacency(np.random.default_rng(0).standard_normal(
        (32, 4)).astype(np.float32), sparse, glasso_steps=10, device="cpu")
    assert est.shape == (4, 4) and est.dtype == torch.bool
    path = dataclasses.replace(plan, path=t_path.PathPlan(n_lams=2))
    assert te.run_trials(path, device="cpu").path["k"] == 2
    with pytest.raises(ValueError, match="sparse plane"):
        te.TrialPlan(d=D, ns=NS, path=t_path.PathPlan())
    with pytest.raises(ValueError, match="homogeneous"):
        te.TrialPlan(d=D, ns=NS, strategies=(sparse, Strategy()))
    fields = ("error_rate", "edit_distance", "edge_f1", "precision",
              "recall", "host_syncs", "buckets", "path")
    for p in (te.TrialPlan(d=D, ns=NS), plan, path):
        alone = te.run_trials(p, device="cpu")
        for model in (None, 1):
            mesh = make_trial_mesh(1, model=model, device="cpu")
            got = te.run_trials(p, mesh=mesh, device="cpu")
            for f in fields:
                assert getattr(got, f) == getattr(alone, f), f
            assert got.mesh_devices == 1
            for lab, reports in got.comm.items():
                for r, a in zip(reports, alone.comm[lab]):
                    assert r == dataclasses.replace(
                        a, collectives=0 if model is None else 1)


def test_run_trials_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = te.TrialPlan(d=D, ns=(40,), reps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.run_trials(plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.mc_sign_crossover(16, 0.5, 0.4, 4)
    assert te.run_trials(plan, device="cpu").host_syncs == 1


def test_default_memory_budget_is_repros(monkeypatch):
    from repro.core import gram as j_gram
    from repro_torch.core import gram as t_gram

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("REPRO_MEMORY_BUDGET_BYTES", raising=False)
    assert t_gram.default_memory_budget() == j_gram.default_memory_budget() \
        == 8 << 30
    monkeypatch.setenv("REPRO_MEMORY_BUDGET_BYTES", "12345")
    assert t_gram.default_memory_budget() == j_gram.default_memory_budget() \
        == 12345
    assert te.TrialPlan(d=D, ns=NS).effective_memory_budget == 12345


def test_setup_cache_serves_repeated_sweeps_and_clears():
    te.clear_compile_caches()
    plan = te.TrialPlan(d=D, ns=(40,), reps=2)
    te.run_trials(plan, device="cpu")
    size = te.compile_cache_size()
    assert size == 2  # the host trees and the device bundle
    te.run_trials(dataclasses.replace(plan, ns=(60, 80)), device="cpu")
    te.trial_keys(plan, device="cpu")
    assert te.compile_cache_size() == size
    assert te.clear_compile_caches() == size
    assert te.compile_cache_size() == 0
