"""The port's regularization-path engine (``repro_torch.core.path``)
against ``repro``'s, on the CPU.

Grids, StARS counts and selections on given inputs are bit-identical;
per-lam iterates follow the glasso tolerances of ``test_torch_glasso``
(theta within 1e-2, supports equal except at entries within
``glasso.THRESHOLD_BAND`` of the threshold); solver step counts are
within ``ITERS_RTOL`` of ``repro``'s on a single statistic batch, but a
sweep's mean counts only within their range (a lane stops on an f32
plateau the two solvers reach apart, which can move one trial's count
by tens). Within the port a polled solve, an early exit
and a chunked batch change no bit. The path trial plane is in
``test_torch_path_trials.py``, the planted-fault checks in
``test_torch_path_faults.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import glasso as jg
from repro.core import path as jpath
from repro.core import sampler as j_sampler
from repro_torch.core import glasso as tg
from repro_torch.core import path as tpath

THETA_TOL = 1e-2
ITERS_RTOL = 0.05


@pytest.fixture(scope="module")
def sparse_problem():
    """test_path.py's seeded recovery problem: (S, true adjacency, n)."""
    rng = np.random.default_rng(3)
    d = 10
    theta = jg.random_sparse_precision(d, density=0.25, rng=rng)
    n = 6000
    x = j_sampler.sample_ggm(jax.random.key(3), n, np.linalg.inv(theta))
    S = np.corrcoef(np.asarray(x), rowvar=False).astype(np.float32)
    true_adj = np.abs(theta) > 1e-8
    np.fill_diagonal(true_adj, False)
    return S, true_adj, n


def _batch(S):
    rng = np.random.default_rng(0)
    d = S.shape[0]
    return np.stack([S, S * 0.95 + 0.05 * np.eye(d, dtype=np.float32),
                     np.corrcoef(rng.normal(size=(500, d)),
                                 rowvar=False).astype(np.float32)])


@pytest.mark.parametrize("kw", [
    dict(lams=(0.5,)), dict(lams=(0.1, 0.5)), dict(lams=(0.5, -0.1)),
    dict(lams=(0.5, 0.5)), dict(n_lams=1), dict(lam_min_ratio=1.5),
    dict(lam_min_ratio=0.0), dict(select="aic"), dict(ebic_gamma=-1.0),
    dict(stars_beta=0.0), dict(stars_beta=1.0), dict(conv_tol=-1e-3),
])
def test_path_plan_validation_is_repros(kw):
    with pytest.raises(ValueError) as want:
        jpath.PathPlan(**kw)
    with pytest.raises(ValueError) as got:
        tpath.PathPlan(**kw)
    assert str(got.value) == str(want.value)


def test_path_plan_fields_are_repros():
    for kw in (dict(), dict(lams=[0.5, 0.1, 0.02]), dict(n_lams=7),
               dict(select="stars", stars_beta=0.2, conv_tol=0.0)):
        j, t = jpath.PathPlan(**kw), tpath.PathPlan(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.k == j.k
    assert hash(tpath.PathPlan()) == hash(tpath.PathPlan())


def test_path_lambdas_are_repros(sparse_problem):
    S = _batch(sparse_problem[0])
    for plan in ({"n_lams": 5, "lam_min_ratio": 0.1},
                 {"n_lams": 8, "lam_min_ratio": 0.05},
                 {"lams": (0.3, 0.1, 0.01)}):
        want = np.asarray(jpath.path_lambdas(jpath.PathPlan(**plan),
                                             jnp.asarray(S)))
        got = tpath.path_lambdas(tpath.PathPlan(**plan), torch.from_numpy(S))
        np.testing.assert_array_equal(got.numpy(), want)
    # an all-zero pad statistic still gives a positive decreasing grid
    z = tpath.path_lambdas(tpath.PathPlan(n_lams=5),
                           torch.zeros(2, 2)).numpy()
    np.testing.assert_array_equal(
        z, np.asarray(jpath.path_lambdas(jpath.PathPlan(n_lams=5),
                                         jnp.zeros((2, 2)))))
    assert (z > 0).all() and (np.diff(z) < 0).all()


@pytest.mark.parametrize("conv_tol", [0.0, 3e-4])
def test_path_batch_matches_repro(sparse_problem, conv_tol):
    S = _batch(sparse_problem[0])
    lams = np.array(jpath.path_lambdas(
        jpath.PathPlan(n_lams=6, lam_min_ratio=0.05), jnp.asarray(S)))
    steps = 300 if conv_tol else 120
    want = jpath.glasso_path_batch(jnp.asarray(S), lams, n_steps=steps,
                                   conv_tol=conv_tol, keep_thetas=True)
    got = tpath.glasso_path_batch(torch.from_numpy(S), torch.from_numpy(lams),
                                  n_steps=steps, conv_tol=conv_tol,
                                  keep_thetas=True)
    np.testing.assert_array_equal(got.lams.numpy(), np.asarray(want.lams))
    np.testing.assert_allclose(got.thetas.numpy(), np.asarray(want.thetas),
                               rtol=0, atol=THETA_TOL)
    thetas = np.asarray(want.thetas)
    for k in range(6):
        assert tg.far_mismatches(got.support[k], thetas[k]) == 0, k
    # sums of d (logdet) and d^2 (trace) entries of iterates within 1e-2
    np.testing.assert_allclose(got.logdet.numpy(), np.asarray(want.logdet),
                               rtol=0, atol=THETA_TOL)
    np.testing.assert_allclose(got.tr_s_theta.numpy(),
                               np.asarray(want.tr_s_theta), rtol=0,
                               atol=THETA_TOL)
    np.testing.assert_allclose(got.iters.numpy(), np.asarray(want.iters),
                               rtol=ITERS_RTOL, atol=1)
    if not conv_tol:
        assert (got.iters == steps).all()
    assert got.edges.dtype == torch.int32 and got.iters.dtype == torch.int32


def test_ebic_scores_and_selection_on_given_inputs():
    rng = np.random.default_rng(2)
    logdet = rng.normal(3.0, 1.0, (6, 5)).astype(np.float32)
    tr = rng.normal(9.0, 1.0, (6, 5)).astype(np.float32)
    edges = rng.integers(0, 30, (6, 5)).astype(np.int32)
    want = np.asarray(jpath.ebic_scores(logdet, tr, edges, 500, 12, 0.5))
    got = tpath.ebic_scores(torch.from_numpy(logdet), torch.from_numpy(tr),
                            torch.from_numpy(edges), 500, 12, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    tied = np.array([[3.0, 1.0], [1.0, 2.0], [1.0, 1.0]], np.float32)
    for scores in (want, tied):
        np.testing.assert_array_equal(
            tpath.select_ebic(torch.from_numpy(np.array(scores))).numpy(),
            np.asarray(jpath.select_ebic(jnp.asarray(scores))))


def _random_supports(seed, K, B, d, rates):
    rng = np.random.default_rng(seed)
    sup = rng.random((K, B, d, d)) < np.asarray(rates)[:, None, None, None]
    sup = sup | sup.transpose(0, 1, 3, 2)
    idx = np.arange(d)
    sup[:, :, idx, idx] = False
    return sup


@pytest.mark.parametrize("seed,K,B,d", [(7, 5, 12, 8), (1, 4, 16, 6),
                                        (3, 6, 32, 16)])
def test_stars_is_repros_bit_for_bit(seed, K, B, d):
    sup = _random_supports(seed, K, B, d, np.linspace(0.05, 0.6, K))
    want = np.asarray(jpath.stars_instability(jnp.asarray(sup)))
    got = tpath.stars_instability(torch.from_numpy(sup)).numpy()
    np.testing.assert_array_equal(got, want)
    perm = np.random.default_rng(seed).permutation(B)
    np.testing.assert_array_equal(
        tpath.stars_instability(torch.from_numpy(sup[:, perm])).numpy(), got)
    for beta in (0.05, 0.2, 0.5, 0.9):
        np.testing.assert_array_equal(
            tpath.select_stars(torch.from_numpy(got), beta).numpy(),
            np.asarray(jpath.select_stars(jnp.asarray(want), beta)))


def test_polled_path_equals_the_unpolled(sparse_problem, monkeypatch):
    S = torch.from_numpy(_batch(sparse_problem[0]))
    lams = tpath.path_lambdas(tpath.PathPlan(n_lams=5), S)
    polled = tpath.glasso_path_batch(S, lams, n_steps=120, keep_thetas=True)
    assert (polled.iters < 120).any()
    monkeypatch.setattr(tg, "POLL_EVERY", 10 ** 6)
    full = tpath.glasso_path_batch(S, lams, n_steps=120, keep_thetas=True)
    for a, b in zip(polled, full):
        assert torch.equal(a, b)


def test_early_exit_never_changes_converged_iterates(sparse_problem):
    S = torch.from_numpy(sparse_problem[0])
    lams = tpath.path_lambdas(tpath.PathPlan(n_lams=5, lam_min_ratio=0.08),
                              S)
    a = tpath.glasso_path_batch(S, lams, n_steps=200, conv_tol=1e-5,
                                keep_thetas=True)
    b = tpath.glasso_path_batch(S, lams, n_steps=800, conv_tol=1e-5,
                                keep_thetas=True)
    conv = a.iters[:, 0] < 200
    assert conv.any()
    for i in torch.nonzero(conv).flatten().tolist():
        assert torch.equal(a.thetas[i], b.thetas[i]), i
        assert a.iters[i, 0] == b.iters[i, 0]
        # later lams warm-start from a converged iterate: equal up to the
        # first lam that ran out of budget
        if not conv[:i + 1].all():
            break


def test_path_batch_chunk_parity(sparse_problem):
    """The twin of test_path.py's chunk parity: bit for bit."""
    S = torch.from_numpy(_batch(sparse_problem[0]))
    lams = tpath.path_lambdas(tpath.PathPlan(n_lams=4), S)
    mono = tpath.glasso_path_batch(S, lams, n_steps=120, keep_thetas=True)
    for chunk in (1, 2):
        chk = tpath.glasso_path_batch(S, lams, n_steps=120, chunk=chunk,
                                      keep_thetas=True)
        for a, b in zip(mono, chk):
            assert torch.equal(a, b)


@pytest.mark.parametrize("select", ["ebic", "stars"])
def test_path_select_matches_repro(sparse_problem, select):
    S, true_adj, n = sparse_problem
    kw = dict(n_lams=6, lam_min_ratio=0.05, select=select, stars_beta=0.2)
    batch = _batch(S)
    want_theta, want_idx, _ = jpath.glasso_path_select(
        jnp.asarray(batch), jpath.PathPlan(**kw), n, n_steps=300)
    got_theta, got_idx, solve = tpath.glasso_path_select(
        torch.from_numpy(batch), tpath.PathPlan(**kw), n, n_steps=300)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_theta.numpy(), np.asarray(want_theta),
                               rtol=0, atol=THETA_TOL)
    one, idx, _ = tpath.glasso_path_select(torch.from_numpy(S),
                                           tpath.PathPlan(**kw), n,
                                           n_steps=300)
    assert one.shape == S.shape and idx.shape == ()
    est = tg.support(one)
    f1 = 2 * (est & true_adj).sum() / max(est.sum() + true_adj.sum(), 1)
    assert f1 > 0.8
