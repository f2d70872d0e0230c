"""The port's glasso solver (``repro_torch.core.glasso``) and the sparse
plane's estimators against ``repro``'s, on the CPU.

Both solvers are f32. Their first steps agree to ``STEP_TOL`` (the sums
run in another order); after that the monotone guard's accept/reject
choices settle each on its own point of an f32 plateau, so a full solve
is held to ``THETA_TOL`` and its partial correlations to ``PC_TOL``
(ROADMAP §3: 3.3e-3 and 1.3e-3 measured; an f32 solve against an f64
one differs by 7.3e-3). Supports must be equal except at entries whose
reference partial correlation lies within ``THRESHOLD_BAND`` of the
threshold. Integer pieces (ground truths) are bit-identical, and within
the port early exits, pad lanes and chunks change no bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import estimators as j_est
from repro.core import glasso as jg
from repro.core import strategy as j_strategy
from repro.core.path import PathPlan as JPathPlan
from repro_torch.core import estimators as t_est
from repro_torch.core import glasso as tg
from repro_torch.core.path import PathPlan
from repro_torch.interop import strategy_from_fields

STEP_TOL = 1e-5
THETA_TOL = 1e-2
PC_TOL = 5e-3
THRESHOLD_BAND = tg.THRESHOLD_BAND


def _problems(d, n, count, seed=0, density=0.2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        th = jg.random_sparse_precision(d, density, rng)
        x = rng.multivariate_normal(np.zeros(d), np.linalg.inv(th), size=n)
        out.append(np.corrcoef(x, rowvar=False).astype(np.float32))
    return np.stack(out)


def _sign_statistics(d, n, count, seed=1):
    """Arcsine-inverted sign correlations: indefinite at small n, so
    the solve starts from the repaired statistic."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        th = jg.random_sparse_precision(d, 0.3, rng)
        x = rng.multivariate_normal(np.zeros(d), np.linalg.inv(th), size=n)
        s = np.sign(x)
        out.append(np.sin(np.pi * (s.T @ s) / (2 * n)).astype(np.float32))
    return np.array(jg.nearest_correlation(jnp.asarray(np.stack(out))))


def _assert_supports_agree(est, theta_ref, tol=jg.SUPPORT_TOL):
    assert tg.far_mismatches(est, np.asarray(theta_ref), tol) == 0


def test_carry_init_is_repros():
    S = _problems(10, 300, 6)
    St = tg._symmetrize(torch.from_numpy(S))
    got = tg._carry_init(St, torch.full((6,), 0.06), 0.9, 1e-4)
    for i in range(6):
        want = jg._carry_init(jnp.asarray(St[i].numpy()), jnp.float32(0.06),
                              0.9, 1e-4)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=STEP_TOL)
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)
        # eta0 from the eigenvalues in hand, repro's from an SVD
        np.testing.assert_allclose(float(got[3][i]), float(want[3]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(got[4][i]), float(want[4]),
                                   rtol=1e-6)


@pytest.mark.parametrize("n_steps", [1, 5, 20])
@pytest.mark.parametrize("kind", ["sample", "sign"])
def test_first_steps_match_repro(n_steps, kind):
    """Before the f32 plateau hides it, a wrong formula shows: theta
    within 1e-5 of repro's after up to 20 steps (3.7e-6 measured)."""
    S = _problems(10, 300, 16) if kind == "sample" else _sign_statistics(
        12, 200, 8)
    want = np.asarray(jg.glasso_batch(jnp.asarray(S), 0.06, n_steps=n_steps))
    got = tg.glasso_batch(torch.from_numpy(S), 0.06, n_steps=n_steps,
                          device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STEP_TOL)


@pytest.mark.parametrize("d,n,steps,conv_tol", [
    (10, 300, 300, 0.0), (16, 1000, 500, 0.0), (10, 300, 300, 3e-4),
    (12, 200, 300, 0.0)])
def test_full_solves_match_repro(d, n, steps, conv_tol):
    S = (_sign_statistics(d, n, 8) if d == 12
         else _problems(d, n, 16, seed=d))
    lam = np.linspace(0.04, 0.1, S.shape[0]).astype(np.float32)
    want = np.asarray(jg.glasso_batch(jnp.asarray(S), jnp.asarray(lam),
                                      n_steps=steps, conv_tol=conv_tol))
    got = tg.glasso_batch(torch.from_numpy(S), torch.from_numpy(lam),
                          n_steps=steps, conv_tol=conv_tol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=THETA_TOL)
    np.testing.assert_allclose(
        tg.partial_correlations(got).numpy(),
        np.asarray(jg.partial_correlations(jnp.asarray(want))),
        rtol=0, atol=PC_TOL)
    _assert_supports_agree(tg.support_from_theta(got), want)
    np.testing.assert_allclose(
        tg.glasso_objective(got, torch.from_numpy(S), 0.06).numpy(),
        np.asarray(jg.glasso_objective(jnp.asarray(want), jnp.asarray(S),
                                       0.06)), rtol=1e-3)


def test_far_mismatches_counts_only_entries_off_the_threshold():
    theta = np.eye(3, dtype=np.float32)
    theta[0, 1] = theta[1, 0] = 0.052   # partial correlation 0.052
    theta[0, 2] = theta[2, 0] = 0.2
    est = tg.support(theta)
    assert tg.far_mismatches(est, theta) == 0
    near = est.copy()
    near[0, 1] = near[1, 0] = False     # 0.002 from the threshold
    assert tg.far_mismatches(near, theta) == 0
    far = est.copy()
    far[0, 2] = far[2, 0] = False
    assert tg.far_mismatches(far, theta) == 2


def test_early_exit_equals_a_larger_budget():
    S = tg._symmetrize(torch.from_numpy(_problems(10, 2000, 6, seed=4)))
    lam = torch.full((6,), 0.05)
    init = tg._carry_init(S, lam, 0.9, 1e-4)
    a, _, _, iters = tg._glasso_run(*init, S, lam, 150, 1e-4, 1e-5)
    b, _, _, iters_b = tg._glasso_run(*init, S, lam, 600, 1e-4, 1e-5)
    conv = iters < 150
    assert conv.any(), "no lane converged within the small budget"
    assert torch.equal(a[conv], b[conv])
    assert torch.equal(iters[conv], iters_b[conv])


def test_pad_lanes_spend_no_iterations():
    S = tg._symmetrize(torch.from_numpy(_problems(8, 500, 3)))
    lam = torch.full((3,), 0.08)
    init = tg._carry_init(S, lam, 0.9, 1e-4)
    active = torch.tensor([True, False, True])
    theta, _, _, iters = tg._glasso_run(*init, S, lam, 40, 1e-4, 0.0, active)
    assert iters.tolist() == [40, 0, 40]
    assert torch.equal(theta[1], init[0][1])
    whole, _, _, _ = tg._glasso_run(*init, S, lam, 40, 1e-4)
    assert torch.equal(theta[active], whole[active])
    # repro's twin of the mask
    _, _, _, it = jg._glasso_run(*(jnp.asarray(a[1].numpy()) for a in
                                   init[:5]), jnp.asarray(S[1].numpy()),
                                 jnp.float32(0.08), 40, 1e-4, 0.0,
                                 jnp.asarray(False))
    assert int(it) == 0


@pytest.mark.parametrize("conv_tol", [0.0, 3e-4])
def test_glasso_batch_chunk_parity(conv_tol):
    """The twin of test_tiling's glasso chunk parity: slabs padded with
    inactive lanes equal the whole batch bit for bit."""
    S = torch.from_numpy(_problems(9, 400, 5, seed=2))
    lam = torch.tensor([0.04, 0.05, 0.06, 0.07, 0.08])
    whole = tg.glasso_batch(S, lam, n_steps=40, conv_tol=conv_tol)
    for chunk in (1, 2, 4):
        got = tg.glasso_batch(S, lam, n_steps=40, conv_tol=conv_tol,
                              chunk=chunk)
        assert torch.equal(got, whole), chunk


def test_polled_solve_equals_the_unpolled(monkeypatch):
    S = torch.from_numpy(_problems(10, 1500, 4, seed=5))
    polled = tg.glasso_batch(S, 0.05, n_steps=200, conv_tol=3e-4)
    St, lam = tg._symmetrize(S), torch.full((4,), 0.05)
    init = tg._carry_init(St, lam, 0.9, 1e-4)
    iters = tg._glasso_run(*init, St, lam, 200, 1e-4, 3e-4)[3]
    assert int(iters.max()) < 200 - tg.POLL_EVERY  # the polled loop broke
    monkeypatch.setattr(tg, "POLL_EVERY", 10 ** 6)
    assert torch.equal(tg.glasso_batch(S, 0.05, n_steps=200, conv_tol=3e-4),
                       polled)


def test_host_doors_agree():
    S = torch.from_numpy(_problems(7, 300, 2))
    one = tg.glasso(S[0], 0.07, n_steps=50)
    assert torch.equal(one, tg.glasso_batch(S[:1], 0.07, n_steps=50)[0])
    assert tg.support(one).dtype == bool
    assert np.array_equal(tg.support(one),
                          tg.support_from_theta(one).numpy())


def test_random_sparse_precision_is_repros():
    for seed in range(4):
        want = jg.random_sparse_precision(
            12, 0.25, np.random.default_rng(seed), strength=(0.3, 0.5))
        got = tg.random_sparse_precision(
            12, 0.25, np.random.default_rng(seed), strength=(0.3, 0.5))
        np.testing.assert_array_equal(got, want)


def test_nearest_correlation_moved_and_is_repros():
    S = _sign_statistics(12, 60, 4, seed=3)
    raw = S + np.float32(0.3) * np.eye(12, dtype=np.float32)[None]
    raw[:, 0, 1] = raw[:, 1, 0] = 0.99
    got = tg.nearest_correlation(torch.from_numpy(raw)).numpy()
    want = np.asarray(jg.nearest_correlation(jnp.asarray(raw)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert t_est.nearest_correlation is tg.nearest_correlation


SPARSE = (j_strategy.Strategy("sign", structure="sparse", lam=0.08),
          j_strategy.Strategy("sign", wire="packed", structure="sparse",
                              lam=0.08),
          j_strategy.Strategy("persymbol", rate=2, structure="sparse",
                              lam=0.06),
          j_strategy.Strategy("persymbol", rate=4, wire="packed",
                              structure="sparse", lam=0.06),
          j_strategy.Strategy("original", structure="sparse", lam=0.06))


@pytest.mark.parametrize("s", SPARSE, ids=lambda s: f"{s.label}-{s.wire}")
def test_strategy_corr_matches_repro(s):
    """The corr stage on shared samples: sign statistics go through
    sin and the eigen-clip (an eigh each side), so all are held to 1e-5;
    masked and fault-masked batches as in the trial plane."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 128, 16)).astype(np.float32)
    x[..., 1] += 0.6 * x[..., 0]
    ts = strategy_from_fields(dataclasses.asdict(s))
    want = np.asarray(j_est.strategy_corr(jnp.asarray(x[0]), s))
    got = t_est.strategy_corr(torch.from_numpy(x[0]), ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want = np.asarray(j_est.strategy_corr_batch(jnp.asarray(x), s,
                                                n_valid=100))
    got = t_est.strategy_corr_batch(torch.from_numpy(x), ts, n_valid=100)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    n_rows = np.array([[100, 60, 100, 1] + [100] * 12] * 3, np.int32)
    flip = rng.random((3, 128, 16)) < 0.02
    want = np.asarray(j_est.strategy_corr_batch(
        jnp.asarray(x), s, n_valid=100, n_rows=jnp.asarray(n_rows),
        flip=jnp.asarray(flip)))
    got = t_est.strategy_corr_batch(
        torch.from_numpy(x), ts, n_valid=100,
        n_rows=torch.from_numpy(n_rows), flip=torch.from_numpy(flip))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_strategy_corr_batch_rejects_channel_operands():
    """The channel operands reach the sparse corr stage: a gather
    strategy ignores them, a budget strategy needs ``rates`` and takes
    them as repro does."""
    from repro.comm.channel import BudgetChannel

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, 8)).astype(np.float32)
    ts = strategy_from_fields(dataclasses.asdict(SPARSE[0]))
    xt = torch.from_numpy(x)
    assert torch.equal(
        t_est.strategy_corr_batch(xt, ts, n_valid=60,
                                  rates=torch.ones(8, dtype=torch.int32)),
        t_est.strategy_corr_batch(xt, ts, n_valid=60))
    s = j_strategy.Strategy("persymbol", rate=3, structure="sparse",
                            lam=0.1, channel=BudgetChannel(
                                budget_bits=3 * 60 * 8 // 2, machines=4))
    tb = strategy_from_fields(dataclasses.asdict(s))
    with pytest.raises(ValueError, match="rates"):
        t_est.strategy_corr_batch(xt, tb, n_valid=60)
    rates = s.channel.column_rates(60, 8, 3)
    want = np.asarray(j_est.strategy_corr_batch(jnp.asarray(x), s,
                                                n_valid=60, rates=rates))
    got = t_est.strategy_corr_batch(xt, tb, n_valid=60,
                                    rates=torch.from_numpy(rates))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _ggm_data(d, n, seed, density=0.2):
    from repro.core import sampler
    rng = np.random.default_rng(seed)
    theta = jg.random_sparse_precision(d, density, rng)
    x = np.asarray(sampler.sample_ggm(jax.random.key(seed), n,
                                      np.linalg.inv(theta)))
    return x, theta


@pytest.mark.parametrize("method", ["original", "sign", "persymbol"])
@pytest.mark.parametrize("lam", [0.05, "path"])
def test_learn_sparse_structure_matches_repro(method, lam):
    x, _ = _ggm_data(12, 4000, 5)
    jlam = lam if isinstance(lam, float) else "path"
    want = jg.learn_sparse_structure(jnp.asarray(x), jlam, method=method,
                                     n_steps=300)
    got = tg.learn_sparse_structure(x, lam, method=method, n_steps=300,
                                    device="cpu")
    assert got.dtype == bool and got.shape == (12, 12)
    if not np.array_equal(got, want):
        # repro's selected theta, to place each difference
        from repro.core import estimators, path
        strat = j_strategy.Strategy(method, rate=4)
        S = estimators.corr_from_gram(estimators.payload_gram(
            estimators.strategy_payload(jnp.asarray(x), strat), strat),
            x.shape[0], strat)
        theta = (jg.glasso(S, lam, n_steps=300) if isinstance(lam, float)
                 else path.glasso_path_select(S, JPathPlan(), x.shape[0],
                                              n_steps=300)[0])
        _assert_supports_agree(got, theta)


def test_learn_sparse_structure_plan_and_validation_are_repros():
    x, theta = _ggm_data(12, 30_000, 5)
    true = np.abs(theta) > 1e-8
    np.fill_diagonal(true, False)
    est = tg.learn_sparse_structure(
        x, PathPlan(n_lams=6, lam_min_ratio=0.05), tol=5e-3, device="cpu")
    f1 = 2 * (est & true).sum() / max(est.sum() + true.sum(), 1)
    assert f1 > 0.8, f1
    for bad, jbad in [("grid", "grid"),
                      (PathPlan(select="stars"), JPathPlan(select="stars")),
                      (-0.1, -0.1)]:
        with pytest.raises(ValueError) as want:
            jg.learn_sparse_structure(jnp.asarray(x[:64]), jbad)
        with pytest.raises(ValueError) as got:
            tg.learn_sparse_structure(x[:64], bad, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown method"):
        tg.learn_sparse_structure(x[:64], 0.1, method="magic", device="cpu")


def test_tree_sum_is_the_same_in_any_batch():
    """The card's per-lane sums (``glasso._tree_sum``): a fixed tree of
    adds, so a lane sums to the same bits whatever its batch holds, and
    to the plain sum within f32 rounding."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((24, 100, 100)).astype(np.float32))
    full = tg._tree_sum(x, 2)
    assert full.shape == (24,)
    assert torch.equal(full[16:], tg._tree_sum(x[16:], 2))
    assert torch.equal(full[5:6], tg._tree_sum(x[5:6], 2))
    np.testing.assert_allclose(full.numpy(), x.double().sum(dim=(-2, -1)),
                               rtol=1e-5, atol=1e-3)
    w = x[:, 0, :7]                       # a length off a power of two
    assert torch.equal(tg._tree_sum(w, 1)[3:4],
                       tg._tree_sum(w[3:4], 1))
    np.testing.assert_allclose(tg._tree_sum(w, 1).numpy(),
                               w.double().sum(-1), rtol=1e-5, atol=1e-5)
