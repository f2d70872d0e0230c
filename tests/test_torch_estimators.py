"""The public functions of the ported modules that the mesh references
call, against ``repro`` on shared numpy inputs: the closed-form
estimators of ``core.estimators``, ``trees.tree_correlation_matrix``,
``sampler.sample_tree_ggm_batch``, the default Gram engine and the
package exports.

Tolerances: sign weights at the sign tolerance (``ROADMAP.md`` §3); the
f32-valued weights (per-symbol, Gaussian: their Grams sum in another
order than XLA's) at ``rtol=1e-5, atol=1e-6`` off the diagonal. Their
diagonal, which the MWST never reads, is -1/2 log(1 - rho_jj^2) with
rho_jj^2 within ~1e-5 of 1 for R >= 3, where an ulp of the Gram moves the
weight by percents, so it is only held finite (``repro``'s own weight
tests mask it too); the arcsine/sine maps at ``rtol=1e-6, atol=1e-7``
(an ulp of each transcendental); samples within ``rtol=1e-5, atol=1e-6``
(normals within 2^-21 of ``jax.random.normal``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
from repro.core import estimators as je
from repro.core import quantizers as jq
from repro.core import sampler as js
from repro.core import trees as jt
import repro_torch.core as tcore
from repro_torch.core import estimators as te
from repro_torch.core import gram as tg
from repro_torch.core import quantizers as tq
from repro_torch.core import sampler as ts
from repro_torch.core import trees as tt

SIGN_TOL = dict(rtol=1e-6, atol=2.5e-7)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
MAP_TOL = dict(rtol=1e-6, atol=1e-7)
SAMPLE_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINE = tg.GramEngine(device="cpu")


@pytest.fixture(scope="module")
def samples():
    """test_distributed.py:25's tree samples (d = 16, n = 4096)."""
    rng = np.random.default_rng(0)
    d, n = 16, 4096
    edges = jt.random_tree(d, rng)
    w = rng.uniform(0.4, 0.9, d - 1)
    return np.asarray(js.sample_tree_ggm(jax.random.key(0), n, d, edges, w))


def _f32_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.eye(got.shape[-1], dtype=bool)
    np.testing.assert_allclose(got[off], want[off], **F32_TOL)
    assert np.isfinite(np.diag(got)).all()


def test_theta_rho_maps_are_repros():
    rho = np.linspace(-1.2, 1.2, 97).astype(np.float32)
    theta = np.array(je.theta_from_rho(rho))
    np.testing.assert_allclose(te.theta_from_rho(torch.from_numpy(rho)),
                               theta, **MAP_TOL)
    np.testing.assert_allclose(te.rho_from_theta(torch.from_numpy(theta)),
                               np.asarray(je.rho_from_theta(theta)),
                               **MAP_TOL)


@pytest.mark.parametrize("kind", ["signs", "values"])
def test_sample_correlation_is_repros(samples, kind):
    x = samples if kind == "values" else np.asarray(jq.sign_quantize(samples))
    want = np.asarray(je.sample_correlation(jnp.asarray(x)))
    got = te.sample_correlation(torch.from_numpy(x.copy()), engine=ENGINE)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_sign_method_weights_are_repros(samples):
    want = np.asarray(je.sign_method_weights(jq.sign_quantize(samples)))
    u = tq.sign_quantize(torch.from_numpy(samples.copy()))
    np.testing.assert_allclose(te.sign_method_weights(u, engine=ENGINE),
                               want, **SIGN_TOL)
    n = samples.shape[0]
    packed = tq.pack_codes(tq.sign_bits(torch.from_numpy(samples.copy()))
                           .transpose(0, 1), 1)
    got = te.sign_method_weights_packed(packed, n, engine=ENGINE)
    np.testing.assert_allclose(got, want, **SIGN_TOL)
    np.testing.assert_array_equal(
        got, te.sign_method_weights(u, engine=ENGINE))


@pytest.mark.parametrize("rate", [1, 3, 4])
def test_persymbol_weights_are_repros(samples, rate):
    q = jq.PerSymbolQuantizer(rate)
    want = np.asarray(je.persymbol_method_weights(q.quantize(samples)))
    x = torch.from_numpy(samples.copy())
    tq_ = tq.PerSymbolQuantizer(rate)
    _f32_close(te.persymbol_method_weights(tq_.quantize(x), engine=ENGINE),
               want)
    codes = tq_.encode(x)
    _f32_close(te.persymbol_code_weights(codes, tq_.centroids_np,
                                         engine=ENGINE),
               np.asarray(je.persymbol_code_weights(
                   q.encode(samples).astype(jnp.int8), q.centroids)))


def test_gaussian_weights_are_repros(samples):
    _f32_close(te.gaussian_weights(torch.from_numpy(samples.copy()),
                                   engine=ENGINE),
               np.asarray(je.gaussian_weights(samples)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_correlation_matrix_is_repros(seed):
    rng = np.random.default_rng(seed)
    d = 9 + 4 * seed
    edges = jt.random_tree(d, rng)
    w = rng.uniform(-0.9, 0.9, d - 1)
    np.testing.assert_array_equal(tt.tree_correlation_matrix(d, edges, w),
                                  jt.tree_correlation_matrix(d, edges, w))
    with pytest.raises(ValueError):
        tt.tree_correlation_matrix(d, edges[1:], w[1:])


def test_sample_tree_ggm_batch_is_repros():
    t, d, n = 4, 12, 100
    parents = np.zeros((t, d), np.int32)
    rhos = np.zeros((t, d), np.float32)
    for r in range(t):
        rng = np.random.default_rng(r)
        p, rh, _ = jt.topological_parents(
            d, jt.random_tree(d, rng), rng.uniform(0.4, 0.9, d - 1))
        parents[r], rhos[r] = p, rh
    keys = jax.random.split(jax.random.key(3), t)
    want = np.asarray(js.sample_tree_ggm_batch(
        keys, n, jnp.asarray(parents), jnp.asarray(rhos)))
    tkeys = torch.from_numpy(
        np.asarray(jax.random.key_data(keys)).astype(np.int64))
    got = ts.sample_tree_ggm_batch(tkeys, n, torch.from_numpy(parents),
                                   torch.from_numpy(rhos))
    assert got.shape == (t, n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)


def test_default_engine_swaps_as_repros():
    prev = tg.default_engine()
    assert tg.resolve_engine(None) is prev
    mine = tg.GramEngine(device="cpu", backend="torch")
    try:
        assert tg.set_default_engine(mine) is prev
        assert tg.default_engine() is mine and tg.resolve_engine(None) is mine
    finally:
        assert tg.set_default_engine(prev) is mine
    assert tg.default_engine() is prev


def test_core_exports_are_repros():
    """Every name ``repro.core`` exports that the port has ported is
    exported by ``repro_torch.core`` too, the wire plane's and 11c's
    among them."""
    for name in ("WirePlan", "CommReport", "default_engine",
                 "set_default_engine", "default_memory_budget", "GATHER",
                 "tree_correlation_matrix", "tree_edit_distance",
                 "SKELETON_EDGES", "chain_tree", "random_tree", "star_tree",
                 "mwst", "run_trials", "TrialPlan"):
        assert hasattr(jcore, name) and hasattr(tcore, name), name
    assert tcore.default_memory_budget is tg.default_memory_budget
    assert tcore.GATHER == tcore.GatherChannel()
    assert tcore.distributed_learn_structure.__module__ == \
        "repro_torch.core.distributed"
