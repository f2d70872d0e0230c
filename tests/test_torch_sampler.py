"""The port's tree machinery and samplers against ``repro``.

The mixer and the eq.-24 correlation match ``repro``'s; the samplers are
held to the law (empirical correlations against the exact correlation
matrix), not to ``jax.random``'s bits.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sampler as j_sampler
from repro.core import trees as j_trees
from repro.data.ggm import GGMDataset as JDataset
from repro_torch.core import sampler as t_sampler
from repro_torch.core import trees as t_trees
from repro_torch.data import GGMDataset


def _tree(d, seed):
    rng = np.random.default_rng(seed)
    edges = j_trees.random_tree(d, rng)
    return edges, rng.uniform(0.4, 0.9, size=d - 1)


@pytest.mark.parametrize("d,seed", [(2, 0), (9, 1), (33, 2)])
def test_mixer_and_correlation(d, seed):
    edges, w = _tree(d, seed)
    parent, rho, perm = j_trees.topological_parents(d, edges, w)
    p2, r2, perm2 = t_trees.topological_parents(d, edges, w)
    for a, b in ((parent, p2), (rho, r2), (perm, perm2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        t_trees.path_product_mixer(torch.from_numpy(p2),
                                   torch.from_numpy(r2)).numpy(),
        np.asarray(j_trees.path_product_mixer(jnp.asarray(parent),
                                              jnp.asarray(rho))),
        rtol=1e-6, atol=1e-7)
    q = t_trees.tree_correlation(torch.from_numpy(p2), torch.from_numpy(r2))
    np.testing.assert_allclose(
        q.numpy(), np.asarray(j_trees.tree_correlation(jnp.asarray(parent),
                                                       jnp.asarray(rho))),
        rtol=1e-6, atol=1e-7)
    host = j_trees.tree_correlation_matrix(d, edges, w)
    np.testing.assert_allclose(q.numpy(), host[np.ix_(perm, perm)],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        t_trees.adjacency_from_parents(torch.from_numpy(p2)).numpy(),
        np.asarray(j_trees.adjacency_from_parents(jnp.asarray(parent))))


@pytest.mark.parametrize("kind", ["random", "star", "chain", "skeleton"])
def test_dataset_structure_is_repro_s(kind):
    d = 20
    a = GGMDataset(d=d, tree=kind, seed=4).structure()
    b = JDataset(d=d, tree=kind, seed=4).structure()
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_samplers_follow_the_law():
    d, n = 12, 4096
    edges, w = _tree(d, 5)
    truth = j_trees.tree_correlation_matrix(d, edges, w)
    gen = torch.Generator().manual_seed(0)
    x = t_sampler.sample_tree_ggm(gen, n, d, edges, w)
    assert x.shape == (n, d) and x.dtype == torch.float32
    # 4 standard errors of a correlation estimate at n samples
    tol = 4.0 / np.sqrt(n)
    np.testing.assert_allclose(np.corrcoef(x.numpy().T), truth, atol=tol)
    np.testing.assert_allclose(x.numpy().var(axis=0), 1.0, atol=tol * 2)
    y = t_sampler.sample_ggm(gen, n, truth)
    np.testing.assert_allclose(np.corrcoef(y.numpy().T), truth, atol=tol)
    parent, rho, perm = t_trees.topological_parents(d, edges, w)
    z = t_sampler.sample_tree_ggm_parents(gen, n, parent, rho)
    np.testing.assert_allclose(np.corrcoef(z.numpy().T),
                               truth[np.ix_(perm, perm)], atol=tol)


def test_dataset_sample_is_reproducible_and_blocked(monkeypatch):
    ds = GGMDataset(d=10, seed=2)
    a = ds.sample(300, device="cpu")
    np.testing.assert_array_equal(a.numpy(), ds.sample(300, device="cpu").numpy())
    assert not np.array_equal(a.numpy(),
                              ds.sample(300, 1, device="cpu").numpy())
    # drawing in row blocks changes nothing but the block size
    monkeypatch.setattr(t_sampler, "_ROW_BLOCK", 7)
    gen = torch.Generator().manual_seed(9)
    blocked = ds.sample(300, generator=gen)
    assert blocked.shape == (300, 10) and torch.isfinite(blocked).all()


def test_bfs_order_matches():
    edges, _ = _tree(15, 6)
    for a, b in zip(t_sampler.bfs_order(15, edges, root=3),
                    j_sampler.bfs_order(15, edges, root=3)):
        np.testing.assert_array_equal(a, b)
