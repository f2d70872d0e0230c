"""The port's estimators and MWST solvers against ``repro``.

MWST solvers are held to ``repro``'s on ``repro``'s own weights, where
they must agree exactly; ``learn_structure`` returns ``repro``'s exact
edge list for every method, rate, wire and MST backend on shared samples
(an instance without near-ties: torch's and XLA's log/log1p differ in the
last ulp, see ROADMAP §3).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import chow_liu as j_cl
from repro.core import estimators as j_est
from repro.core import trees as j_trees
from repro.core.strategy import Strategy as JStrategy
from repro.data.ggm import GGMDataset as JDataset
from repro_torch import trace
from repro_torch.core import chow_liu as t_cl
from repro_torch.core import estimators as t_est
from repro_torch.core import trees as t_trees
from repro_torch.core.gram import GramEngine
from repro_torch.interop import strategy_from_fields

D, N = 24, 2048


@pytest.fixture(scope="module")
def samples():
    return np.array(JDataset(d=D, seed=3).sample(N))  # a writable copy


def _weights(seed, d=20, ties=True):
    rng = np.random.default_rng(seed)
    w = rng.random((d, d)).astype(np.float32)
    if ties:
        w = np.round(w * 8) / 8  # many exact ties
    return (w + w.T) / 2


@pytest.mark.parametrize("seed", range(4))
def test_rank_weights_bit_identical(seed):
    w = _weights(seed)
    np.testing.assert_array_equal(
        t_cl._rank_weights(torch.from_numpy(w)).numpy(),
        np.asarray(j_cl._rank_weights(jnp.asarray(w))))


@pytest.mark.parametrize("seed", range(4))
def test_mst_on_repro_weights(seed):
    w = _weights(seed, d=33, ties=seed % 2 == 0)
    want = np.asarray(j_cl.boruvka_mst(jnp.asarray(w)))
    np.testing.assert_array_equal(
        t_cl.boruvka_mst(torch.from_numpy(w)).numpy(), want)
    assert t_cl.kruskal_mst(w) == j_cl.kruskal_mst(w)
    assert t_cl.chow_liu(w, "boruvka") == t_cl.adjacency_to_edges(want)
    assert t_cl.kruskal_forest(w, 0.5) == j_cl.kruskal_forest(w, 0.5)


def test_boruvka_batch_and_small_d():
    ws = np.stack([_weights(s, d=17) for s in range(3)])
    np.testing.assert_array_equal(
        t_cl.boruvka_mst_batch(torch.from_numpy(ws)).numpy(),
        np.asarray(j_cl.boruvka_mst_batch(jnp.asarray(ws))))
    for d in (1, 2):
        w = np.ones((d, d), np.float32)
        np.testing.assert_array_equal(
            t_cl.boruvka_mst(torch.from_numpy(w)).numpy(),
            np.asarray(j_cl.boruvka_mst(jnp.asarray(w))))


def _edges_case(case):
    """(adjacency, reads): a Boruvka tree, a forest of fewer than d - 1
    edges, a graph of more, or no edge; a graph takes a count read and a
    read of its pairs after the first."""
    kind, d = case
    w = _weights(d, d=d, ties=False)
    if kind == "tree":
        return t_cl.boruvka_mst(torch.from_numpy(w)), 1
    adj = torch.zeros(d, d, dtype=torch.bool)
    if kind == "forest":
        for j, k in t_cl.kruskal_forest(w, 0.85):
            adj[j, k] = adj[k, j] = True
        assert 0 < int(adj.sum()) // 2 < d - 1
    if kind == "graph":
        adj = torch.from_numpy(w > 0.5).fill_diagonal_(False)
        assert int(adj.sum()) // 2 > d - 1
    return adj, 1 + 2 * (kind == "graph")


@pytest.mark.parametrize("case", [("tree", d) for d in (1, 2, 3, 17, 257)]
                         + [("forest", 40), ("graph", 40), ("empty", 9)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_edges_on_device_equal_the_numpy_path(case):
    """The device extraction (here on CPU tensors) and the port's numpy
    path give the reference's list element for element, as Python ints,
    the extraction from one read of d int32 index pairs for a forest; a
    graph reads its count and pairs after."""
    adj, reads = _edges_case(case)
    d = adj.shape[-1]
    want = j_cl.adjacency_to_edges(adj.numpy())
    assert t_cl.adjacency_to_edges(adj.numpy()) == want
    before = trace.counts()
    got = t_cl.edges_on_device(adj)
    delta = {k: v - before.get(k, 0) for k, v in trace.counts().items()}
    assert got == want
    assert all(type(v) is int for e in got for v in e)
    assert delta["host_reads"] == reads
    assert delta["edges_read_bytes"] == 4 * 2 * (d + (reads > 1) * len(want))


LEARN = (
    [JStrategy(), JStrategy(wire="packed"), JStrategy("original")]
    + [JStrategy("persymbol", rate=r) for r in range(1, 8)]
    + [JStrategy("persymbol", rate=r, wire="packed") for r in (1, 2, 4)])


@pytest.mark.parametrize("mst", ["boruvka", "kruskal"])
@pytest.mark.parametrize("s", LEARN, ids=lambda s: f"{s.label}-{s.wire}")
def test_learn_structure_edge_lists(samples, s, mst):
    s = dataclasses.replace(s, mst=mst)
    ts = strategy_from_fields(dataclasses.asdict(s))
    want = j_cl.learn_structure(samples, strategy=s)
    assert t_cl.learn_structure(samples, strategy=ts, device="cpu") == want
    # the kernel backend's plain versions give the same tree
    assert t_cl.learn_structure(torch.from_numpy(samples), strategy=ts,
                                engine=GramEngine(backend="kernel")) == want


def test_learn_structure_loose_kwargs_and_jit_alias(samples):
    want = j_cl.learn_structure(samples, method="persymbol", rate=3,
                                backend="boruvka")
    assert t_cl.learn_structure(samples, method="persymbol", rate=3,
                                backend="boruvka", device="cpu") == want
    adj = t_cl.learn_structure_jit(torch.from_numpy(samples))
    np.testing.assert_array_equal(
        adj.numpy(), np.asarray(j_cl.learn_structure_jit(jnp.asarray(samples))))


@pytest.mark.parametrize("method", ["sign", "persymbol", "original"])
def test_weights_from_gram(method):
    rng = np.random.default_rng(1)
    n = 500
    g = rng.integers(-n, n + 1, size=(3, 9, 9)).astype(np.float32)
    g = (g + np.swapaxes(g, -1, -2)) / 2
    g[:, np.arange(9), np.arange(9)] = n
    if method != "sign":
        g = g * np.float32(0.9)
    # mi_sign is 1 - h(theta): near theta = 1/2 its absolute error is that
    # of h ~ 1, an ulp of 1.0, whatever its relative size
    atol = 2.5e-7 if method == "sign" else 0.0
    want = np.asarray(j_est.weights_from_gram(jnp.asarray(g), n, method))
    got = t_est.weights_from_gram(torch.from_numpy(g), n, method)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    # traced-count form, the per-entry effective counts, and normalized
    nv = np.float32(n - 40)
    np.testing.assert_allclose(
        t_est.weights_from_gram(torch.from_numpy(g), torch.tensor(nv),
                                method).numpy(),
        np.asarray(j_est.weights_from_gram(jnp.asarray(g), jnp.asarray(nv),
                                           method)), rtol=1e-6, atol=atol)
    rows = rng.integers(0, n, size=(3, 9)).astype(np.float32)
    rows[0, 2] = 1.0
    n_eff = np.array(j_est.effective_counts(jnp.asarray(rows)))
    np.testing.assert_array_equal(
        t_est.effective_counts(torch.from_numpy(rows)).numpy(), n_eff)
    np.testing.assert_allclose(
        t_est.weights_from_gram(torch.from_numpy(g),
                                torch.from_numpy(n_eff), method).numpy(),
        np.asarray(j_est.weights_from_gram(jnp.asarray(g),
                                           jnp.asarray(n_eff), method)),
        rtol=1e-6, atol=atol)
    gn = g / np.float32(n)
    np.testing.assert_allclose(
        t_est.weights_from_gram(torch.from_numpy(gn), n, method,
                                normalized=True).numpy(),
        np.asarray(j_est.weights_from_gram(jnp.asarray(gn), n, method,
                                           normalized=True)),
        rtol=1e-6, atol=atol)


@pytest.mark.parametrize("method", ["sign", "persymbol", "original"])
def test_corr_from_gram(method):
    x = np.asarray(JDataset(d=8, seed=2).sample(300))
    g = (x.T @ x).astype(np.float32)
    if method == "sign":
        s = np.where(x >= 0, 1.0, -1.0).astype(np.float32)
        g = s.T @ s
    want = np.asarray(j_est.corr_from_gram(jnp.asarray(g), 300, method))
    got = t_est.corr_from_gram(torch.from_numpy(g), 300, method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sign_statistics(samples):
    u = np.where(samples >= 0, 1, -1).astype(np.int8)
    eng = GramEngine(backend="torch")
    th = t_est.theta_hat(torch.from_numpy(u), engine=eng)
    np.testing.assert_array_equal(th.numpy(),
                                  np.asarray(j_est.theta_hat(jnp.asarray(u))))
    p = np.packbits((samples >= 0).T, axis=-1, bitorder="little")
    np.testing.assert_array_equal(
        t_est.theta_hat_packed(torch.from_numpy(p), N, engine=eng).numpy(),
        th.numpy())
    np.testing.assert_allclose(t_est.mi_sign(th).numpy(),
                               np.asarray(j_est.mi_sign(jnp.asarray(th))),
                               rtol=1e-6, atol=2.5e-7)
    rho = np.linspace(-0.99, 0.99, 50, dtype=np.float32)
    np.testing.assert_allclose(
        t_est.mi_gaussian(torch.from_numpy(rho)).numpy(),
        np.asarray(j_est.mi_gaussian(jnp.asarray(rho))), rtol=1e-6)
    np.testing.assert_allclose(
        t_est.rho_squared_unbiased(torch.from_numpy(rho), 100).numpy(),
        np.asarray(j_est.rho_squared_unbiased(jnp.asarray(rho), 100)),
        rtol=1e-6)


@pytest.mark.parametrize("s", [JStrategy(), JStrategy(wire="packed"),
                               JStrategy("persymbol", rate=3),
                               JStrategy("persymbol", rate=2, wire="packed")],
                         ids=lambda s: f"{s.label}-{s.wire}")
def test_strategy_weights_batch_bucketed(samples, s):
    """Bucketed (n_valid-masked) batch weights: the Gram is bit-identical
    on integer paths and within the f32 reduction-order tolerance on
    R >= 2 codes; the weights follow weights_from_gram's tolerance."""
    ts = strategy_from_fields(dataclasses.asdict(s))
    xb = np.stack([samples[:1024], samples[1024:]])
    jp = j_est.strategy_payload(jnp.asarray(xb), s, n_valid=1000)
    want_g = np.asarray(j_est.payload_gram(jp, s, n_valid=1000))
    tp = t_est.strategy_payload(torch.from_numpy(xb), ts, n_valid=1000)
    got_g = t_est.payload_gram(tp, ts, n_valid=1000).numpy()
    if s.method == "sign":
        np.testing.assert_array_equal(got_g, want_g)
    else:
        np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-5 * 1000)
    got = t_est.strategy_weights_batch(torch.from_numpy(xb), ts,
                                       n_valid=1000)
    np.testing.assert_array_equal(
        got.numpy(), t_est.weights_from_gram(
            torch.from_numpy(got_g), torch.tensor(1000.0), ts).numpy())
    want = np.asarray(j_est.strategy_weights_batch(
        jnp.asarray(xb), s, n_valid=1000))
    if s.method == "sign":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2.5e-7)
    # fault counts that are all n_valid (a zero-fault realization) give
    # the bucketed weights bit for bit
    got_f = t_est.strategy_weights_batch(
        torch.from_numpy(xb), ts, n_valid=1000,
        n_rows=torch.full((2, D), 1000, dtype=torch.int32))
    np.testing.assert_array_equal(got_f.numpy(), got.numpy())


@pytest.mark.parametrize("name", ["mac_weights_batch", "budget_payload"])
def test_channel_plane_estimators_wait_for_the_wire_plane(samples, name):
    """The channel plane's estimators are ported: each gives repro's
    result on repro's samples (MAC weights within the sign tolerance,
    budget codes bit for bit)."""
    from repro.comm.channel import BudgetChannel, MACChannel

    x = samples[None, :1000]
    if name == "mac_weights_batch":
        s = JStrategy("sign", channel=MACChannel(8))
        want = np.asarray(j_est.mac_weights_batch(jnp.asarray(x), s,
                                                  n_valid=900))
        got = t_est.mac_weights_batch(torch.from_numpy(x),
                                      strategy_from_fields(
                                          dataclasses.asdict(s)),
                                      n_valid=900).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2.5e-7)
    else:
        s = JStrategy("persymbol", rate=3, channel=BudgetChannel(
            budget_bits=5 * 1000 * D // 2, machines=4))
        rates = s.channel.column_rates(1000, D, 3)
        assert sorted(set(rates.tolist())) == [2, 3]
        want = np.asarray(j_est.budget_payload(jnp.asarray(x), s, rates,
                                               n_valid=900))
        got = t_est.budget_payload(torch.from_numpy(x),
                                   strategy_from_fields(
                                       dataclasses.asdict(s)), rates,
                                   n_valid=900).numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(AttributeError):
        getattr(t_est, "no_such_estimator")


def test_structure_metrics(samples):
    edges = j_cl.learn_structure(samples)
    truth, _ = JDataset(d=D, seed=3).structure()
    a = j_trees.tree_adjacency(D, edges)
    b = j_trees.tree_adjacency(D, truth)
    assert (t_trees.tree_adjacency(D, edges) == a).all()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert int(t_trees.structure_hamming(ta, tb)) == int(
        j_trees.structure_hamming(a, b))
    assert bool(t_trees.structure_error(ta, tb)) == bool(
        j_trees.structure_error(a, b))
    assert [int(c) for c in t_trees.edge_counts(ta, tb)] == [
        int(c) for c in j_trees.edge_counts(a, b)]
    assert float(t_trees.edge_f1(ta, tb)) == float(j_trees.edge_f1(a, b))
    assert t_trees.tree_edit_distance(edges, truth) == \
        j_trees.tree_edit_distance(edges, truth)
    assert t_trees.edges_canonical(edges) == j_trees.edges_canonical(edges)
    assert t_trees.is_tree(D, edges) and not t_trees.is_tree(D, edges[:-1])
