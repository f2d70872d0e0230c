"""The frozen generators and the reference's copies against the port's own
at a small size on the CPU (the test may import the port; the benchmark's
reference never does)."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import gen, reference, threefry  # noqa: E402
from repro_torch.core import estimators, experiments, prng, sampler  # noqa: E402
from repro_torch.core.quantizers import PerSymbolQuantizer  # noqa: E402
from repro_torch.data import GGMDataset  # noqa: E402


@pytest.mark.parametrize("d,n,seed,batch", [(32, 1000, 5, 0), (64, 70000, 9, 1)])
def test_tree_batch_equals_the_ports_dataset(d, n, seed, batch):
    got = gen.tree_batch(d, n, seed, batch, 0.4, 0.9, "cpu")
    want = GGMDataset(d=d, seed=seed).sample(n, batch_seed=batch,
                                             device="cpu")
    assert torch.equal(got, want)


def test_trial_trees_equal_the_ports_host_setup():
    got = gen.trial_trees(24, 5, 123, 0.4, 0.9)
    want = experiments._host_setup(24, 5, "random", 0.4, 0.9, 123)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_plan_seeds_are_disjoint_and_fit_a_key():
    seeds = gen.plan_seeds(2 ** 31 + 12345, 4, 32)
    assert len({s + r for s in seeds for r in range(32)}) == 128
    assert all(0 <= s and s + 32 < 2 ** 32 for s in seeds)


def test_threefry_copy_equals_the_ports():
    keys = threefry.fold_in(threefry.key(77), torch.arange(3))
    assert torch.equal(keys, prng.fold_in(prng.key(77, device="cpu"),
                                          torch.arange(3)))
    assert torch.equal(threefry.normal(keys, (5, 7)),
                       prng.normal(keys, (5, 7)))


def test_sweep_samples_follow_the_ports_sampler():
    plan = experiments.TrialPlan(d=12, ns=(300,), reps=3, seed0=41)
    parents, rhos, _, keys = experiments._plan_setup(
        *experiments._setup_key(plan), "cpu")
    want = sampler.sample_tree_ggm_rows_batch(keys, 300, parents, rhos)
    p, r = reference.trial_truth(12, 3, 41, 0.4, 0.9, "cpu")
    got = reference.sweep_samples(41, 3, 300, p, r)
    assert float((got - want).abs().max()) < 1e-5
    tf32 = reference.sweep_samples(41, 3, 300, p, r, reference.TF32)
    assert float((tf32 - want).abs().max()) > 1e-4
    truth = reference.truth_adjacency(p)
    assert torch.equal(truth, experiments._plan_setup(
        *experiments._setup_key(plan), "cpu")[2])


@pytest.mark.parametrize("rate", [1, 2, 3, 4])
def test_codebook_and_codes_equal_the_ports(rate):
    a, c = reference.codebook(rate)
    q = PerSymbolQuantizer(rate)
    assert np.array_equal(np.float32(a), q.boundaries_np)
    assert np.allclose(np.float32(c), q.centroids_np, rtol=0, atol=1e-7)
    x = torch.randn(400, 9, generator=torch.Generator().manual_seed(rate))
    x[0, 0], x[0, 1] = 0.0, -1e-45
    assert torch.equal(reference.code_payload(x, rate), q.encode(x))


def test_sign_payload_and_weights_follow_the_ports():
    from repro_torch.core.strategy import Strategy

    x = torch.randn(2000, 16, generator=torch.Generator().manual_seed(3))
    x[0, :3] = torch.tensor([0.0, -1e-45, -0.0])
    s = Strategy("sign")
    p = estimators.strategy_payload(x, s)
    assert torch.equal(reference.sign_payload(x), p)
    g = estimators.payload_gram(p, s)
    G = reference.gram(reference.sign_payload(x), "sign")
    assert torch.equal(g.double(), G)
    w = estimators.weights_from_gram(g, 2000, s)
    # independent columns: weights near 0, where f32's 1 - h(theta)
    # cancels to ~1e-7 against a largest weight of ~1e-3
    assert reference.weights_gap(w, reference.weights(G, 2000, "sign")) \
        < 1e-4
    for method, rate in (("persymbol", 3), ("original", 1)):
        st = Strategy(method, rate=rate)
        g = estimators.payload_gram(estimators.strategy_payload(x, st), st)
        Gr = reference.gram(reference.payload(x, method, rate), method, rate)
        assert float((g.double() - Gr).abs().max()) / 2000 < 1e-6
        assert reference.weights_gap(
            estimators.weights_from_gram(g, 2000, st),
            reference.weights(Gr, 2000, method)) < 1e-5


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -12, -3.14159])
    r = reference.tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0            # a tie goes to even
    assert r[2] == 1.0 + 2 ** -9                  # a tie goes to even
    assert r[3] == 1.0 + 2 ** -10
    assert torch.equal(reference.tf32_round(r), r)
    assert float((r[4] - x[4]).abs()) <= 2 ** -10 * 4


def test_prim_finds_the_largest_tree_and_spanning_rejects_others():
    g = torch.Generator().manual_seed(0)
    w = torch.rand(3, 10, 10, generator=g, dtype=torch.float64)
    w = w + w.transpose(-1, -2)
    best, adj = reference.max_spanning_tree(w)
    from repro_torch.core.chow_liu import kruskal_mst

    for b in range(3):
        edges = kruskal_mst(w[b].numpy())
        assert float(sum(w[b, j, k] for j, k in edges)) == pytest.approx(
            float(best[b]))
    assert reference.spanning(adj).all()
    assert float(reference.tree_gaps(adj, w).max()) < 1e-12
    bad = adj.clone()
    j, k = torch.nonzero(torch.triu(bad[0]))[0].tolist()
    bad[0, j, k] = bad[0, k, j] = False           # one edge short
    other = torch.nonzero(torch.triu(~adj[1], diagonal=1))[0].tolist()
    bad[1, other[0], other[1]] = bad[1, other[1], other[0]] = True
    assert reference.spanning(bad).tolist() == [False, False, True]
    assert reference.tree_gaps(bad, w)[:2].tolist() == [1.0, 1.0]
