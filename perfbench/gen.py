"""Traffic generators of the benchmark: the tree-GGM inputs and the sweep's
plan pool, made from ``--seed`` alone.

Frozen copies of the port's data plane (``repro_torch.data.ggm``,
``core.sampler.sample_tree_ggm``, ``core.trees``) and of its trial
ground truths (``core.experiments._host_setup``), so that a later change
to the program cannot move the yardstick. At a small size they equal the
port's draws bit for bit (``tests/test_perfbench_gen.py``). This module
imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

#: rows drawn per block of driving normals (``core.sampler._ROW_BLOCK``)
ROW_BLOCK = 1 << 16
#: keys are two uint32 words: a plan's seed0 + rep stays below 2^32
SEED_SPACE = 1 << 32


def random_tree(d: int, rng: np.random.Generator) -> list[tuple[int, int]]:
    """Uniform random labelled tree on ``d`` nodes via a Pruefer sequence."""
    if d < 2:
        return []
    if d == 2:
        return [(0, 1)]
    prufer = rng.integers(0, d, size=d - 2)
    degree = np.ones(d, dtype=np.int64)
    for v in prufer:
        degree[v] += 1
    edges = []
    for v in prufer:
        leaf = int(np.flatnonzero(degree == 1)[0])
        edges.append((leaf, int(v)))
        degree[leaf] = 0
        degree[v] -= 1
    remaining = np.flatnonzero(degree == 1)
    edges.append((int(remaining[0]), int(remaining[1])))
    return edges


def topological_parents(d: int, edges, weights, root: int = 0):
    """(parent, rho, perm): the tree relabelled in BFS order, so node t > 0
    has parent[t] < t and edge correlation rho[t]; perm[t] is the original
    label at slot t."""
    weights = np.asarray(weights, dtype=np.float32)
    nbrs: list[list[tuple[int, float]]] = [[] for _ in range(d)]
    for (j, k), w in zip(edges, weights):
        nbrs[j].append((k, w))
        nbrs[k].append((j, w))
    perm = np.empty(d, dtype=np.int64)
    parent = np.zeros(d, dtype=np.int32)
    rho = np.zeros(d, dtype=np.float32)
    pos = np.empty(d, dtype=np.int64)
    perm[0] = root
    pos[root] = 0
    seen = [False] * d
    seen[root] = True
    head, tail = 0, 1
    while head < tail:
        node = int(perm[head])
        head += 1
        for child, w in nbrs[node]:
            if not seen[child]:
                seen[child] = True
                perm[tail] = child
                pos[child] = tail
                parent[tail] = pos[node]
                rho[tail] = w
                tail += 1
    if tail != d:
        raise ValueError("edges do not span a connected tree")
    return parent, rho, perm


def innovation_scale(rho: torch.Tensor) -> torch.Tensor:
    """c_t = sqrt(1 - rho_t^2), c_0 = 1."""
    c = torch.sqrt(torch.clamp(1.0 - torch.square(rho), min=0.0))
    c[..., 0] = 1.0
    return c


def path_product_mixer(parent: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Lower-triangular M = (I - B)^-1, B[t, parent[t]] = rho[t], as the
    product of (I + B^(2^k)) in f32 (``core.trees.path_product_mixer``)."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    parent = torch.as_tensor(parent, device=rho.device).to(torch.int64)
    d = parent.shape[-1]
    t = torch.arange(d, device=rho.device)
    B = torch.zeros((*parent.shape, d), dtype=torch.float32, device=rho.device)
    B.scatter_(-1, parent[..., None], torch.where(t > 0, rho, 0.0)[..., None])
    M = torch.eye(d, dtype=torch.float32, device=rho.device) + B
    P = B
    for _ in range(max(int(np.ceil(np.log2(max(d, 2)))), 1)):
        P = P @ P
        M = M + M @ P
    return M


def tree_structure(d: int, seed: int, rho_min: float, rho_max: float):
    """(edges, edge correlations) of the ground-truth tree of ``seed``."""
    rng = np.random.default_rng(seed)
    edges = random_tree(d, rng)
    return edges, rng.uniform(rho_min, rho_max, size=d - 1)


class Highest:
    """Full-f32 matmuls (no TF32) inside the block."""

    def __enter__(self):
        self.saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.saved)


def tree_batch(d: int, n: int, seed: int, batch_seed: int, rho_min: float,
               rho_max: float, device) -> torch.Tensor:
    """(n, d) f32 samples of the tree GGM of ``seed`` on ``device``, drawn
    by a ``torch.Generator`` there seeded from (seed, batch_seed): the
    port's ``GGMDataset(d, seed=seed).sample(n, batch_seed)``."""
    edges, w = tree_structure(d, seed, rho_min, rho_max)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    state = np.random.SeedSequence([seed, batch_seed])
    gen.manual_seed(int(state.generate_state(1, np.uint32)[0]))
    parent, rho, perm = topological_parents(d, edges, w)
    with Highest():
        rho_t = torch.as_tensor(rho, device=dev)
        M = path_product_mixer(torch.as_tensor(parent, device=dev), rho_t)
        inv = np.empty(d, dtype=np.int64)
        inv[perm] = np.arange(d)
        mix_t = innovation_scale(rho_t)[:, None] * M[
            torch.as_tensor(inv, device=dev)].T
        x = torch.empty((n, d), dtype=torch.float32, device=dev)
        for r0 in range(0, n, ROW_BLOCK):
            r1 = min(n, r0 + ROW_BLOCK)
            z = torch.randn((r1 - r0, d), generator=gen, dtype=torch.float32,
                            device=dev)
            torch.matmul(z, mix_t, out=x[r0:r1])
    return x


def plan_seeds(seed: int, pool: int, reps: int) -> list[int]:
    """seed0 of each plan of a sweep pool: ``pool`` plans spaced ``reps``
    apart, so no two plans share a trial's tree or key."""
    base = int(seed) % (SEED_SPACE - pool * reps)
    return [base + i * reps for i in range(pool)]


def trial_trees(d: int, reps: int, seed0: int, rho_min: float,
                rho_max: float) -> tuple[np.ndarray, np.ndarray]:
    """(parents, rhos), (reps, d) int32 / f32: trial ``rep``'s random tree
    and correlations from ``default_rng(seed0 + rep)`` in topological
    form (``core.experiments._host_setup``)."""
    parents = np.zeros((reps, d), np.int32)
    rhos = np.zeros((reps, d), np.float32)
    for rep in range(reps):
        rng = np.random.default_rng(seed0 + rep)
        edges = random_tree(d, rng)
        w = rng.uniform(rho_min, rho_max, size=d - 1)
        parents[rep], rhos[rep], _ = topological_parents(d, edges, w)
    return parents, rhos
