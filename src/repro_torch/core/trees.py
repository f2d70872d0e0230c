"""Tree utilities for tree-structured Gaussian graphical models.

The port of ``repro.core.trees``: random trees, the correlation-decay
covariance (eq. 24: rho_rs = prod of edge correlations on Path(r,s)) and
structure comparison. Two representations coexist:

* **edge lists** (host): ``[(j, k), ...]``;
* **topological parent arrays** (tensors): nodes relabelled in BFS order
  so node ``t > 0`` has ``parent[t] < t`` with edge correlation
  ``rho[t]`` (``parent[0] = 0``, ``rho[0] = 0``). The tensor functions
  batch over leading axes where ``repro``'s did.
"""
from __future__ import annotations

import numpy as np
import torch


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


def chain_tree(d: int) -> list[tuple[int, int]]:
    return [(i, i + 1) for i in range(d - 1)]


def star_tree(d: int, center: int = 0) -> list[tuple[int, int]]:
    return [(center, j) for j in range(d) if j != center]


# 20-joint Kinect-style human skeleton (MAD dataset layout), used for the
# Figs. 10-11 reproduction. Node 0 is the hip-center root.
SKELETON_JOINTS = [
    "hip_center", "spine", "shoulder_center", "head",
    "shoulder_l", "elbow_l", "wrist_l", "hand_l",
    "shoulder_r", "elbow_r", "wrist_r", "hand_r",
    "hip_l", "knee_l", "ankle_l", "foot_l",
    "hip_r", "knee_r", "ankle_r", "foot_r",
]

SKELETON_EDGES = [
    (0, 1), (1, 2), (2, 3),
    (2, 4), (4, 5), (5, 6), (6, 7),
    (2, 8), (8, 9), (9, 10), (10, 11),
    (0, 12), (12, 13), (13, 14), (14, 15),
    (0, 16), (16, 17), (17, 18), (18, 19),
]


def tree_adjacency(d: int, edges: list[tuple[int, int]]) -> np.ndarray:
    adj = np.zeros((d, d), dtype=bool)
    for j, k in edges:
        adj[j, k] = adj[k, j] = True
    return adj


def tree_correlation_matrix(d: int, edges: list[tuple[int, int]],
                            weights) -> np.ndarray:
    """Full (d, d) float64 correlation matrix from edge correlations via
    eq. (24): rho_rs = prod of rho_e over Path(r, s), accumulated along a
    depth-first walk from every root (unit variances, Q_jj = 1)."""
    weights = np.asarray(weights, dtype=np.float64)
    if len(edges) != d - 1 or weights.shape != (d - 1,):
        raise ValueError(f"a tree on {d} nodes has {d - 1} edges and "
                         f"weights, got {len(edges)} and {weights.shape}")
    nbrs: list[list[tuple[int, float]]] = [[] for _ in range(d)]
    for (j, k), w in zip(edges, weights):
        nbrs[j].append((k, float(w)))
        nbrs[k].append((j, float(w)))
    Q = np.eye(d)
    for root in range(d):
        stack = [(root, -1, 1.0)]
        while stack:
            node, parent, acc = stack.pop()
            for child, w in nbrs[node]:
                if child == parent:
                    continue
                Q[root, child] = acc * w
                stack.append((child, node, acc * w))
    return Q


def topological_parents(
    d: int,
    edges: list[tuple[int, int]],
    weights,
    root: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Relabel a weighted tree into topological parent-array form.

    Returns ``(parent, rho, perm)``: int32/float32 arrays of shape (d,)
    with ``parent[t] < t`` for ``t > 0`` (``parent[0] = 0``, ``rho[0] =
    0``), and ``perm[t]`` = the original node at topological position t.
    """
    weights = np.asarray(weights, dtype=np.float32)
    if len(edges) != d - 1 or weights.shape != (d - 1,):
        raise ValueError("a tree on d nodes has d - 1 edges and weights")
    nbrs: list[list[tuple[int, float]]] = [[] for _ in range(d)]
    for (j, k), w in zip(edges, weights):
        nbrs[j].append((k, float(w)))
        nbrs[k].append((j, float(w)))
    perm = np.empty(d, dtype=np.int64)
    parent = np.zeros(d, dtype=np.int32)
    rho = np.zeros(d, dtype=np.float32)
    pos = np.empty(d, dtype=np.int64)  # original label -> topological slot
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


def adjacency_from_parents(parent: torch.Tensor) -> torch.Tensor:
    """(..., d) topological parent array -> symmetric (..., d, d) bool
    adjacency."""
    parent = torch.as_tensor(parent)
    d = parent.shape[-1]
    idx = torch.arange(d, device=parent.device)
    half = (idx[:, None] == parent[..., None, :]) & (idx[None, :] > 0)
    # half[..., p, t] = (parent[t] == p) for t > 0: edge (t, parent[t])
    return half | half.transpose(-1, -2)


def path_product_mixer(parent: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Lower-triangular path-product matrix M with x = M @ (c * z).

    Solves x_t = rho_t x_{parent(t)} + c_t z_t, i.e. M = (I - B)^{-1} with
    B[t, parent[t]] = rho_t strictly lower triangular. B is nilpotent, so
    the inverse is the finite product prod_k (I + B^(2^k)): ceil(log2 d)
    rounds of two f32 matmuls on ``rho``'s device. Batched over leading
    axes of (..., d) ``parent``/``rho``. Each entry of each product sums
    one path's term and zeros, so M is exact to its products' rounding
    whatever order a matmul sums in.
    """
    rho = torch.as_tensor(rho, dtype=torch.float32)
    parent = torch.as_tensor(parent, device=rho.device).to(torch.int64)
    d = parent.shape[-1]
    t = torch.arange(d, device=rho.device)
    B = torch.zeros((*parent.shape, d), dtype=torch.float32,
                    device=rho.device)
    B.scatter_(-1, parent[..., None],
               torch.where(t > 0, rho, 0.0)[..., None])
    M = torch.eye(d, dtype=torch.float32, device=rho.device) + B
    P = B
    for _ in range(max(int(np.ceil(np.log2(max(d, 2)))), 1)):
        P = P @ P
        M = M + M @ P
    return M


def _innovation_scale(rho: torch.Tensor) -> torch.Tensor:
    """c_t = sqrt(1 - rho_t^2) with c_0 = 1 (the root's own variance)."""
    c = torch.sqrt(torch.clamp(1.0 - torch.square(rho), min=0.0))
    c[..., 0] = 1.0
    return c


def tree_correlation(parent: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Eq. (24) correlation matrix from parent-array form:
    ``Q[t, s] == Q_host[perm[t], perm[s]]``."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    A = path_product_mixer(parent, rho) * _innovation_scale(rho)[None, :]
    return A @ A.T


def structure_hamming(adj_a: torch.Tensor, adj_b: torch.Tensor) -> torch.Tensor:
    """Edge-set symmetric difference |E_a ^ E_b| of two symmetric
    adjacencies (int32, batched over leading axes)."""
    diff = torch.as_tensor(adj_a) != torch.as_tensor(adj_b)
    return (diff.sum(dim=(-2, -1)) // 2).to(torch.int32)


def structure_error(adj_est: torch.Tensor, adj_true: torch.Tensor) -> torch.Tensor:
    """Indicator of the paper's error event {T_hat != T} (bool, batched)."""
    diff = torch.as_tensor(adj_est) != torch.as_tensor(adj_true)
    return diff.flatten(-2).any(dim=-1)


def edge_counts(adj_est: torch.Tensor, adj_true: torch.Tensor):
    """``(shared, est_edges, true_edges)`` = (|E_hat & E|, |E_hat|, |E|)
    as int32 (batched): the exact channels P / R / F1 come from."""
    est, true = torch.broadcast_tensors(torch.as_tensor(adj_est),
                                        torch.as_tensor(adj_true))

    def half(m):
        return (m.sum(dim=(-2, -1)) // 2).to(torch.int32)

    return half(est & true), half(est), half(true)


def edge_f1(adj_est: torch.Tensor, adj_true: torch.Tensor) -> torch.Tensor:
    """Edge-level F1 = 2 TP / (2 TP + FP + FN); 1.0 iff identical (f32)."""
    est = torch.as_tensor(adj_est)
    true = torch.as_tensor(adj_true)
    tp = (est & true).sum(dim=(-2, -1)).to(torch.float32)
    fp = (est & ~true).sum(dim=(-2, -1)).to(torch.float32)
    fn = (~est & true).sum(dim=(-2, -1)).to(torch.float32)
    return 2.0 * tp / torch.clamp(2.0 * tp + fp + fn, min=1.0)


def edges_canonical(edges) -> set[tuple[int, int]]:
    return {(min(j, k), max(j, k)) for j, k in edges}


def tree_edit_distance(e1, e2) -> int:
    """Number of edges present in exactly one of the two trees (symmetric
    difference size). Zero iff identical structure."""
    s1, s2 = edges_canonical(e1), edges_canonical(e2)
    return len(s1 ^ s2)


def is_tree(d: int, edges) -> bool:
    if len(edges) != d - 1:
        return False
    parent = list(range(d))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for j, k in edges:
        rj, rk = find(j), find(k)
        if rj == rk:
            return False
        parent[rj] = rk
    return True
