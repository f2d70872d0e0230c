"""Chow-Liu structure estimation: maximum-weight spanning tree solvers.

The port of ``repro.core.chow_liu``. Two MWST implementations with
identical tie-breaking:

* ``kruskal_mst`` — the paper's choice (§3): host numpy, edges sorted by
  descending weight, union-find.
* ``boruvka_mst`` — O(log d) rounds of per-component max-reductions as
  tensor ops (scatter_reduce), on the weights' device, batched over a
  leading axis by ``boruvka_mst_batch``.

Both depend only on the ORDER of the weights; ties are well-defined by
ranking flattened weights with a stable sort (smaller row-major flat
index first), so both agree exactly on any input.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch._device import as_tensor, resolve_device

from . import estimators
from .strategy import Strategy, as_strategy


# --------------------------------------------------------------------------
# Host-side Kruskal (reference; the algorithm named in the paper)
# --------------------------------------------------------------------------

def kruskal_forest(weights, min_weight: float) -> list[tuple[int, int]]:
    """Maximum-weight spanning FOREST: Kruskal that stops adding edges whose
    weight is below ``min_weight`` (``-inf`` gives the spanning tree).

    Ties go to the smaller row-major flat index (stable sort), matching
    :func:`boruvka_mst`. Non-finite entries are voided edges and are
    skipped.
    """
    if isinstance(weights, torch.Tensor):
        trace.count("host_reads")
        weights = weights.detach().cpu().numpy()
    w = np.asarray(weights, dtype=np.float64)
    d = w.shape[0]
    iu, ju = np.triu_indices(d, k=1)
    vals = w[iu, ju]
    finite = np.isfinite(vals)
    order = np.argsort(-np.where(finite, vals, -np.inf), kind="stable")
    parent = np.arange(d)

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    edges: list[tuple[int, int]] = []
    for idx in order:
        # voided edges sort to the tail, so the first one ends the scan
        if not finite[idx] or vals[idx] < min_weight:
            break
        j, k = int(iu[idx]), int(ju[idx])
        rj, rk = find(j), find(k)
        if rj != rk:
            parent[rj] = rk
            edges.append((j, k))
            if len(edges) == d - 1:
                break
    return edges


def kruskal_mst(weights) -> list[tuple[int, int]]:
    """Max-weight spanning tree via Kruskal. ``weights``: symmetric (d, d)."""
    with trace.span("repro_torch.mst", mst="kruskal"):
        return kruskal_forest(weights, min_weight=-np.inf)


# --------------------------------------------------------------------------
# Device-side Boruvka
# --------------------------------------------------------------------------

def _rank_weights(weights: torch.Tensor) -> torch.Tensor:
    """Replace (..., d, d) weights by distinct int32 ranks (order-preserving).

    A stable descending sort breaks ties by the smaller flat index —
    identical to Kruskal's order over the upper triangle; the (j,k)/(k,j)
    ranks are unified by max, and the diagonal is forced to -1. Ranks
    reach d^2 (16.8M at d = 4096), inside int32.
    """
    d = weights.shape[-1]
    flat = weights.reshape(*weights.shape[:-2], d * d)
    order = torch.argsort(-flat, dim=-1, stable=True)
    vals = torch.arange(d * d, 0, -1, dtype=torch.int32,
                        device=weights.device).expand_as(order)
    ranks = torch.zeros_like(order, dtype=torch.int32).scatter_(-1, order,
                                                                vals)
    r = ranks.reshape(weights.shape)
    r = torch.maximum(r, r.transpose(-1, -2))
    eye = torch.eye(d, dtype=torch.bool, device=weights.device)
    return r.masked_fill(eye, -1)


_I32_MIN = torch.iinfo(torch.int32).min


def boruvka_mst_batch(weights: torch.Tensor, chunk: int | None = None, *,
                      early_exit: bool = True) -> torch.Tensor:
    """Max-weight spanning trees of (b, d, d) weights -> (b, d, d) bools.

    Each round picks, for every component, its best outgoing edge (the
    champion of the component's nodes, smallest node index on ties) and
    merges along it. Boruvka at least halves the component count each
    round, so ceil(log2 d) rounds finish every trial, and the round body
    is idempotent once a single component is left.

    ``early_exit=True`` reads the largest component count on the host
    after every round and stops when every trial is one component (one
    host sync a round). ``early_exit=False`` runs the ceil(log2 d) rounds
    with no host sync: the trial plane's form, whose contract is one
    device->host transfer a sweep. Both give the same trees.

    ``chunk`` streams the batch through the solver in slabs of that many
    trials, bounding the rank and component scratch; trials are
    independent, so the result is bit-identical to the full batch.
    """
    weights = torch.as_tensor(weights)
    b = weights.shape[0]
    if chunk is None or chunk >= b:
        return _boruvka_slab(weights, early_exit)
    chunk = max(1, int(chunk))
    return torch.cat([_boruvka_slab(weights[i:i + chunk], early_exit)
                      for i in range(0, b, chunk)])


def _boruvka_slab(weights: torch.Tensor, early_exit: bool) -> torch.Tensor:
    b, d = weights.shape[0], weights.shape[-1]
    dev = weights.device
    W = _rank_weights(weights)
    n_jump = int(np.ceil(np.log2(max(d, 2)))) + 1
    rounds = int(np.ceil(np.log2(d))) if d > 1 else 0
    ar = torch.arange(d, dtype=torch.int64, device=dev).expand(b, d)
    comp = ar.clone()
    sel = torch.zeros((b, d * d), dtype=torch.int32, device=dev)
    for _ in range(rounds):
        cross = comp[:, :, None] != comp[:, None, :]
        Wm = torch.where(cross, W, -1)
        best_w, best_k = Wm.max(dim=-1)        # best outgoing rank per node
        # per-component champion rank (segment max; empty -> int32 min)
        seg_best = torch.full((b, d), _I32_MIN, dtype=torch.int32,
                              device=dev).scatter_reduce(
            1, comp, best_w, "amax", include_self=True)
        has_edge = seg_best >= 0
        is_best = (best_w == seg_best.gather(1, comp)) & (best_w >= 0)
        # champion node per component = smallest index among is_best
        node_score = torch.where(is_best, d - ar, 0).to(torch.int32)
        seg_node = torch.full((b, d), _I32_MIN, dtype=torch.int32,
                              device=dev).scatter_reduce(
            1, comp, node_score, "amax", include_self=True)
        valid = has_edge & (seg_node > 0)
        j_sel = torch.where(valid, d - seg_node.to(torch.int64), 0)
        k_sel = torch.where(valid, best_k.gather(1, j_sel), 0)
        v32 = valid.to(torch.int32)
        sel.scatter_reduce_(1, j_sel * d + k_sel, v32, "amax")
        sel.scatter_reduce_(1, k_sel * d + j_sel, v32, "amax")
        # merge component labels: parent[max] = min, then pointer-jump
        cj, ck = comp.gather(1, j_sel), comp.gather(1, k_sel)
        hi = torch.where(valid, torch.maximum(cj, ck), ar)
        lo = torch.where(valid, torch.minimum(cj, ck), ar)
        parent = ar.clone().scatter_reduce(1, hi, lo, "amin",
                                           include_self=True)
        for _ in range(n_jump):
            parent = parent.gather(1, parent)
        comp = parent.gather(1, comp)
        if early_exit:
            present = torch.zeros((b, d), dtype=torch.int32, device=dev)
            present.scatter_(1, comp, 1)
            trace.count("host_reads")
            if int(present.sum(dim=1).max()) <= 1:
                break
    return sel.reshape(b, d, d).bool()


def boruvka_mst(weights, *, early_exit: bool = True) -> torch.Tensor:
    """Max-weight spanning tree of symmetric (d, d) weights (diagonal
    ignored) -> (d, d) bool adjacency on the weights' device."""
    weights = torch.as_tensor(weights)
    with trace.span("repro_torch.mst", weights.device, mst="boruvka"):
        return boruvka_mst_batch(weights.unsqueeze(0),
                                 early_exit=early_exit)[0]


def adjacency_to_edges(adj) -> list[tuple[int, int]]:
    """Symmetric bool adjacency -> canonical edge list: the upper
    triangle's nonzeros in row-major order. A CUDA adjacency is reduced
    on the card and only its index pairs cross to the host
    (:func:`edges_on_device`); a host adjacency goes through numpy."""
    with trace.span("repro_torch.edges"):
        if isinstance(adj, torch.Tensor) and adj.is_cuda:
            return edges_on_device(adj)
        if isinstance(adj, torch.Tensor):
            trace.count("host_reads")
            trace.count("edges_read_bytes", adj.numel() * adj.element_size())
            adj = adj.detach().cpu().numpy()
        iu, ju = np.nonzero(np.triu(np.asarray(adj), k=1))
        return [(int(a), int(b)) for a, b in zip(iu, ju)]


def edges_on_device(adj: torch.Tensor) -> list[tuple[int, int]]:
    """:func:`adjacency_to_edges` on the adjacency's device: the same
    list, with the (d, d) adjacency never read.

    One read brings the first d index pairs (``nonzero_static``,
    row-major, padded with -1, no synchronisation before the read). A
    forest, the Boruvka's output, has at most d - 1 edges, so that read
    holds all of them; a filled last row marks a graph with more, whose
    count and pairs ``nonzero`` then reads.
    """
    d = adj.shape[-1]
    upper = torch.triu(adj.detach(), 1)
    pairs = _read_pairs(torch.nonzero_static(upper, size=d, fill_value=-1))
    n = int((pairs[:, 0] >= 0).sum())
    if n == d:
        trace.count("host_reads")  # nonzero's own read of the count
        pairs = _read_pairs(torch.nonzero(upper))
        n = pairs.shape[0]
    return list(zip(*pairs[:n].T.tolist()))


def _read_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """Device (m, 2) indices -> host int32 (indices below d fit)."""
    pairs = pairs.to(torch.int32)
    trace.count("host_reads")
    trace.count("edges_read_bytes", pairs.numel() * pairs.element_size())
    return pairs.cpu()


# --------------------------------------------------------------------------
# Chow-Liu pipelines (paper §3.1): data -> weights -> MWST
# --------------------------------------------------------------------------

def chow_liu(weights, backend: str = "kruskal") -> list[tuple[int, int]]:
    """MWST edges from a pairwise weight matrix."""
    if backend == "kruskal":
        return kruskal_mst(weights)
    if backend == "boruvka":
        return adjacency_to_edges(boruvka_mst(weights))
    raise ValueError(f"unknown backend {backend!r}")


def learn_structure_jit(x, strategy: Strategy = Strategy(), engine=None, *,
                        device=None) -> torch.Tensor:
    """End-to-end Chow-Liu that stays on the device: (n, d) samples ->
    (d, d) bool Boruvka adjacency. The name follows ``repro``; there is
    no jit in the port."""
    x = as_tensor(x, resolve_device(device, x), torch.float32)
    return boruvka_mst(estimators.strategy_weights(x, strategy,
                                                   engine=engine))


def learn_structure(
    x,
    method: str = "sign",
    rate: int = 1,
    backend: str = "kruskal",
    engine=None,
    strategy: Strategy | None = None,
    *,
    device=None,
) -> list[tuple[int, int]]:
    """End-to-end centralized Chow-Liu on (n, d) data; returns edge list.

    Takes a :class:`~repro_torch.core.strategy.Strategy` (preferred) or
    the loose kwargs ``method`` ('sign' | 'persymbol' | 'original'),
    ``rate`` and ``backend`` (the MWST: 'kruskal' | 'boruvka'). ``x`` is
    an f32 tensor (its device decides) or a host array (sent to
    ``device``, default cuda). ``engine`` pins the Gram backend.
    """
    if strategy is None:
        strategy = as_strategy(
            None, method=method,
            rate=max(rate, 1) if method == "persymbol" else 1,
            mst=backend)
    x = as_tensor(x, resolve_device(device, x), torch.float32)
    with trace.span("repro_torch.learn_structure", x.device, n=x.shape[0],
                    d=x.shape[1], strategy=strategy.label):
        w = estimators.strategy_weights(x, strategy, engine=engine)
        if strategy.mst == "boruvka":
            return adjacency_to_edges(boruvka_mst(w))
        return kruskal_mst(w)
