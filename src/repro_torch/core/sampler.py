"""Sampling from tree-structured GGMs.

The port of ``repro.core.sampler``'s one-shot samplers:

* ``sample_ggm`` — generic: Cholesky of the full correlation matrix.
* ``sample_tree_ggm_parents`` — the tree factorization in topological
  parent-array form: x = (c * z) @ M^T with M the unit lower-triangular
  path-product mixer, so cov(x) is exactly the eq.-24 correlation matrix.
* ``sample_tree_ggm`` — the host-facing wrapper over edge lists, columns
  in the original node labelling.

The normals come from an explicit ``torch.Generator`` on the target
device; the port holds its samplers to ``repro``'s law, not to
``jax.random``'s bits. Rows are drawn in blocks so the (n, d) result is
the only full-size buffer. The row-keyed bucket-stable samplers arrive
with the port's trial plane.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

from . import trees

#: rows drawn per block of driving normals
_ROW_BLOCK = 1 << 16


def bfs_order(d: int, edges: list[tuple[int, int]], root: int = 0):
    """Return (order, parent, parent_weight_index): a BFS node ordering with
    each node's parent and the index of the connecting edge."""
    nbrs: list[list[tuple[int, int]]] = [[] for _ in range(d)]
    for idx, (j, k) in enumerate(edges):
        nbrs[j].append((k, idx))
        nbrs[k].append((j, idx))
    order = [root]
    parent = [-1] * d
    pedge = [-1] * d
    seen = [False] * d
    seen[root] = True
    head = 0
    while head < len(order):
        node = order[head]
        head += 1
        for child, eidx in nbrs[node]:
            if not seen[child]:
                seen[child] = True
                parent[child] = node
                pedge[child] = eidx
                order.append(child)
    return np.array(order), np.array(parent), np.array(pedge)


def _generator_device(generator, device) -> torch.device:
    if generator is not None:
        return generator.device
    return resolve_device(device)


def _mix(generator, n: int, mix_t: torch.Tensor) -> torch.Tensor:
    """x = z @ mix_t for standard normal z, drawn in row blocks."""
    d = mix_t.shape[0]
    x = torch.empty((n, mix_t.shape[1]), dtype=torch.float32,
                    device=mix_t.device)
    for r0 in range(0, n, _ROW_BLOCK):
        r1 = min(n, r0 + _ROW_BLOCK)
        z = torch.randn((r1 - r0, d), generator=generator,
                        dtype=torch.float32, device=mix_t.device)
        torch.matmul(z, mix_t, out=x[r0:r1])
    return x


def sample_tree_ggm_parents(generator, n: int, parent, rho, *,
                            device=None) -> torch.Tensor:
    """Draw ``n`` samples from the tree GGM in parent-array form.

    ``parent``/``rho``: (d,) topological arrays (``parent[t] < t``,
    ``rho[0] = 0``). Returns (n, d) float32 with unit variances on the
    generator's device (or ``device`` when ``generator`` is None).
    """
    dev = _generator_device(generator, device)
    rho = torch.as_tensor(rho, dtype=torch.float32, device=dev)
    M = trees.path_product_mixer(torch.as_tensor(parent, device=dev), rho)
    # (z * c) @ M^T == z @ (c[:, None] * M^T)
    return _mix(generator, n, trees._innovation_scale(rho)[:, None] * M.T)


def sample_tree_ggm(generator, n: int, d: int, edges: list[tuple[int, int]],
                    weights, *, device=None) -> torch.Tensor:
    """Draw ``n`` i.i.d. samples from the tree GGM with unit variances,
    columns in the ORIGINAL node labelling. (n, d) float32.

    The topological-to-original column permutation is folded into the
    mixer's rows, so no permuted copy of the samples is ever made.
    """
    dev = _generator_device(generator, device)
    parent, rho, perm = trees.topological_parents(d, edges, weights)
    rho_t = torch.as_tensor(rho, device=dev)
    M = trees.path_product_mixer(torch.as_tensor(parent, device=dev), rho_t)
    inv = np.empty(d, dtype=np.int64)
    inv[perm] = np.arange(d)
    # x[:, j] = x_topo[:, inv[j]] = sum_k z_k c_k M[inv[j], k]
    mix_t = trees._innovation_scale(rho_t)[:, None] * M[
        torch.as_tensor(inv, device=dev)].T
    return _mix(generator, n, mix_t)


def sample_ggm(generator, n: int, corr, *, device=None) -> torch.Tensor:
    """Generic GGM sampler via Cholesky of the correlation matrix."""
    dev = _generator_device(generator, device)
    d = corr.shape[0]
    chol = np.linalg.cholesky(
        np.asarray(corr, dtype=np.float64) + 1e-12 * np.eye(d))
    return _mix(generator, n,
                torch.as_tensor(chol.T, dtype=torch.float32, device=dev))
