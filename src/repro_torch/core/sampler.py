"""Sampling from tree-structured GGMs.

The port of ``repro.core.sampler``'s one-shot samplers:

* ``sample_ggm`` — generic: Cholesky of the full correlation matrix.
* ``sample_tree_ggm_parents`` — the tree factorization in topological
  parent-array form: x = (c * z) @ M^T with M the unit lower-triangular
  path-product mixer, so cov(x) is exactly the eq.-24 correlation matrix.
* ``sample_tree_ggm`` — the host-facing wrapper over edge lists, columns
  in the original node labelling.

The normals of these come from an explicit ``torch.Generator`` on the
target device; they are held to ``repro``'s law, not to
``jax.random``'s bits.

The trial plane's row-keyed samplers (``sample_tree_ggm_rows[_batch]``,
``sample_ggm_rows[_batch]``) draw row i of trial k from
``fold_in(keys[k], i)`` with the port's threefry (``core.prng``), so
they draw ``repro``'s normals (within 2 f32 ulps) and the first m rows
of an (n, d) draw are bit-equal to the (m, d) draw. On a card one
kernel draws each block of them (``kernels.row_normals``), bit for bit
the plain ``prng`` composition the CPU runs.

Rows are drawn in blocks so the samples are the only full-size buffer.
The mixing product runs in full f32: no TF32 on the card, which must
agree with the CPU to rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels
from repro_torch._device import resolve_device

from . import prng, trees

#: rows drawn per block of driving normals
_ROW_BLOCK = 1 << 16
#: elements (trials x rows x d) of one block of row-keyed normals: the
#: plain version's threefry words are int64, so its transients are a few
#: of these times 8 bytes; the kernel's are the block's f32 normals
_ROW_KEYED_BLOCK = 1 << 24


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


def sample_tree_ggm_batch(keys: torch.Tensor, n: int, parents,
                          rhos) -> torch.Tensor:
    """Batched trial sampler: one tree GGM per leading index. ``keys``:
    (t, 2) threefry keys (``core.prng``), each drawing its (n, d) normals
    as ``jax.random.normal(key, (n, d))``; ``parents``/``rhos``: (t, d)
    topological arrays. Returns (t, n, d) f32 on the keys' device
    (``repro``'s ``sample_tree_ggm_batch``)."""
    rhos = torch.as_tensor(rhos, dtype=torch.float32, device=keys.device)
    d = rhos.shape[-1]
    M = trees.path_product_mixer(
        torch.as_tensor(parents, device=keys.device), rhos)
    z = prng.normal(keys, (n, d)) * trees._innovation_scale(rhos)[:, None, :]
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32
    try:
        return torch.matmul(z, M.transpose(-1, -2))
    finally:
        torch.set_float32_matmul_precision(precision)


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


# --------------------------------------------------------------------------
# Row-keyed, bucket-stable samplers (the trial plane's data)
# --------------------------------------------------------------------------

def _mixed_rows(keys: torch.Tensor, n: int, mix_t: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """x[k] = (scale[k] * z[k]) @ mix_t[k] with z the row-keyed normals of
    ``keys`` (row i of trial k from ``fold_in(keys[k], i)``: ``repro.core.
    sampler._row_normals``), drawn and mixed in row blocks: (t, n, d)
    f32."""
    t, d = keys.shape[0], mix_t.shape[-1]
    x = torch.empty((t, n, d), dtype=torch.float32, device=keys.device)
    step = max(1, _ROW_KEYED_BLOCK // max(1, t * d))
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32
    try:
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            z = kernels.row_normals(keys, r0, r1, d, scale)
            x[:, r0:r1] = torch.matmul(z, mix_t)
    finally:
        torch.set_float32_matmul_precision(precision)
    return x


def sample_tree_ggm_rows_batch(keys: torch.Tensor, n: int, parents,
                               rhos) -> torch.Tensor:
    """Row-keyed tree-GGM trials: (t, 2) keys + (t, d) topological
    parents/rhos -> (t, n, d) f32 on the keys' device. Row i of trial k
    depends only on (keys[k], i), so bucket padding cannot change a
    trial's draws (``repro``'s ``sample_tree_ggm_rows_batch``)."""
    rhos = torch.as_tensor(rhos, dtype=torch.float32, device=keys.device)
    M = trees.path_product_mixer(
        torch.as_tensor(parents, device=keys.device), rhos)
    return _mixed_rows(keys, n, M.transpose(-1, -2),
                       trees._innovation_scale(rhos))


def sample_tree_ggm_rows(key: torch.Tensor, n: int, parent,
                         rho) -> torch.Tensor:
    """:func:`sample_tree_ggm_rows_batch` of one (2,) key: (n, d)."""
    return sample_tree_ggm_rows_batch(
        key[None], n, torch.as_tensor(parent)[None],
        torch.as_tensor(rho)[None])[0]


def sample_ggm_rows_batch(keys: torch.Tensor, n: int, chols) -> torch.Tensor:
    """Row-keyed generic GGM trials: (t, 2) keys + (t, d, d) Cholesky
    factors L (x = L z) -> (t, n, d) f32, rows stable in n."""
    chols = torch.as_tensor(chols, dtype=torch.float32, device=keys.device)
    return _mixed_rows(keys, n, chols.transpose(-1, -2))


def sample_ggm_rows(key: torch.Tensor, n: int, chol) -> torch.Tensor:
    """:func:`sample_ggm_rows_batch` of one (2,) key: (n, d)."""
    return sample_ggm_rows_batch(key[None], n, torch.as_tensor(chol)[None])[0]
