"""GGM sample pipeline: the data plane of the paper's experiments.

The port of ``repro.data.ggm``: a ground-truth tree + edge correlations,
i.i.d. sample batches drawn on a device, and the vertical partition
(paper §3: machine M_j holds dimension j) over a mesh. ``repro`` places a
batch with a ``NamedSharding``; here every rank samples the batch and
keeps its own block, so rank (data i, model m) holds rows
[i*n/D, (i+1)*n/D) of columns [m*d/M, (m+1)*d/M) — where ``repro``'s
sharding puts them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import sampler, trees


@dataclasses.dataclass(frozen=True)
class GGMDataset:
    d: int
    tree: str = "random"            # random | star | chain | skeleton
    rho_min: float = 0.4
    rho_max: float = 0.9
    seed: int = 0

    def structure(self) -> tuple[list[tuple[int, int]], np.ndarray]:
        """(edges, edge correlations) — the ground truth to recover; the
        same numpy draw as ``repro``'s for the same fields."""
        rng = np.random.default_rng(self.seed)
        if self.tree == "random":
            edges = trees.random_tree(self.d, rng)
        elif self.tree == "star":
            edges = trees.star_tree(self.d)
        elif self.tree == "chain":
            edges = trees.chain_tree(self.d)
        elif self.tree == "skeleton":
            if self.d != 20:
                raise ValueError("skeleton topology is the 20-joint body")
            edges = list(trees.SKELETON_EDGES)
        else:
            raise ValueError(f"unknown tree kind {self.tree!r}")
        w = rng.uniform(self.rho_min, self.rho_max, size=self.d - 1)
        return edges, w

    def sample(self, n: int, batch_seed: int = 0, *, device=None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """(n, d) f32 samples on ``device`` (default cuda; the generator's
        device when one is given). Without a generator, one is seeded from
        (seed, batch_seed), so a batch is reproducible per device."""
        edges, w = self.structure()
        if generator is None:
            dev = resolve_device(device)
            generator = torch.Generator(device=dev)
            state = np.random.SeedSequence([self.seed, batch_seed])
            generator.manual_seed(int(state.generate_state(1, np.uint32)[0]))
        return sampler.sample_tree_ggm(generator, n, self.d, edges, w)


@dataclasses.dataclass(frozen=True)
class VerticalSharding:
    """The paper's storage layout over a mesh: samples over the row axes
    (``"pod"`` and ``data_axis``, the pod axis major), features over
    ``model_axis``. Calling it on the global (n, d) batch returns this
    rank's (n/D, d/M) block, a view."""

    mesh: object
    row_axes: tuple[str, ...]
    model_axis: str | None

    def _index(self, axes: tuple[str, ...]) -> tuple[int, int]:
        """(this rank's block index, block count) over ``axes``, the first
        axis major."""
        idx, count = 0, 1
        for a in axes:
            size = self.mesh.size(self.mesh.mesh_dim_names.index(a))
            idx, count = idx * size + self.mesh.get_local_rank(a), count * size
        return idx, count

    def block(self, n: int, d: int) -> tuple[slice, slice]:
        """(row slice, column slice) of this rank's block of an (n, d)
        batch; both sizes must divide."""
        cols = (self.model_axis,) if self.model_axis else ()
        out = []
        for size, axes, what in ((n, self.row_axes, "samples"),
                                 (d, cols, "features")):
            i, k = self._index(axes)
            if size % k:
                raise ValueError(f"{size} {what} do not split over the "
                                 f"{k}-way {'x'.join(axes)} mesh axes")
            out.append(slice(i * (size // k), (i + 1) * (size // k)))
        return out[0], out[1]

    def __call__(self, x):
        rows, cols = self.block(x.shape[-2], x.shape[-1])
        return x[..., rows, cols]


def vertical_sharding(mesh, data_axis="data", model_axis="model"):
    """Paper's storage layout: samples over the data axis (after ``"pod"``
    where the mesh has one), features over the model axis (unsharded on
    a mesh without it)."""
    names = mesh.mesh_dim_names
    rows = tuple(a for a in ("pod", data_axis) if a in names)
    return VerticalSharding(mesh, rows,
                            model_axis if model_axis in names else None)


def ggm_batches(ds: GGMDataset, n_per_batch: int, mesh=None, start: int = 0,
                *, device=None,
                generator: torch.Generator | None = None
                ) -> Iterator[torch.Tensor]:
    """Endless (n_per_batch, d) batches of ``ds`` (batch seeds ``start``,
    ``start + 1``, ...; ``device`` and ``generator`` as in
    :meth:`GGMDataset.sample`), each cut to this rank's block of
    ``mesh`` (:func:`vertical_sharding`) when one is given."""
    shard = vertical_sharding(mesh) if mesh is not None else None
    step = start
    while True:
        x = ds.sample(n_per_batch, batch_seed=step, device=device,
                      generator=generator)
        yield x if shard is None else shard(x)
        step += 1
