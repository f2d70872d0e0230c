"""GGM sample pipeline: the data plane of the paper's experiments.

The port of ``repro.data.ggm.GGMDataset``: a ground-truth tree + edge
correlations, and i.i.d. sample batches drawn on a device. The vertical
sharding helpers arrive with the port's wire plane.
"""
from __future__ import annotations

import dataclasses

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
