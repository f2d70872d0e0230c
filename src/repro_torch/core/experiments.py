"""Experiment-plane metrics (the port of ``repro.core.experiments``).

Only the structure-metric channels are ported so far: the serving plane
(``repro_torch.serve``) counts per-tenant drift with them. The trial
plane (``TrialPlan``, ``run_trials``) arrives with its own slice.
"""
from __future__ import annotations

import torch

from . import trees


def structure_metric_channels(adj_est: torch.Tensor,
                              adj_ref: torch.Tensor) -> torch.Tensor:
    """(..., d, d) estimated vs reference adjacencies -> (..., 3)
    [error, hamming, shared-edge] channels.

    All three are integer-valued f32 (the error indicator, the edge
    symmetric difference, and |E_hat & E_ref|), so their sums are exact
    in any order. The serving plane takes them against the previous
    solve: hamming is the per-tenant structure-drift counter.
    """
    adj_est = torch.as_tensor(adj_est)
    adj_ref = torch.as_tensor(adj_ref)
    err = trees.structure_error(adj_est, adj_ref).to(torch.float32)
    ham = trees.structure_hamming(adj_est, adj_ref).to(torch.float32)
    shared = (adj_est & adj_ref).sum(dim=(-2, -1)).to(torch.float32) / 2
    return torch.stack([err, ham, shared], dim=-1)
