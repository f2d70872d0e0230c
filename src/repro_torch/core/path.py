"""Warm-started regularization paths and model selection for the sparse
plane (the port of ``repro.core.path``).

A :class:`PathPlan` declares a decreasing lambda grid and a selection
rule. :func:`glasso_path_batch` solves the grid over a (b, d, d) batch,
carrying each lane's iterate (theta and its eigendecomposition) from one
lam to the next as a warm start, with the step reset to eta0 at each lam;
each lam's solve stops early at ``conv_tol`` (``glasso._glasso_run``).
Outputs stack with the lam axis leading, as ``repro``'s ``lax.scan``
stacks them.

Selection runs on the device from pieces the solver carries:

* **EBIC** (Foygel & Drton 2010): ``-n*(logdet - tr(S Theta)) +
  |E|*(log n + 4*gamma*log d)`` per trial; argmin over the grid, ties to
  the first (largest) lam.
* **StARS** (Liu, Roeder & Wasserman 2010) across the batch as the
  subsample axis: the integer disagreement ``D = sum_e c_e (B - c_e)``,
  ``xi = 2 D / (B^2 * pairs)``, monotonized by a running max from the
  sparsest lam; the last lam within ``stars_beta`` wins.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device

from . import glasso as _glasso


@dataclasses.dataclass(frozen=True)
class PathPlan:
    """Declarative lambda grid + model-selection rule (frozen, hashable).

    Attributes:
      lams: explicit strictly decreasing grid of positive floats, or None
        to derive a log grid per statistic: ``n_lams`` points from
        ``lam_max = max|S_off|`` down to ``lam_max * lam_min_ratio``.
      n_lams / lam_min_ratio: derived-grid shape (ignored with ``lams``).
      select: ``"ebic"`` (per trial) or ``"stars"`` (per strategy, the
        reps as the subsample batch).
      ebic_gamma: EBIC's extra ``4*gamma*|E|*log d`` (0 = plain BIC).
      stars_beta: StARS instability budget.
      conv_tol: per-lam early-exit threshold of the solver (0.0 = the
        full budget at every lam).
    """

    lams: tuple | None = None
    n_lams: int = 8
    lam_min_ratio: float = 0.1
    select: str = "ebic"
    ebic_gamma: float = 0.5
    stars_beta: float = 0.05
    conv_tol: float = 3e-4

    def __post_init__(self):
        if self.lams is not None:
            object.__setattr__(
                self, "lams", tuple(float(l) for l in self.lams))
            if len(self.lams) < 2:
                raise ValueError("PathPlan.lams needs >= 2 points")
            if any(l <= 0.0 for l in self.lams):
                raise ValueError("PathPlan.lams must be positive")
            if any(b >= a for a, b in zip(self.lams, self.lams[1:])):
                raise ValueError(
                    "PathPlan.lams must be strictly decreasing (warm "
                    f"starts flow large->small lam), got {self.lams}")
        else:
            if self.n_lams < 2:
                raise ValueError("PathPlan.n_lams must be >= 2")
            if not 0.0 < self.lam_min_ratio < 1.0:
                raise ValueError("PathPlan.lam_min_ratio must be in (0, 1)")
        if self.select not in ("ebic", "stars"):
            raise ValueError(f"unknown PathPlan.select {self.select!r}")
        if self.ebic_gamma < 0.0:
            raise ValueError("PathPlan.ebic_gamma must be >= 0")
        if not 0.0 < self.stars_beta < 1.0:
            raise ValueError("PathPlan.stars_beta must be in (0, 1)")
        if self.conv_tol < 0.0:
            raise ValueError("PathPlan.conv_tol must be >= 0")

    @property
    def k(self) -> int:
        """Grid length."""
        return len(self.lams) if self.lams is not None else self.n_lams


class PathSolve(NamedTuple):
    """Per-lam outputs of one path solve, lam axis leading.

    ``logdet``/``tr_s_theta``/``edges`` are the EBIC ingredients;
    ``iters`` the steps each lam's solve spent; ``thetas`` is None unless
    the solve kept the per-lam iterates.
    """

    lams: torch.Tensor        # (K, b) f32 — the grid solved
    support: torch.Tensor     # (K, b, d, d) bool
    logdet: torch.Tensor      # (K, b) f32, sum(log eigvals(theta))
    tr_s_theta: torch.Tensor  # (K, b) f32
    edges: torch.Tensor       # (K, b) int32
    iters: torch.Tensor       # (K, b) int32
    thetas: torch.Tensor | None = None  # (K, b, d, d) when keep_thetas


def path_lambdas(plan: PathPlan, S: torch.Tensor) -> torch.Tensor:
    """A plan's grid against a (..., d, d) statistic batch -> (..., K)
    decreasing lams on S's device. A derived grid starts at
    ``max|S_off|``, floored at 1e-6 so an all-zero pad statistic still
    gives a positive grid."""
    S = torch.as_tensor(S, dtype=torch.float32)
    if plan.lams is not None:
        grid = torch.tensor(plan.lams, dtype=torch.float32, device=S.device)
        return torch.broadcast_to(grid, S.shape[:-2] + grid.shape)
    off = _glasso._off(S.shape[-1], S.device)
    lam_max = torch.where(off, S.abs(), 0.0).amax(dim=(-2, -1))
    lam_max = torch.clamp(lam_max, min=1e-6)
    ratios = torch.as_tensor(
        np.logspace(0.0, np.log10(plan.lam_min_ratio),
                    plan.n_lams).astype(np.float32), device=S.device)
    return lam_max[..., None] * ratios


def _path_scan(S, lam_grid, n_steps, step_scale, eps, conv_tol, support_tol,
               active, keep_thetas):
    """One slab's warm-started grid scan: (b, d, d), (b, K) -> the per-lam
    outputs, each stacked with the lam axis leading."""
    S = _glasso._symmetrize(S)
    b, d = S.shape[0], S.shape[-1]
    off = _glasso._off(d, S.device)
    zero = torch.zeros(b, dtype=torch.float32, device=S.device)
    theta, w, v, eta0, _ = _glasso._carry_init(S, zero, step_scale, eps)
    outs = []
    for i in range(lam_grid.shape[-1]):
        lam = lam_grid[:, i].contiguous()
        obj = _glasso._objective(w, theta, S, lam, off)
        theta, w, v, iters = _glasso._glasso_run(
            theta, w, v, eta0, obj, S, lam, n_steps, eps, conv_tol, active)
        sup = _glasso.support_from_theta(theta, support_tol)
        out = (sup, _glasso._lane_sum(torch.log(w), 1),
               _glasso._lane_sum(S * theta, 2),
               sup.sum(dim=(-2, -1), dtype=torch.int32) // 2, iters)
        outs.append(out + ((theta,) if keep_thetas else ()))
    return tuple(torch.stack(o) for o in zip(*outs))


def glasso_path_batch(S, lams, *, n_steps: int = _glasso.DEFAULT_STEPS,
                      step_scale: float = 0.9, eps: float = 1e-4,
                      conv_tol: float = 3e-4,
                      support_tol: float = _glasso.SUPPORT_TOL,
                      chunk: int | None = None, keep_thetas: bool = False,
                      device=None) -> PathSolve:
    """Warm-started glasso across a decreasing lambda grid, batched.

    Args:
      S: (b, d, d) statistics, or one (d, d) matrix (kept as b = 1).
      lams: (K,) shared grid or (b, K) per-lane grids, decreasing in K.
      conv_tol: per-lam early exit (``glasso._glasso_run``).
      chunk: run the batch in ``chunk``-lane slabs; pad lanes are
        inactive, and the outputs equal the whole batch's bit for bit.
      keep_thetas: also return the (K, b, d, d) per-lam iterates.
    """
    S = as_tensor(S, resolve_device(device, S), torch.float32)
    if S.ndim == 2:
        S = S[None]
    b = S.shape[0]
    lams = torch.as_tensor(lams, dtype=torch.float32, device=S.device)
    lams = torch.broadcast_to(lams, (b, lams.shape[-1])).contiguous()
    K = lams.shape[-1]
    args = (n_steps, step_scale, eps, conv_tol, support_tol)
    if chunk is None or chunk >= b:
        outs = _path_scan(S, lams, *args, None, keep_thetas)
    else:
        # pad lanes get a valid decreasing positive grid; they stay inert
        slabs = _glasso._in_slabs(
            lambda s, l, a: _path_scan(s, l, *args, a, keep_thetas), S, lams,
            np.logspace(0.0, -1.0, K).astype(np.float32), chunk)
        outs = tuple(torch.cat(o, dim=1)[:, :b] for o in zip(*slabs))
    sup, logdet, tr_s_theta, edges, iters = outs[:5]
    return PathSolve(lams.transpose(0, 1), sup, logdet, tr_s_theta, edges,
                     iters, outs[5] if keep_thetas else None)


def ebic_scores(logdet, tr_s_theta, edges, n, d: int,
                gamma: float) -> torch.Tensor:
    """EBIC per (lam, element): ``-n*(logdet - tr) + |E|*(log n +
    4*gamma*log d)`` in f32."""
    logdet = torch.as_tensor(logdet)
    dev = logdet.device
    n = torch.as_tensor(n, dtype=torch.float32, device=dev)
    e = torch.as_tensor(edges, device=dev).to(torch.float32)
    tr = torch.as_tensor(tr_s_theta, device=dev)
    log_d = torch.log(torch.tensor(d, dtype=torch.float32, device=dev))
    return -n * (logdet - tr) + e * (torch.log(n) + 4.0 * gamma * log_d)


def select_ebic(scores: torch.Tensor) -> torch.Tensor:
    """Argmin over the leading lam axis (ties -> first = largest lam)."""
    return torch.argmin(scores, dim=0).to(torch.int32)


def stars_instability(support: torch.Tensor) -> torch.Tensor:
    """StARS edge instability per lam from a (K, B, d, d) support stack:
    per-edge counts c over the B subsamples, the integer disagreement
    ``D = sum_e c*(B-c)``, and ``xi = 2*D / (B^2 * pairs)`` in f32."""
    support = torch.as_tensor(support)
    B, d = support.shape[1], support.shape[-1]
    off = _glasso._off(d, support.device)
    c = support.to(torch.int32).sum(dim=1)
    disagree = torch.where(off, c * (B - c), 0).sum(dim=(-2, -1)) // 2
    denom = torch.tensor(B * B * (d * (d - 1) // 2), dtype=torch.float32,
                         device=support.device)
    return 2.0 * disagree.to(torch.float32) / denom


def select_stars(xi: torch.Tensor, beta: float) -> torch.Tensor:
    """StARS selection over a decreasing-lam instability curve: the last
    index whose running max from the sparsest end stays within ``beta``
    (index 0 when even the sparsest lam is unstable)."""
    mono = torch.cummax(torch.as_tensor(xi), dim=0).values
    ok = (mono <= beta).to(torch.int32)
    return torch.clamp(ok.sum(dim=0) - 1, min=0).to(torch.int32)


def path_select(solve: PathSolve, plan: PathPlan, n, d: int) -> torch.Tensor:
    """Selected-lam index per batch element, by the plan's rule (StARS
    treats the batch as its subsample axis: one index, broadcast)."""
    if plan.select == "ebic":
        return select_ebic(ebic_scores(
            solve.logdet, solve.tr_s_theta, solve.edges, n, d,
            plan.ebic_gamma))
    idx = select_stars(stars_instability(solve.support), plan.stars_beta)
    return torch.broadcast_to(idx, solve.logdet.shape[1:]).to(torch.int32)


#: EBIC scores of two picks within this relative distance are a tie
SCORE_RTOL = 1e-4


def parting_faults(est, ref_theta, tol: float = _glasso.SUPPORT_TOL, *,
                   picks=None, ref_picks=None, ref_scores=None):
    """Whether two solvers' results at one sweep point part only where two
    f32 solvers may -> ``(support entries parted, faults)``; no faults
    means the difference is explained.

    ``est`` holds the candidate's supports, (r, d, d) of a fixed-lam solve
    or (K, r, d, d) of a path, ``ref_theta`` the reference's precision
    estimates of the same shape. For a path, ``picks`` / ``ref_picks``
    are the two (r,) selected indices and ``ref_scores`` the reference's
    (K, r) EBIC scores (``None`` under StARS). Faults: an entry that parts
    although the reference's partial correlation lies farther than
    ``glasso.THRESHOLD_BAND`` from ``tol``; an EBIC pick that differs on a
    trial whose supports agree at every lam, unless the reference scores
    of the two picks tie within :data:`SCORE_RTOL`; a StARS pick that
    differs with every support equal; and nothing parted and no pick tied
    at all, which leaves a metric difference unexplained."""
    def host(a):
        return a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))

    est, ref = host(est), host(ref_theta).to(torch.float32)
    parted = est != _glasso.support_from_theta(ref, tol)
    diff, ties, faults = int(parted.sum()), 0, []
    far = _glasso.far_mismatches(est, ref, tol)
    if far:
        faults.append(f"{far} support entries part away from the threshold")
    if picks is not None:
        picks, ref_picks = np.asarray(picks), np.asarray(ref_picks)
        moved = parted.flatten(-2).any(-1).any(0).numpy()          # (r,)
        for t in np.flatnonzero(picks != ref_picks):
            if ref_scores is None:
                if not moved.any():
                    faults.append(f"StARS picks {picks[t]} vs {ref_picks[t]}"
                                  " with every support equal")
                break
            if moved[t]:
                continue
            a = float(ref_scores[picks[t], t])
            b = float(ref_scores[ref_picks[t], t])
            if abs(a - b) <= SCORE_RTOL * max(abs(a), abs(b)):
                ties += 1
            else:
                faults.append(f"trial {t}: EBIC picks {picks[t]} vs "
                              f"{ref_picks[t]} (scores {a}, {b}) with its "
                              "supports equal")
    if diff == 0 and ties == 0:
        faults.append("the results differ but no support entry parted")
    return diff, faults


def glasso_path_select(S, plan: PathPlan, n, *,
                       n_steps: int = _glasso.DEFAULT_STEPS,
                       step_scale: float = 0.9, eps: float = 1e-4,
                       support_tol: float = _glasso.SUPPORT_TOL,
                       chunk: int | None = None, device=None):
    """Path solve + selection: (b, d, d) or (d, d) statistics ->
    ``(theta_selected, idx, solve)``; ``n`` is the sample count behind S
    (EBIC's likelihood scale)."""
    S = as_tensor(S, resolve_device(device, S), torch.float32)
    single = S.ndim == 2
    Sb = S[None] if single else S
    solve = glasso_path_batch(
        Sb, path_lambdas(plan, Sb), n_steps=n_steps, step_scale=step_scale,
        eps=eps, conv_tol=plan.conv_tol, support_tol=support_tol,
        chunk=chunk, keep_thetas=True)
    idx = path_select(solve, plan, n, Sb.shape[-1])
    theta = torch.take_along_dim(
        solve.thetas, idx.long()[None, :, None, None], dim=0)[0]
    if single:
        return theta[0], idx[0], solve
    return theta, idx, solve
