"""Graphical lasso over (quantized) data — the paper's §7 extension (the
port of ``repro.core.glasso``).

    minimize_Theta  -logdet(Theta) + tr(S Theta) + lambda * ||Theta||_1,off

solved by proximal gradient (ISTA) with a monotone step guard: each step
evaluates the candidate's objective and halves the step instead of
accepting an increase. Every function takes a (b, d, d) batch of
statistics and runs one masked step loop over all of it: lane i freezes
once it converges (or from the start, for a pad lane), exactly as
``repro``'s vmapped ``while_loop`` freezes it, so stopping early equals
running to any larger budget, bit for bit.

On a card each step's ``torch.linalg.eigh`` checks its solver's status
on the host, so every step makes a device->host copy. A solve that can
stop early (``conv_tol > 0``) therefore also reads an all-lanes-done flag
every :data:`POLL_EVERY` steps; one with ``conv_tol == 0`` (the fixed-penalty
trial plane) runs its whole budget and never polls.

The iterate travels as (theta, w, v) with theta == (v * w) @ v.T: the
gradient's Theta^-1 is ``(v / w) @ v.T``, not an LU inverse, so a lane's
iterates do not depend on the other lanes of its batch and
``chunk``-slabbed solves equal the whole batch (on a card the per-lane
sums are fixed trees of adds too, :func:`_lane_sum`). Support recovery
thresholds the normalized partial correlations
|Theta_jk| / sqrt(Theta_jj * Theta_kk).

Agreement with ``repro``: f32 sums in another order move the iterates by
~1e-6 in the first steps, and the monotone guard's accept/reject choices
on a plateau then settle each solver at its own point within ~1e-2 of
the other (``ROADMAP.md`` §3). Supports agree except at entries whose
partial correlation lies that close to the threshold.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device

#: default ISTA iteration budget shared by every glasso entry point
DEFAULT_STEPS = 500

#: default partial-correlation support threshold shared by every entry
#: point that recovers a support (``TrialPlan.glasso_tol``,
#: ``experiments.learned_adjacency``, :func:`learn_sparse_structure`)
SUPPORT_TOL = 0.05

#: steps between two reads of the all-lanes-done flag of a solve that can
#: stop early (every step already waits for the host in ``eigh``)
POLL_EVERY = 4


def _off(d: int, device) -> torch.Tensor:
    return ~torch.eye(d, dtype=torch.bool, device=device)


def _symmetrize(S: torch.Tensor) -> torch.Tensor:
    return (S + S.transpose(-1, -2)) / 2.0


def soft_threshold(x: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def nearest_correlation(S: torch.Tensor, *, eps: float = 1e-4) -> torch.Tensor:
    """Project a symmetric matrix to a nearby valid correlation matrix:
    eigen-clip to eigenvalues >= ``eps``, then renormalize the diagonal to
    1. Batched over leading axes. The repair path exists for the sign
    method's arcsine-inverted statistic, which can be indefinite at small
    n."""
    S = _symmetrize(torch.as_tensor(S, dtype=torch.float32))
    w, v = torch.linalg.eigh(S)
    w = torch.clamp(w, min=eps)
    S = torch.einsum("...ij,...j,...kj->...ik", v, w, v)
    dinv = 1.0 / torch.sqrt(torch.diagonal(S, dim1=-2, dim2=-1))
    return _symmetrize(S * dinv[..., :, None] * dinv[..., None, :])


def _compose(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(v * w) @ v.T over the batch."""
    return (v * w[..., None, :]) @ v.transpose(-1, -2)


def _tree_sum(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Sum over the last ``dims`` axes as a fixed pairwise tree of
    elementwise adds (zero-padded to a power of two): each lane's sum is
    the same whatever else its batch holds."""
    x = x.reshape(*x.shape[:x.dim() - dims], -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _lane_sum(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Sum over the last ``dims`` axes of each lane of a batch. CUDA's
    reduction kernels choose their order from the whole tensor's shape,
    so a lane's sum (and through the monotone guard, its iterates) would
    depend on how many lanes share its batch: on a card the sum is
    :func:`_tree_sum`. The CPU's reductions sum each lane alone."""
    if x.device.type == "cuda":
        return _tree_sum(x, dims)
    return x.sum(dim=tuple(range(-dims, 0)))


def _objective(w_theta, theta, S, lam, off):
    """(b,) -logdet + tr(S Theta) + lam*||Theta||_1,off from the iterate's
    eigenvalues (already floored, so the logdet is finite)."""
    return (-_lane_sum(torch.log(w_theta), 1)
            + _lane_sum(S * theta, 2)
            + lam * _lane_sum(torch.where(off, theta.abs(), 0.0), 2))


def _carry_init(S: torch.Tensor, lam: torch.Tensor, step_scale: float,
                eps: float):
    """The ISTA start point of each lane of a (b, d, d) batch:
    Theta0 = inv(S + 0.5 I) through the (floored) eigendecomposition, and
    the step guess eta0 = step_scale / ||S + I||_2^2 (per lane; it depends
    only on S, so the path scan reuses it for every lam). ||S + I||_2 is
    the largest |eigenvalue| of S + I, taken from the eigenvalues of
    S + 0.5 I already in hand."""
    d = S.shape[-1]
    off = _off(d, S.device)
    ws, v0 = torch.linalg.eigh(
        S + 0.5 * torch.eye(d, dtype=S.dtype, device=S.device))
    w0 = torch.clamp(1.0 / torch.clamp(ws, min=eps), min=eps)
    theta0 = _compose(v0, w0)
    norm = (ws + 0.5).abs().amax(dim=-1)
    eta0 = step_scale * (1.0 / norm) ** 2
    obj0 = _objective(w0, theta0, S, lam, off)
    return theta0, w0, v0, eta0, obj0


def _glasso_run(theta, w, v, eta, obj, S, lam, n_steps: int, eps: float,
                conv_tol: float = 0.0, active=None):
    """Masked monotone-ISTA run of a (b, d, d) batch from (theta, w, v).

    A lane stops once an ACCEPTED step moved theta by at most
    ``conv_tol`` (max-abs); ``conv_tol=0.0`` never converges and runs the
    fixed budget. ``active=False`` marks a pad lane done before step 0.
    A done lane's carry is frozen. With ``conv_tol > 0`` the loop reads
    the all-done flag every :data:`POLL_EVERY` steps and stops when it is set:
    the frozen lanes make that equal to the full budget, bit for bit.

    Returns ``(theta, w, v, iters)``, ``iters`` the (b,) int32 steps each
    lane spent (pads report 0).
    """
    b, d = S.shape[0], S.shape[-1]
    off = _off(d, S.device)
    done = (torch.zeros(b, dtype=torch.bool, device=S.device)
            if active is None else ~active)
    it = torch.zeros(b, dtype=torch.int32, device=S.device)
    lam3 = lam[:, None, None]
    for step in range(n_steps):
        g = S - (v / w[..., None, :]) @ v.transpose(-1, -2)
        z = theta - eta[:, None, None] * g
        z = torch.where(off, soft_threshold(z, eta[:, None, None] * lam3), z)
        z = (z + z.transpose(-1, -2)) / 2.0
        # PSD projection with an eigenvalue floor (keeps logdet finite)
        wz, vz = torch.linalg.eigh(z)
        wz = torch.clamp(wz, min=eps)
        z = _compose(vz, wz)
        obj_z = _objective(wz, z, S, lam, off)
        # monotone guard: an increase means the step overshot — reject it
        # and halve eta (float-noise slack so a converged iterate passes)
        ok = obj_z <= obj + 1e-6
        upd = ok & ~done
        if conv_tol > 0.0:
            # the candidate against the iterate it replaces, before the
            # selects overwrite theta
            conv = upd & ((z - theta).abs().amax(dim=(-2, -1)) <= conv_tol)
        theta = torch.where(upd[:, None, None], z, theta)
        w = torch.where(upd[:, None], wz, w)
        v = torch.where(upd[:, None, None], vz, v)
        obj = torch.where(upd, obj_z, obj)
        eta = torch.where(done | ok, eta, eta / 2.0)
        it = it + (~done).to(torch.int32)
        if conv_tol > 0.0:
            done = done | conv
            if (step + 1) % POLL_EVERY == 0 and bool(done.all()):
                break
    return theta, w, v, it


def _solve(S, lam, n_steps, step_scale, eps, conv_tol, active=None):
    """(b, d, d) monotone ISTA solves from the cold start -> theta."""
    S = _symmetrize(S)
    theta0, w0, v0, eta0, obj0 = _carry_init(S, lam, step_scale, eps)
    theta, _, _, _ = _glasso_run(theta0, w0, v0, eta0, obj0, S, lam,
                                 n_steps, eps, conv_tol, active)
    return theta


def _in_slabs(fn, S: torch.Tensor, lanes: torch.Tensor, lane_pad,
              chunk: int) -> list:
    """``fn(S, lanes, active)`` over ``chunk``-lane slabs of a (b, d, d)
    batch and its per-lane values ``lanes``, padded to a chunk multiple
    with inactive lanes (zero statistics, values ``lane_pad``): the
    slabs' outputs, pads included. A pad lane spends no iterations and
    no real lane sees one."""
    b = S.shape[0]
    chunk = max(1, chunk)
    pad = (-b) % chunk
    S = torch.cat([S, S.new_zeros((pad,) + tuple(S.shape[1:]))])
    lanes = torch.cat([lanes, torch.as_tensor(
        lane_pad, dtype=lanes.dtype, device=lanes.device).expand(
        (pad,) + tuple(lanes.shape[1:]))])
    act = torch.arange(b + pad, device=S.device) < b
    return [fn(S[i:i + chunk], lanes[i:i + chunk], act[i:i + chunk])
            for i in range(0, b + pad, chunk)]


def glasso(S, lam: float, *, n_steps: int = DEFAULT_STEPS,
           step_scale: float = 0.9, eps: float = 1e-4,
           conv_tol: float = 0.0, device=None) -> torch.Tensor:
    """Monotone proximal-gradient graphical lasso of one (d, d) statistic
    -> (d, d) sparse precision estimate. ``conv_tol`` > 0 stops once an
    accepted step moves theta by at most that much (bit-identical to a
    larger budget); 0.0 runs ``n_steps`` exactly."""
    S = as_tensor(S, resolve_device(device, S), torch.float32)
    return glasso_batch(S[None], lam, n_steps=n_steps, step_scale=step_scale,
                        eps=eps, conv_tol=conv_tol)[0]


def glasso_batch(S, lam, *, n_steps: int = DEFAULT_STEPS,
                 step_scale: float = 0.9, eps: float = 1e-4,
                 conv_tol: float = 0.0, chunk: int | None = None,
                 device=None) -> torch.Tensor:
    """Batched glasso: (b, d, d) statistics -> (b, d, d) precision
    estimates in one masked step loop.

    ``lam`` is a scalar or a (b,) vector (the trial plane stacks
    strategies with different penalties into one batch). ``chunk`` runs
    the batch in ``chunk``-lane slabs (the memory-budgeted solve stage):
    the batch pads to a chunk multiple with inactive lanes, which spend no
    iterations, and the result equals the whole batch's bit for bit.
    """
    S = as_tensor(S, resolve_device(device, S), torch.float32)
    lam = torch.broadcast_to(
        torch.as_tensor(lam, dtype=torch.float32, device=S.device),
        S.shape[:-2]).contiguous()
    b = S.shape[0]
    if chunk is None or chunk >= b:
        return _solve(S, lam, n_steps, step_scale, eps, conv_tol)
    slabs = _in_slabs(lambda s, l, a: _solve(s, l, n_steps, step_scale, eps,
                                             conv_tol, a), S, lam, 1.0, chunk)
    return torch.cat(slabs)[:b]


def glasso_objective(theta, S, lam: float) -> torch.Tensor:
    """-logdet(Theta) + tr(S Theta) + lam*||Theta||_1,off — the objective
    the monotone guard enforces (batched over leading axes)."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    S = torch.as_tensor(S, dtype=torch.float32, device=theta.device)
    off = _off(theta.shape[-1], theta.device)
    sign, logdet = torch.linalg.slogdet(theta)
    return (-torch.where(sign > 0, logdet, -torch.inf)
            + (S * theta).sum(dim=(-2, -1))
            + lam * torch.where(off, theta.abs(), 0.0).sum(dim=(-2, -1)))


def partial_correlations(theta: torch.Tensor) -> torch.Tensor:
    """Normalized partial correlations |Theta_jk| / sqrt(Theta_jj Theta_kk)
    (diagonal = 1), batched over leading axes."""
    theta = torch.as_tensor(theta).abs()
    dinv = 1.0 / torch.sqrt(torch.diagonal(theta, dim1=-2, dim2=-1))
    return theta * dinv[..., :, None] * dinv[..., None, :]


def support_from_theta(theta: torch.Tensor,
                       tol: float = SUPPORT_TOL) -> torch.Tensor:
    """Off-diagonal support of a precision estimate, on its device: the
    bool adjacency of partial correlations > ``tol``."""
    p = partial_correlations(theta)
    return (p > tol) & _off(p.shape[-1], p.device)


def support(theta, tol: float = SUPPORT_TOL) -> np.ndarray:
    """Host twin of :func:`support_from_theta` (numpy bool adjacency)."""
    return support_from_theta(torch.as_tensor(theta), tol).cpu().numpy()


#: how far from the support threshold two f32 solvers' partial
#: correlations may part: the plateau each settles on differs by up to
#: ~1.3e-3 (``ROADMAP.md`` §3)
THRESHOLD_BAND = 5e-3


def far_mismatches(est, theta_ref, tol: float = SUPPORT_TOL,
                   band: float = THRESHOLD_BAND) -> int:
    """How many entries of a support estimate ``est`` differ from the
    support of a reference precision ``theta_ref`` although the
    reference's partial correlation lies farther than ``band`` from
    ``tol``. Two solvers that agree up to f32 plateaus give 0: they may
    part only at entries that sit at the threshold."""
    def tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))

    p = partial_correlations(tensor(theta_ref))
    est = tensor(est).to(p.device)
    differ = est != ((p > tol) & _off(p.shape[-1], p.device))
    return int((differ & ((p - tol).abs() > band)).sum())


def learn_sparse_structure(x, lam, *, method: str = "original",
                           rate: int = 4, tol: float = SUPPORT_TOL,
                           n_steps: int = DEFAULT_STEPS,
                           device=None) -> np.ndarray:
    """End-to-end: (n, d) data -> glasso support (numpy bool), through the
    encode -> Gram -> ``corr_from_gram`` chain of ``method``.

    ``lam`` is a float >= 0 (0 = unpenalized MLE), the string ``"path"``
    (a warm-started grid from ``path.PathPlan()``'s defaults, EBIC
    selected), or a ``path.PathPlan`` with EBIC selection (StARS needs a
    subsample batch: use ``TrialPlan(path=...)``). Host data runs on
    ``device`` (default cuda)."""
    from . import estimators
    from .path import PathPlan, glasso_path_select
    from .strategy import Strategy

    if method not in ("original", "sign", "persymbol"):
        raise ValueError(f"unknown method {method!r}")
    if isinstance(lam, str):
        if lam != "path":
            raise ValueError(
                f"lam must be a float, 'path', or a PathPlan; got {lam!r}")
        lam = PathPlan()
    if isinstance(lam, PathPlan):
        if lam.select != "ebic":
            raise ValueError(
                "learn_sparse_structure path selection must be 'ebic' — "
                "StARS needs a subsample batch (use TrialPlan(path=...))")
    elif lam < 0.0:
        raise ValueError(f"lam must be >= 0 (0 = unpenalized MLE), "
                         f"got {lam!r}")
    x = as_tensor(x, resolve_device(device, x), torch.float32)
    # a tree Strategy drives the encode/Gram/estimate stages, which read
    # only method/rate/wire: lam = 0 stays a valid input here
    strat = Strategy(method, rate=rate)
    payload = estimators.strategy_payload(x, strat)
    gram = estimators.payload_gram(payload, strat)
    S = estimators.corr_from_gram(gram, x.shape[0], strat)
    if isinstance(lam, PathPlan):
        theta, _, _ = glasso_path_select(S, lam, x.shape[0], n_steps=n_steps,
                                         support_tol=tol)
    else:
        theta = glasso(S, lam, n_steps=n_steps)
    return support(theta, tol)


def random_sparse_precision(
    d: int, density: float, rng: np.random.Generator,
    strength: tuple[float, float] = (0.25, 0.45),
) -> np.ndarray:
    """Random sparse, diagonally-dominant precision matrix (valid GGM),
    normalized to unit-variance marginals (numpy float64)."""
    theta = np.zeros((d, d))
    iu = np.triu_indices(d, k=1)
    mask = rng.random(len(iu[0])) < density
    vals = rng.uniform(*strength, size=mask.sum()) * rng.choice(
        [-1.0, 1.0], size=mask.sum())
    theta[iu[0][mask], iu[1][mask]] = vals
    theta = theta + theta.T
    # diagonal dominance => PSD
    np.fill_diagonal(theta, np.abs(theta).sum(axis=1) + 1.0)
    # normalize to unit-variance marginals (the paper's Q_jj = 1)
    cov = np.linalg.inv(theta)
    scale = np.sqrt(np.diag(cov))
    cov = cov / scale[:, None] / scale[None, :]
    return np.linalg.inv(cov)
