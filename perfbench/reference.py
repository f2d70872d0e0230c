"""Plain reference of the benchmark's cells, in PyTorch and NumPy.

It works out again, from the benchmark's own inputs, what the program
derives: the sign and per-symbol payloads (the codebook from the normal
quantiles), the Gram in f64, the Chow-Liu weights (paper eqs. 1, 4, 30),
the maximum spanning tree's weight (Prim), the sweep's samples from the
plan's keys (``threefry``) and its per-point error rate and edit distance.
It imports nothing of the program and nothing of JAX.

``precision`` selects the arithmetic: ``REFERENCE`` (f64 Gram and
weights), or one of the controls a step below what the configuration
states: ``TF32`` (f32 products of operands rounded to TF32's 10-bit
mantissa, f32 sums; the sampler's mixing too) and ``BF16`` (the weights
in bfloat16). TF32 is emulated by rounding the operands, so the control
reads the same on the card and on the CPU.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from . import gen, threefry

REFERENCE, TF32, BF16 = "reference", "tf32", "bf16"
TINY = torch.finfo(torch.float32).tiny
#: elements of one block of decoded operand (1 GiB in f64)
BLOCK = 1 << 27
#: elements (trials x rows x d) of one block of the sweep's row normals
ROW_KEYED_BLOCK = 1 << 24
#: the weights' clamps as the configuration states them, in f32: rho^2
#: and theta stay below 1 - 1e-7 (and theta above 1e-7)
NEAR_ONE = float(np.float32(1.0 - 1e-7))
NEAR_ZERO = float(np.float32(1e-7))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to nearest-even at TF32's 10 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals read as zero, as the machines' encoders read them."""
    return torch.where(x.abs() < TINY, torch.zeros_like(x), x)


def sign_payload(x: torch.Tensor) -> torch.Tensor:
    """The sign method's wire: +1 for x >= 0 (0 and subnormals too), else
    -1, as int8."""
    return torch.where(_flush(x) >= 0, 1, -1).to(torch.int8)


def codebook(rate: int) -> tuple[list[float], list[float]]:
    """(interior boundaries, centroids) of the R-bit equiprobable-bin
    quantizer of N(0, 1) (paper §5, eq. 40 with its sign corrected), in
    f64: a_i = Phi^-1(i / 2^R), c_i = 2^R (phi(a_i) - phi(a_{i+1}))."""
    m = 1 << rate
    nd = statistics.NormalDist()
    a = [nd.inv_cdf(i / m) for i in range(1, m)]
    phi = [0.0] + [math.exp(-v * v / 2) / math.sqrt(2 * math.pi)
                   for v in a] + [0.0]
    return a, [m * (phi[i] - phi[i + 1]) for i in range(m)]


def code_payload(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Bin codes in [0, 2^R) as int8: the number of f32 boundaries
    strictly below x."""
    a, _ = codebook(rate)
    bounds = torch.tensor(a, dtype=torch.float32, device=x.device)
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty(flat.shape, dtype=torch.int8, device=x.device)
    step = max(1, BLOCK // flat.shape[-1])
    for r0 in range(0, flat.shape[0], step):
        out[r0:r0 + step] = torch.bucketize(
            _flush(flat[r0:r0 + step]), bounds, out_int32=True)
    return out.view(x.shape)


def payload(x: torch.Tensor, method: str, rate: int = 1) -> torch.Tensor:
    if method == "sign":
        return sign_payload(x)
    if method == "persymbol":
        return code_payload(x, rate)
    return x


# ---------------------------------------------------------------------------
# Gram and weights
# ---------------------------------------------------------------------------

def _decode(blk: torch.Tensor, method: str, rate: int, dtype) -> torch.Tensor:
    if method == "persymbol":
        # the codebook as the wire states it, in f32
        _, c = codebook(rate)
        table = torch.tensor(c, dtype=torch.float32,
                             device=blk.device).to(dtype)
        return table[blk.long()]
    return blk.to(dtype)


def gram(p: torch.Tensor, method: str, rate: int = 1,
         precision: str = REFERENCE) -> torch.Tensor:
    """(..., n, d) payload -> (..., d, d) Gram of the decoded values, f64
    (f32 under TF32), summed over blocks of rows."""
    *lead, n, d = p.shape
    lead_count = math.prod(lead)
    tf32 = precision == TF32
    dtype = torch.float32 if tf32 else torch.float64
    G = torch.zeros((*lead, d, d), dtype=dtype, device=p.device)
    step = max(1, BLOCK // max(1, lead_count * d))
    with gen.Highest():
        for r0 in range(0, n, step):
            v = _decode(p[..., r0:r0 + step, :], method, rate, dtype)
            if tf32:
                v = tf32_round(v)
            G += v.transpose(-1, -2) @ v
    return G


def weights(G: torch.Tensor, n: int, method: str,
            precision: str = REFERENCE) -> torch.Tensor:
    """Chow-Liu weights from a Gram over n samples: the sign method's
    I(u_j; u_k) = 1 - h(1/2 + |G|/2n) (eqs. 4, 8), the per-symbol method's
    -1/2 ln(1 - rho^2) with the unbiased rho^2 (eqs. 30, 32), the
    original's -1/2 ln(1 - rho^2) (eq. 1). f64, or bf16 under BF16, f32
    under TF32. The diagonal is 0."""
    dtype = {REFERENCE: torch.float64, TF32: torch.float32,
             BF16: torch.bfloat16}[precision]
    g = G.to(dtype)
    if method == "sign":
        p = torch.clamp(0.5 + g.abs() / (2.0 * n), NEAR_ZERO, NEAR_ONE)
        q = 1.0 - p
        w = 1.0 + p * torch.log2(p) + q * torch.log2(q)
    else:
        rb = g / n
        r2 = torch.square(rb)
        if method == "persymbol":
            r2 = (n / (n + 1.0)) * (r2 - 1.0 / n)
        w = -0.5 * torch.log1p(-torch.clamp(r2, 0.0, NEAR_ONE))
    eye = torch.eye(w.shape[-1], dtype=torch.bool, device=w.device)
    return w.masked_fill(eye, 0.0)


def weights_gap(w: torch.Tensor, w_ref: torch.Tensor) -> float:
    """max over off-diagonal entries of |w - w_ref|, over the largest
    |w_ref| there."""
    eye = torch.eye(w.shape[-1], dtype=torch.bool, device=w.device)
    diff = (w.double() - w_ref.double()).abs().masked_fill(eye, 0.0).amax()
    den = w_ref.double().abs().masked_fill(eye, 0.0).amax()
    return float(diff / den)


def stat_gap(w: torch.Tensor, w_ref: torch.Tensor, method: str) -> float:
    """The gap of the statistic the weights are a monotone function of:
    for the sign method the weights themselves (:func:`weights_gap`); for
    the per-symbol and original methods the rho^2 estimate, both sides
    mapped back through eq. 1's inverse rho^2 = 1 - exp(-2 w) in f64. Near
    |rho| = 1 the weight magnifies the Gram's rounding without bound; the
    rho^2 it came from does not."""
    if method == "sign":
        return weights_gap(w, w_ref)
    eye = torch.eye(w.shape[-1], dtype=torch.bool, device=w.device)
    r2 = -torch.expm1(-2.0 * w.double())
    r2_ref = -torch.expm1(-2.0 * w_ref.double())
    return float((r2 - r2_ref).abs().masked_fill(eye, 0.0).amax())


# ---------------------------------------------------------------------------
# Spanning trees
# ---------------------------------------------------------------------------

def max_spanning_tree(w: torch.Tensor):
    """Prim over (b, d, d) symmetric weights in f64: ((b,) the largest
    spanning tree's weight, (b, d, d) bool adjacency of one such tree)."""
    w = w.double().clone()
    b, d = w.shape[0], w.shape[-1]
    w.diagonal(dim1=-2, dim2=-1).fill_(-math.inf)
    ar = torch.arange(b, device=w.device)
    in_tree = torch.zeros((b, d), dtype=torch.bool, device=w.device)
    in_tree[:, 0] = True
    best = w[:, 0].clone()
    src = torch.zeros((b, d), dtype=torch.long, device=w.device)
    total = torch.zeros(b, dtype=torch.float64, device=w.device)
    adj = torch.zeros((b, d, d), dtype=torch.bool, device=w.device)
    for _ in range(d - 1):
        cand = best.masked_fill(in_tree, -math.inf)
        v = cand.argmax(dim=1)
        total += cand[ar, v]
        u = src[ar, v]
        adj[ar, u, v] = True
        adj[ar, v, u] = True
        in_tree[ar, v] = True
        row = w[ar, v]
        up = row > best
        best = torch.where(up, row, best)
        src = torch.where(up, v[:, None], src)
    return total, adj


def spanning(adj: torch.Tensor) -> torch.Tensor:
    """(b,) whether each symmetric (d, d) bool adjacency is a spanning
    tree: d - 1 edges, no loop, every node reached from node 0."""
    b, d = adj.shape[0], adj.shape[-1]
    eye = torch.eye(d, dtype=torch.bool, device=adj.device)
    ok = ((adj.sum(dim=(-2, -1)) == 2 * (d - 1))
          & ~(adj & eye).flatten(1).any(dim=1)
          & (adj == adj.transpose(-1, -2)).flatten(1).all(dim=1))
    reach = []
    for i in range(0, b, 32):
        r = (adj[i:i + 32] | eye).float()
        with gen.Highest():
            for _ in range(max(1, math.ceil(math.log2(d)))):
                r = ((r @ r) > 0).float()
        reach.append((r[:, 0] > 0).all(dim=-1))
    return ok & torch.cat(reach)


def tree_gaps(adj: torch.Tensor, w_ref: torch.Tensor) -> torch.Tensor:
    """(b,) relative gap between the largest spanning tree's weight and
    the weight of ``adj`` under the reference weights; 1 where ``adj`` is
    no spanning tree."""
    best, _ = max_spanning_tree(w_ref)
    w = w_ref.double()
    got = w.masked_fill(~adj, 0.0).sum(dim=(-2, -1)) / 2
    gap = ((best - got) / best.abs()).abs()
    return torch.where(spanning(adj), gap, torch.ones_like(gap))


def edges_adjacency(edges, d: int, device) -> torch.Tensor:
    """(d, d) bool adjacency of an edge list."""
    adj = torch.zeros((d, d), dtype=torch.bool, device=device)
    if len(edges):
        e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=device)
        adj[e[:, 0], e[:, 1]] = True
        adj[e[:, 1], e[:, 0]] = True
    return adj


# ---------------------------------------------------------------------------
# The sweep: samples from the plan's keys, truth, metrics
# ---------------------------------------------------------------------------

def mixer(parents: torch.Tensor, rhos: torch.Tensor) -> torch.Tensor:
    """(t, d, d) f64 path-product matrices by the recursion
    x_i = rho_i x_parent(i) + c_i z_i over the topological order."""
    t, d = parents.shape
    rhos = rhos.double()
    M = torch.zeros((t, d, d), dtype=torch.float64, device=rhos.device)
    M[:, 0, 0] = 1.0
    ar = torch.arange(t, device=rhos.device)
    par = parents.long()
    for i in range(1, d):
        M[:, i] = rhos[:, i, None] * M[ar, par[:, i]]
        M[:, i, i] = 1.0
    return M


def sweep_samples(seed0: int, reps: int, n: int, parents, rhos,
                  precision: str = REFERENCE) -> torch.Tensor:
    """(reps, n, d) f32 samples of a plan's trials: row i of trial k from
    the normals of fold_in(fold_in(key(seed0), k), i), mixed by the tree
    in f64 (under TF32: TF32-rounded operands, f32 sums)."""
    parents = torch.as_tensor(parents)
    rhos32 = torch.as_tensor(rhos, dtype=torch.float32)
    dev = rhos32.device
    d = rhos32.shape[-1]
    keys = threefry.fold_in(threefry.key(seed0, device=dev),
                            torch.arange(reps, device=dev))
    M = mixer(parents, rhos32)
    c = torch.sqrt(torch.clamp(1.0 - torch.square(rhos32.double()), min=0.0))
    c[:, 0] = 1.0
    if precision == TF32:
        mt = tf32_round(M.float().transpose(-1, -2).contiguous())
        c = c.float()
    else:
        mt = M.transpose(-1, -2)
    x = torch.empty((reps, n, d), dtype=torch.float32, device=dev)
    step = max(1, ROW_KEYED_BLOCK // max(1, reps * d))
    with gen.Highest():
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            rows = torch.arange(r0, r1, device=dev)
            z = threefry.normal(threefry.fold_in(keys[:, None, :],
                                                 rows[None, :]), (d,))
            if precision == TF32:
                x[:, r0:r1] = tf32_round(z * c[:, None, :]) @ mt
            else:
                x[:, r0:r1] = ((z.double() * c[:, None, :]) @ mt).float()
    return x


def truth_adjacency(parents: torch.Tensor) -> torch.Tensor:
    """(t, d) topological parents -> (t, d, d) bool tree adjacency."""
    t, d = parents.shape
    adj = torch.zeros((t, d, d), dtype=torch.bool, device=parents.device)
    ar = torch.arange(t, device=parents.device)[:, None]
    node = torch.arange(1, d, device=parents.device)[None, :].expand(t, -1)
    par = parents[:, 1:].long()
    adj[ar, node, par] = True
    adj[ar, par, node] = True
    return adj


def sweep_weights(x: torch.Tensor, strategies, n: int,
                  precision: str = REFERENCE) -> torch.Tensor:
    """(S, t, d, d) weights of every strategy ({"method", "rate"}) from
    the (t, n, d) samples."""
    out = []
    for s in strategies:
        method, rate = s["method"], s.get("rate", 1)
        G = gram(payload(x, method, rate), method, rate,
                 TF32 if precision == TF32 else REFERENCE)
        out.append(weights(G, n, method,
                           TF32 if precision == TF32 else REFERENCE))
    return torch.stack(out)


def point_metrics(adj: torch.Tensor, truth: torch.Tensor) -> np.ndarray:
    """(S, t, d, d) estimated trees + (t, d, d) truth -> (S, 2) f32 means
    over the trials of [error indicator, edge symmetric difference]."""
    diff = adj != truth[None]
    err = diff.flatten(2).any(dim=-1).sum(dim=1)
    ham = diff.sum(dim=(-2, -1)).div(2, rounding_mode="floor").sum(dim=1)
    sums = torch.stack([err, ham], dim=-1).cpu().numpy().astype(np.float32)
    return sums / np.float32(adj.shape[1])


def trial_truth(d: int, reps: int, seed0: int, rho_min: float,
                rho_max: float, device):
    """(parents, rhos) of a plan's trials on ``device``."""
    parents, rhos = gen.trial_trees(d, reps, seed0, rho_min, rho_max)
    return (torch.from_numpy(parents).to(device),
            torch.from_numpy(rhos).to(device))
