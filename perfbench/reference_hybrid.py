"""Plain reference of a Granite 4.0-H (``granitemoehybrid``) prefill, in
plain torch, from the published description: the Hugging Face
``config.json`` of ibm-granite/granite-4.0-h-small and the layer equations
its ``modeling_granitemoehybrid`` states.

Token embeddings times ``embedding_multiplier``. In each layer x +=
m * mixer(RMSNorm(x)), then x += m * (MoE(h) + shared(h)) with
h = RMSNorm(x) and m = ``residual_multiplier``. The mixer is the layer's
``layer_types`` entry:

* Mamba2 (arXiv:2405.21060): in_proj to [z, x, B, C, dt]; a depthwise
  causal conv of width ``mamba_d_conv`` with a bias over [x, B, C], then
  silu; dt = softplus(dt + dt_bias); A = -exp(A_log); the SSM by the
  paper's minimal chunked SSD (Listing 1, ``ssd_minimal_discrete``) at
  ``mamba_chunk_size`` on x * dt and A * dt; y + D * x; the gated RMSNorm
  RMSNorm(y * silu(z)) over all of d_inner; out_proj.
* attention: GQA (each KV head read by ``num_attention_heads /
  num_key_value_heads`` consecutive query heads) with no positional
  encoding and a causal softmax of q k^T * ``attention_multiplier``, in
  blocks of query rows.
* MoE: router logits x W_r in f32, the top ``num_experts_per_tok`` of
  them, gates their softmax; each expert a loop over its own tokens,
  (silu(x W_g) * (x W_u)) W_d times the token's gate, added in expert
  order; the shared expert the same SwiGLU at
  ``shared_intermediate_size``.

The logits are RMSNorm(x) E^T / ``logits_scaling`` with E the tied
embedding. Departures, each noted: the logits at the requested positions
only (a prefill returns the last one's); no biases (``attention_bias``
and ``mamba_proj_bias`` are false); one group of B and C
(``mamba_n_groups`` 1), so C B^T is computed once a chunk for every head,
where the listing carries B and C per head; Listing 1's steps 1, 2 and 4
run a few chunks at a time, which changes none of its sums; a sequence
that ``mamba_chunk_size`` does not divide takes its largest divisor below
it as the chunk (the listing requires a multiple; the cell's 32,768 is
one); ``time_step_limit`` is (0, inf), so dt is not clamped.

It draws the weights itself from the seed (``hybrid_gen``), in the dtype
the configuration serves them in, upcasts one layer at a time (an expert
at a time) and computes in f32 with TF32 off, except the SSM, which runs
in float64; one row of the batch at a time. It imports nothing of the
program and nothing of JAX.

``precision`` is ``REFERENCE`` or ``FP8``, the control one step below
the configuration's bf16: every matmul's two operands (the projections,
the router, the experts, q.k and p.v, the head) rounded to float8_e4m3fn
at a per-tensor scale, the products summed in f32; the SSM as above.
"""
from __future__ import annotations

import torch

from . import hybrid_gen
from .reference_lm import FP8, REFERENCE, full_f32, matmul, rmsnorm

__all__ = ["FP8", "REFERENCE", "prefill", "ssd_minimal_discrete"]

#: query rows of one attention block
Q_BLOCK = 512
#: chunks of the SSD's steps 1, 2 and 4 at a time
CHUNKS_AT_ONCE = 8
silu = torch.nn.functional.silu


def largest_divisor(n: int, cap: int) -> int:
    return next(c for c in range(min(n, cap), 0, -1) if n % c == 0)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Listing 1's ``segsum``: (..., T) -> (..., T, T), entry (i, j) the
    sum of x[j + 1 .. i] for j <= i and -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    return x.masked_fill(~torch.ones_like(below).tril(), -torch.inf)


def ssd_minimal_discrete(x, a, b, c, block_len: int):
    """Listing 1 for one sequence and one group: x (L, H, P) (the input
    times dt), a (L, H) (A times dt), b and c (L, N) -> (y (L, H, P), the
    final state (H, P, N)), in x's dtype."""
    length, h, p = x.shape
    nc, bl = length // block_len, block_len
    x = x.view(nc, bl, h, p)
    b, c = b.view(nc, bl, -1), c.view(nc, bl, -1)
    a = a.view(nc, bl, h).permute(2, 0, 1)                   # (H, C, L)
    a_cumsum = torch.cumsum(a, dim=-1)
    y = torch.empty_like(x)
    states = []
    for c0 in range(0, nc, CHUNKS_AT_ONCE):
        cs = slice(c0, c0 + CHUNKS_AT_ONCE)
        # 1. the output within each chunk (the diagonal blocks)
        decay = torch.exp(segsum(a[:, cs]))                  # (H, C, L, S)
        cb = torch.einsum("cln,csn->cls", c[cs], b[cs])
        y[cs] = torch.einsum("hcls,cshp->clhp", cb[None] * decay, x[cs])
        # 2. each chunk's state from its own inputs
        decay_states = torch.exp(a_cumsum[:, cs, -1:] - a_cumsum[:, cs])
        states.append(torch.einsum("cln,hcl,clhp->chpn", b[cs],
                                   decay_states, x[cs]))
    # 3. the states carried across chunks
    states = torch.cat([torch.zeros_like(states[0][:1])] + states)
    decay_chunk = torch.exp(segsum(torch.nn.functional.pad(
        a_cumsum[:, :, -1], (1, 0))))                        # (H, C+1, C+1)
    new_states = torch.einsum("hzc,chpn->zhpn", decay_chunk, states)
    states, final = new_states[:-1], new_states[-1]
    # 4. each chunk's output from the state it starts with
    for c0 in range(0, nc, CHUNKS_AT_ONCE):
        cs = slice(c0, c0 + CHUNKS_AT_ONCE)
        y[cs] += torch.einsum("cln,chpn,hcl->clhp", c[cs], states[cs],
                              torch.exp(a_cumsum[:, cs]))
    return y.view(length, h, p), final


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv of xbc (L, C) with w (W, C) and a bias, then
    silu: out[t] = bias + sum_i w[i] xbc[t - W + 1 + i]."""
    width, length = w.shape[0], xbc.shape[0]
    pad = torch.nn.functional.pad(xbc, (0, 0, width - 1, 0))
    out = bias + sum(pad[i:i + length] * w[i] for i in range(width))
    return silu(out)


def mamba(x, wt, z: dict, precision: str) -> tuple:
    """One Mamba2 mixer over x (L, D) -> (out (L, D), the final SSM
    state (H, P, N) and the conv's last W - 1 inputs (W - 1, C))."""
    di, n, nh, p, w = z["di"], z["n"], z["nh"], z["p"], z["w"]
    length = x.shape[0]
    zp, xbc, dt = matmul(x, wt("in_proj"), precision).split(
        [di, di + 2 * n, nh], dim=-1)
    tail = xbc[-(w - 1):]
    xs, bm, cm = causal_conv(xbc, wt("conv_w"), wt("conv_b")).split(
        [di, n, n], dim=-1)
    dt = torch.nn.functional.softplus(dt + wt("dt_bias"))
    a = -torch.exp(wt("a_log"))
    f64 = torch.float64
    xh = xs.view(length, nh, p).to(f64)
    y, state = ssd_minimal_discrete(
        xh * dt.to(f64)[..., None], a.to(f64) * dt.to(f64), bm.to(f64),
        cm.to(f64), largest_divisor(length, z["chunk"]))
    y = (y + wt("ssm_d").to(f64)[:, None] * xh).to(torch.float32)
    g = rmsnorm(y.view(length, di) * silu(zp), wt("norm_scale"), z["eps"])
    return matmul(g, wt("out_proj"), precision), state.to(torch.float32), \
        tail


def attention(x, wt, z: dict, precision: str) -> tuple:
    """One NoPE GQA attention over x (L, D) -> (out (L, D), k, v (L, Hkv,
    Dh)), the causal softmax in blocks of ``Q_BLOCK`` query rows."""
    length = x.shape[0]
    hq, hkv, dh = z["hq"], z["hkv"], z["dh"]
    q = matmul(x, wt("wq"), precision).view(length, hq, dh).transpose(0, 1)
    k = matmul(x, wt("wk"), precision).view(length, hkv, dh)
    v = matmul(x, wt("wv"), precision).view(length, hkv, dh)
    kh = k.repeat_interleave(hq // hkv, dim=1).transpose(0, 1)
    vh = v.repeat_interleave(hq // hkv, dim=1).transpose(0, 1)
    out = torch.empty(length, hq, dh, device=x.device)
    for i0 in range(0, length, Q_BLOCK):
        i1 = min(length, i0 + Q_BLOCK)
        scores = matmul(q[:, i0:i1], kh[:, :i1].transpose(1, 2), precision)
        scores *= z["attention_multiplier"]
        later = torch.arange(i1, device=x.device)[None, :] > \
            torch.arange(i0, i1, device=x.device)[:, None]
        p = torch.softmax(scores.masked_fill_(later, -torch.inf), dim=-1)
        out[i0:i1] = matmul(p, vh[:, :i1], precision).transpose(0, 1)
        del scores, p
    return matmul(out.view(length, hq * dh), wt("wo"), precision), k, v


def moe(x, wt, z: dict, precision: str) -> torch.Tensor:
    """The routed experts of x (L, D), each over its own tokens, plus the
    shared expert."""
    logits = matmul(x, wt("router"), precision)
    top, ids = torch.topk(logits, z["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(x)
    wg, wu, wd = (wt(n, raw=True) for n in ("exp_wgate", "exp_wi",
                                            "exp_w_down"))
    for e in range(z["experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = x[tok]
        f32 = torch.float32
        h = silu(matmul(rows, wg[e].to(f32), precision)) \
            * matmul(rows, wu[e].to(f32), precision)
        out.index_add_(0, tok, matmul(h, wd[e].to(f32), precision)
                       * gates[tok, slot][:, None])
    shared = silu(matmul(x, wt("shared_wgate"), precision)) \
        * matmul(x, wt("shared_wi"), precision)
    return out + matmul(shared, wt("shared_w_down"), precision)


def prefill(cfg: dict, seed: int, tokens: torch.Tensor,
            positions: torch.Tensor, precision: str = REFERENCE,
            logit_positions=(-1,)) -> dict:
    """The prefill of ``tokens`` (B, S) under the weights of ``seed``:
    {"logits": (B, vocab) at the last position, or (B, len, vocab) at
    ``logit_positions`` when more than one is asked for; "k", "v":
    (attention layers, B, P, Hkv, Dh) at ``positions`` (P,); "ssm":
    (Mamba2 layers, B, H, P, N), each layer's final state; "conv":
    (Mamba2 layers, B, W - 1, C), its conv's last inputs}, all f32."""
    z = hybrid_gen.sizes(cfg)
    dev = tokens.device
    f32 = torch.float32
    served = getattr(torch, cfg["precision"]["weights"])
    out = {"k": [], "v": [], "ssm": [], "conv": []}
    with full_f32(), torch.no_grad():
        emb = hybrid_gen.embedding(cfg, seed, dev, served)
        xs = [emb[t].to(f32) * z["embedding_multiplier"] for t in tokens]
        del emb
        m = z["residual_multiplier"]
        for i, kind in enumerate(z["types"]):
            w = hybrid_gen.layer(cfg, seed, i, dev, served)

            def wt(name, raw=False):
                return w[name] if raw else w[name].to(f32)

            got = {"k": [], "v": [], "ssm": [], "conv": []}
            for r, x in enumerate(xs):
                h = rmsnorm(x, wt("mixer_norm"), z["eps"])
                if kind == "mamba":
                    h, state, tail = mamba(h, wt, z, precision)
                    got["ssm"].append(state)
                    got["conv"].append(tail)
                else:
                    h, k, v = attention(h, wt, z, precision)
                    got["k"].append(k[positions])
                    got["v"].append(v[positions])
                x = x + m * h
                xs[r] = x + m * moe(rmsnorm(x, wt("ff_norm"), z["eps"]), wt,
                                    z, precision)
                del h, x
            for key, vals in got.items():
                if vals:
                    out[key].append(torch.stack(vals))
            del w
        emb = hybrid_gen.embedding(cfg, seed, dev, served).to(f32)
        norm = hybrid_gen.final_norm(cfg, seed, dev, served).to(f32)
        at = list(logit_positions)
        logits = torch.stack([
            matmul(rmsnorm(x[at], norm, z["eps"]), emb.t(), precision)
            for x in xs]) / z["logits_scaling"]
    if len(at) == 1:
        logits = logits[:, 0]
    return {"logits": logits,
            **{key: torch.stack(v) if v else None for key, v in out.items()}}
