"""Plain reference of a dense decoder LM's prefill, in plain torch: the
Llama-style stack of Granite's code models (arXiv:2405.04324, Table 1).

From the published description: token embeddings; in each layer
x += Attention(RMSNorm(x)), grouped-query attention (``n_kv_heads`` key
and value heads, each read by ``n_heads / n_kv_heads`` consecutive query
heads) with rotary position embeddings on q and k and a causal softmax of
q k^T / sqrt(head_dim); then x += SwiGLU(RMSNorm(x)) =
(silu(x W_gate) * (x W_up)) W_down; the logits are RMSNorm(x) W_out.
Departures, each noted: RoPE rotates the two halves of each head (the
Hugging Face Llama layout, a fixed permutation of RoFormer's interleaved
pairs), its angles taken in f64; no biases (the paper's table names
none); the logits of the last position only, which is what a prefill
returns.

It draws the weights itself from the seed (``lm_gen``), in the dtype the
configuration serves them in, upcasts one layer at a time and computes
in f32 with TF32 off, attention one key and value head's group of query
heads at a time, so it fits beside what the run holds. It imports
nothing of the program and nothing of JAX.

``precision`` is ``REFERENCE`` or ``FP8``, the control one step below
the configuration's bf16: every matmul's two operands rounded to
float8_e4m3fn with a per-tensor scale (the operand's largest magnitude
to 448), the products summed in f32.
"""
from __future__ import annotations

import contextlib
import math

import torch

from . import lm_gen

REFERENCE, FP8 = "reference", "fp8"
FP8_MAX = 448.0


@contextlib.contextmanager
def full_f32():
    """f32 matmuls without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` through float8_e4m3fn at a per-tensor scale."""
    scale = t.abs().amax().clamp(min=torch.finfo(torch.float32).tiny)
    scale = scale / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == FP8:
        a, b = fp8_round(a), fp8_round(b)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) rotated at positions 0..S-1, the two halves of Dh
    as the pair."""
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              precision: str) -> torch.Tensor:
    """Causal GQA: q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh) ->
    (B, S, Hq, Dh), one key and value head's query heads at a time."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    masked = torch.ones((s, s), dtype=torch.bool, device=q.device).triu(1)
    out = torch.empty_like(q)
    for j in range(hkv):
        qj = q[:, :, j * g:(j + 1) * g].transpose(1, 2)       # (B, g, S, Dh)
        kj = k[:, :, j][:, None].transpose(-1, -2)            # (B, 1, Dh, S)
        scores = matmul(qj, kj, precision) / math.sqrt(dh)
        p = torch.softmax(scores.masked_fill_(masked, -math.inf), dim=-1)
        del scores
        oj = matmul(p, v[:, :, j][:, None], precision)         # (B, g, S, Dh)
        out[:, :, j * g:(j + 1) * g] = oj.transpose(1, 2)
        del p, oj
    return out


def prefill(cfg: dict, seed: int, tokens: torch.Tensor,
            positions: torch.Tensor, precision: str = REFERENCE) -> dict:
    """The prefill of ``tokens`` (B, S) under the weights of ``seed``:
    {"logits": (B, vocab) at the last position, "k", "v": (layers, B, P,
    Hkv, Dh), the post-RoPE keys and the values at ``positions`` (P,)},
    all f32."""
    dev = tokens.device
    b, s = tokens.shape
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    f32, served = torch.float32, getattr(torch, cfg["precision"]["weights"])
    with full_f32(), torch.no_grad():
        x = lm_gen.embedding(cfg, seed, dev, served).to(f32)[tokens]
        ks, vs = [], []
        for i in range(cfg["n_layers"]):
            w = {n: t.to(f32) for n, t in lm_gen.layer(cfg, seed, i, dev,
                                                       served).items()}
            h = rmsnorm(x, w["attn_norm"], eps)
            q = rope(matmul(h, w["wq"], precision).view(b, s, hq, dh), theta)
            k = rope(matmul(h, w["wk"], precision).view(b, s, hkv, dh),
                     theta)
            v = matmul(h, w["wv"], precision).view(b, s, hkv, dh)
            ks.append(k[:, positions])
            vs.append(v[:, positions])
            o = attention(q, k, v, precision).reshape(b, s, hq * dh)
            del q, k, v, h
            x = x + matmul(o, w["wo"], precision)
            h = rmsnorm(x, w["mlp_norm"], eps)
            gate = torch.nn.functional.silu(matmul(h, w["w_gate"], precision))
            x = x + matmul(gate * matmul(h, w["w_up"], precision),
                           w["w_down"], precision)
            del w, h, gate, o
        hd = {n: t.to(f32)
              for n, t in lm_gen.head(cfg, seed, dev, served).items()}
        logits = matmul(rmsnorm(x[:, -1], hd["final_norm"], eps),
                        hd["unembed"], precision)
    return {"logits": logits, "k": torch.stack(ks), "v": torch.stack(vs)}
