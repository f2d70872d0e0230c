"""The yardstick's counts for a Granite 4.0-H prefill: the least work and
bytes of each measured stage, counted from the configuration's shapes
alone (never from the program's counters), and the TF32 peak the SSD's
share is taken at.

A call prefills B rows of S tokens through the configuration's layers
(``hybrid_gen.sizes``):

* GEMMs, 2 m k n each: a Mamba2 layer's in_proj (d -> 2 di + 2 N + H)
  and out_proj (di -> d); an attention layer's q, k, v and output
  projections; every layer's router (d -> experts), its routed experts'
  SwiGLU over the T k token-expert rows (gate, up: d -> f; down: f -> d)
  and its shared expert's over the T tokens; the tied head over each
  row's last position.
* Attention: ``roofline.causal_attention_ops`` (q.k and p.v over the
  visible pairs), no positional encoding.
* The SSD at chunk l (arXiv:2405.21060's chunked form, the full l x l
  blocks as it computes them): a token's C B^T row (2 l N, one group, so
  once for every head), and for each head its row of the masked block
  times x (2 l P), its chunk's state (2 N P) and the carried state's
  output (2 N P). Its least bytes: x and y (H P f32 each), dt (H f32), B
  and C (N f32 each) a token, and each row's final state (H P N f32)
  once.
* The routed experts (``experts``): 6 T k d f operations; least bytes,
  the held experts' weights read once and the T tokens in and out in
  bf16.
"""
from __future__ import annotations

from . import roofline

#: device name -> (dense TF32 operations per second, HBM bytes per
#: second): NVIDIA's data sheet for the H100 SXM at its 700 W limit
TF32_PEAKS = {
    "NVIDIA H100 80GB HBM3": (494.7e12, 3.35e12),
}
BF16 = 2
F32 = 4


def ssd_ops(tokens: int, z: dict) -> int:
    """One Mamba2 layer's chunked SSD over ``tokens`` tokens."""
    l, n, h, p = z["chunk"], z["n"], z["nh"], z["p"]
    return tokens * (2 * l * n + h * (2 * l * p + 4 * n * p))


def ssd_bytes(rows: int, tokens: int, z: dict) -> int:
    h, p, n = z["nh"], z["p"], z["n"]
    return F32 * (tokens * (2 * h * p + h + 2 * n) + rows * h * p * n)


def experts_ops(tokens: int, z: dict) -> int:
    """One layer's routed experts over ``tokens`` tokens, top-k each."""
    return 6 * tokens * z["top_k"] * z["d"] * z["f"]


def experts_bytes(tokens: int, z: dict) -> int:
    return BF16 * (3 * z["experts"] * z["d"] * z["f"] + 2 * tokens * z["d"])


def gemms(b: int, s: int, z: dict) -> list:
    """((m, k, n), count) of a prefill's dense GEMMs, the routed experts
    as their token-expert rows."""
    t, d = b * s, z["d"]
    n_mamba = z["types"].count("mamba")
    n_attn = z["layers"] - n_mamba
    hq, hkv = z["hq"] * z["dh"], z["hkv"] * z["dh"]
    rows = t * z["top_k"]
    return [((t, d, 2 * z["di"] + 2 * z["n"] + z["nh"]), n_mamba),
            ((t, z["di"], d), n_mamba),
            ((t, d, hq), n_attn), ((t, d, hkv), 2 * n_attn),
            ((t, hq, d), n_attn),
            ((t, d, z["experts"]), z["layers"]),
            ((rows, d, z["f"]), 2 * z["layers"]),
            ((rows, z["f"], d), z["layers"]),
            ((t, d, z["fs"]), 2 * z["layers"]),
            ((t, z["fs"], d), z["layers"]),
            ((b, d, z["vocab"]), 1)]


def prefill_counts(z: dict, b: int, s: int) -> dict:
    """(operations, bytes) of one prefill of B x S tokens: "gemm",
    "attention", "ssd" and "experts" (each summed over its layers) and
    "whole" (the GEMMs', the attention's and the SSD's operations)."""
    t = b * s
    n_mamba = z["types"].count("mamba")
    n_attn = z["layers"] - n_mamba
    gm = gemms(b, s, z)
    gemm = (sum(c * roofline.gemm_ops(*mkn) for mkn, c in gm),
            sum(c * roofline.gemm_bytes(*mkn) for mkn, c in gm))
    attn = (n_attn * roofline.causal_attention_ops(b, s, z["hq"], z["dh"]),
            n_attn * roofline.attention_bytes(b, s, z["hq"], z["hkv"],
                                              z["dh"]))
    ssd = (n_mamba * ssd_ops(t, z), n_mamba * ssd_bytes(b, t, z))
    experts = (z["layers"] * experts_ops(t, z),
               z["layers"] * experts_bytes(t, z))
    return {"gemm": gemm, "attention": attn, "ssd": ssd, "experts": experts,
            "whole": (gemm[0] + attn[0] + ssd[0], 0)}
