"""The inputs of a Granite 4.0-H (``granitemoehybrid``) cell, drawn from the
run's seed on the device: the model's weights, in the dtype they are
served in, the prompts, and the row of a batch that the check reads.

The configuration file keeps the source's own keys (``hidden_size``,
``layer_types``, ``mamba_d_head``, ...); :func:`sizes` reads them once for
the generator, the reference, the kind and the yardstick. Both sides take
the weights from here, as ``lm_gen`` does for the dense cell: each
layer's leaves come from one generator seeded from (seed, layer), a
normal draw cut into the leaves, then for a Mamba2 layer a uniform draw
for its constants, so a layer can be drawn alone. Distributions:
projections, experts and the router N(0, 1/fan_in); the conv kernel and
its bias N(0, 1/width); the tied embedding N(0, 0.02^2); RMSNorm scales
(the Mamba2 gated norm's too) 1 + 0.1 N(0, 1); and Mamba2's own
initialisation for its constants (arXiv:2405.21060's code): A_log =
log U(1, 16), dt = exp U(log 1e-3, log 1e-1) floored at 1e-4 with
dt_bias its inverse softplus, D = 1.
"""
from __future__ import annotations

import math

import torch

from . import lm_gen

#: ``hybrid_gen``'s leaf of a layer -> the port's parameter under
#: ``layers.<i>``
LEAVES = {"mixer_norm": "mixer_norm.scale", "in_proj": "mixer.in_proj",
          "conv_w": "mixer.conv_w", "conv_b": "mixer.conv_b",
          "norm_scale": "mixer.norm_scale", "out_proj": "mixer.out_proj",
          "a_log": "mixer.a_log", "dt_bias": "mixer.dt_bias",
          "ssm_d": "mixer.ssm_d", "wq": "mixer.wq", "wk": "mixer.wk",
          "wv": "mixer.wv", "wo": "mixer.wo", "ff_norm": "ff_norm.scale",
          "router": "ff.router", "exp_wgate": "ff.exp_wgate",
          "exp_wi": "ff.exp_wi", "exp_w_down": "ff.exp_w_down",
          "shared_wgate": "ff.shared.wgate", "shared_wi": "ff.shared.wi",
          "shared_w_down": "ff.shared.w_down"}


def sizes(cfg: dict) -> dict:
    """The configuration's sizes under short names: ``types`` (each of
    the ``layers`` layers' mixer, "mamba" or "attention"), d, hq, hkv, dh,
    experts, top_k, f (an expert's width), fs (the shared expert's),
    vocab, di (d_inner), n (d_state), nh, p (head size), w (conv width),
    chunk, eps and the multipliers."""
    layers = int(cfg["num_hidden_layers"])
    d, hq = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return {"layers": layers, "types": list(cfg["layer_types"][:layers]),
            "d": d, "hq": hq, "hkv": int(cfg["num_key_value_heads"]),
            "dh": d // hq, "experts": int(cfg["num_local_experts"]),
            "top_k": int(cfg["num_experts_per_tok"]),
            "f": int(cfg["intermediate_size"]),
            "fs": int(cfg["shared_intermediate_size"]),
            "vocab": int(cfg["vocab_size"]),
            "di": int(cfg["mamba_expand"]) * d, "n": int(cfg["mamba_d_state"]),
            "nh": int(cfg["mamba_n_heads"]), "p": int(cfg["mamba_d_head"]),
            "w": int(cfg["mamba_d_conv"]), "chunk": int(cfg["mamba_chunk_size"]),
            "eps": float(cfg["rms_norm_eps"]),
            "attention_multiplier": float(cfg["attention_multiplier"]),
            "embedding_multiplier": float(cfg["embedding_multiplier"]),
            "residual_multiplier": float(cfg["residual_multiplier"]),
            "logits_scaling": float(cfg["logits_scaling"])}


def arch_fields(cfg: dict) -> dict:
    """The port's ``ArchConfig`` fields that the configuration sizes."""
    z = sizes(cfg)
    return {"n_layers": z["layers"], "d_model": z["d"], "n_heads": z["hq"],
            "n_kv_heads": z["hkv"], "head_dim": z["dh"], "d_ff": z["f"],
            "vocab": z["vocab"], "moe_experts": z["experts"],
            "moe_top_k": z["top_k"], "moe_shared_ff": z["fs"],
            "ssm_state": z["n"], "ssm_head_dim": z["p"],
            "ssm_expand": z["di"] // z["d"], "ssm_conv_width": z["w"],
            "norm_eps": z["eps"],
            **{k: z[k] for k in ("attention_multiplier",
                                 "embedding_multiplier",
                                 "residual_multiplier", "logits_scaling")}}


def layer_leaves(cfg: dict, i: int) -> list[tuple[str, tuple, float | None]]:
    """(name, shape, std) of layer ``i``'s normal leaves in draw order:
    its mixer's, then its MoE's; std None marks an RMSNorm scale. Weights
    apply as ``x @ W``; an expert's as ``x @ W[e]``."""
    z = sizes(cfg)
    d, di, n, nh, w = z["d"], z["di"], z["n"], z["nh"], z["w"]
    if z["types"][i] == "mamba":
        mixer = [("mixer_norm", (d,), None),
                 ("in_proj", (d, 2 * di + 2 * n + nh), d ** -0.5),
                 ("conv_w", (w, di + 2 * n), w ** -0.5),
                 ("conv_b", (di + 2 * n,), w ** -0.5),
                 ("norm_scale", (di,), None),
                 ("out_proj", (di, d), di ** -0.5)]
    else:
        hq, hkv = z["hq"] * z["dh"], z["hkv"] * z["dh"]
        mixer = [("mixer_norm", (d,), None), ("wq", (d, hq), d ** -0.5),
                 ("wk", (d, hkv), d ** -0.5), ("wv", (d, hkv), d ** -0.5),
                 ("wo", (hq, d), hq ** -0.5)]
    e, f, fs = z["experts"], z["f"], z["fs"]
    return mixer + [("ff_norm", (d,), None), ("router", (d, e), d ** -0.5),
                    ("exp_wgate", (e, d, f), d ** -0.5),
                    ("exp_wi", (e, d, f), d ** -0.5),
                    ("exp_w_down", (e, f, d), f ** -0.5),
                    ("shared_wgate", (d, fs), d ** -0.5),
                    ("shared_wi", (d, fs), d ** -0.5),
                    ("shared_w_down", (fs, d), fs ** -0.5)]


def layer(cfg: dict, seed: int, i: int, device, dtype=torch.bfloat16
          ) -> dict:
    """Layer ``i``'s leaves by :func:`layer_leaves`' names, in ``dtype``;
    a Mamba2 layer's ``a_log``, ``dt_bias`` and ``ssm_d`` in f32."""
    g = lm_gen.generator(seed, lm_gen.LAYER, i, device=device)
    out = lm_gen._draw(layer_leaves(cfg, i), g, device, dtype)
    if sizes(cfg)["types"][i] == "mamba":
        nh = sizes(cfg)["nh"]
        u = torch.rand(2 * nh, generator=g, device=device,
                       dtype=torch.float32)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + u[nh:] * (hi - lo)).clamp(min=1e-4)
        out["a_log"] = torch.log(1.0 + 15.0 * u[:nh])
        out["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
        out["ssm_d"] = torch.ones(nh, device=device, dtype=torch.float32)
    return out


def embedding(cfg: dict, seed: int, device, dtype=torch.bfloat16
              ) -> torch.Tensor:
    """(vocab, d) token embeddings, tied to the output head."""
    z = sizes(cfg)
    return lm_gen.embedding({"vocab": z["vocab"], "d_model": z["d"]}, seed,
                            device, dtype)


def final_norm(cfg: dict, seed: int, device, dtype=torch.bfloat16
               ) -> torch.Tensor:
    """The final RMSNorm's scale."""
    g = lm_gen.generator(seed, lm_gen.HEAD, device=device)
    return lm_gen._draw([("final_norm", (sizes(cfg)["d"],), None)], g,
                        device, dtype)["final_norm"]


def prompts(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["prompts"]`` batches of (batch, prompt_len) ids, uniform
    over the vocabulary."""
    return lm_gen.prompts({"vocab": sizes(cfg)["vocab"]}, traffic, seed,
                          device)
