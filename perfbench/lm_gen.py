"""The inputs of an LM cell, drawn from the run's seed on the device: the
model's weights, in the dtype they are served in, the prompts, and the
rows of a batch that the check reads.

Both sides take them from here. The kind loads them into the program's
parameters at set-up; the plain reference (``reference_lm``) draws them
again, one layer at a time, after the window. Each layer's leaves come
from one draw of a generator seeded from (seed, layer), so a layer can be
drawn alone. Distributions: projections N(0, 1/fan_in), the embedding
N(0, 0.02^2) and the unembedding N(0, 1/d_model), as the port initialises
them; RMSNorm scales 1 + 0.1 N(0, 1), not all ones, so that a scale left
out shows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NORM_SPREAD = 0.1
EMBED_STD = 0.02
#: generator streams of one seed
EMBED, LAYER, HEAD, PROMPT, ROWS = range(5)


def generator(seed: int, *stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, *stream)."""
    g = torch.Generator(device=torch.device(device))
    state = np.random.SeedSequence([int(seed), *stream])
    g.manual_seed(int(state.generate_state(1, np.uint32)[0]))
    return g


def layer_leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    """(name, shape, std) of one decoder layer's leaves in draw order; std
    None marks an RMSNorm scale. Weights apply as ``x @ W``."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hq = cfg["n_heads"] * cfg["head_dim"]
    hkv = cfg["n_kv_heads"] * cfg["head_dim"]
    return [("attn_norm", (d,), None), ("wq", (d, hq), d ** -0.5),
            ("wk", (d, hkv), d ** -0.5), ("wv", (d, hkv), d ** -0.5),
            ("wo", (hq, d), hq ** -0.5), ("mlp_norm", (d,), None),
            ("w_gate", (d, f), d ** -0.5), ("w_up", (d, f), d ** -0.5),
            ("w_down", (f, d), f ** -0.5)]


def head_leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    d = cfg["d_model"]
    return [("final_norm", (d,), None),
            ("unembed", (d, cfg["vocab"]), d ** -0.5)]


def _draw(leaves, g: torch.Generator, device, dtype) -> dict:
    """One normal draw for all ``leaves``, cut into them and scaled."""
    n = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(n, generator=g, device=device, dtype=dtype)
    out, o = {}, 0
    for name, shape, std in leaves:
        t = flat[o:o + math.prod(shape)].view(shape)
        o += t.numel()
        if std is None:
            t.mul_(NORM_SPREAD).add_(1.0)
        else:
            t.mul_(std)
        out[name] = t
    return out


def embedding(cfg: dict, seed: int, device, dtype=torch.bfloat16
              ) -> torch.Tensor:
    """(vocab, d_model) token embeddings."""
    g = generator(seed, EMBED, device=device)
    return _draw([("embed", (cfg["vocab"], cfg["d_model"]), EMBED_STD)], g,
                 device, dtype)["embed"]


def layer(cfg: dict, seed: int, i: int, device, dtype=torch.bfloat16
          ) -> dict:
    """Decoder layer ``i``'s leaves, by :func:`layer_leaves`' names."""
    return _draw(layer_leaves(cfg), generator(seed, LAYER, i, device=device),
                 device, dtype)


def head(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The final RMSNorm's scale and the (d_model, vocab) unembedding."""
    return _draw(head_leaves(cfg), generator(seed, HEAD, device=device),
                 device, dtype)


def prompts(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["prompts"]`` batches of (batch, prompt_len) ids, uniform
    over the vocabulary."""
    shape = (traffic["batch"], traffic["prompt_len"])
    return [torch.randint(0, cfg["vocab"], shape, device=device,
                          generator=generator(seed, PROMPT, k,
                                              device=device))
            for k in range(traffic["prompts"])]


def check_rows(traffic: dict, seed: int) -> list[int]:
    """The rows of a batch the check holds to the reference: one drawn
    from each of ``traffic["check_rows"]`` equal parts of the batch, so
    that every part is seen."""
    b = traffic["batch"]
    n = min(int(traffic["check_rows"]), b)
    g = generator(seed, ROWS, device="cpu")
    cuts = [b * j // n for j in range(n + 1)]
    return [lo + int(torch.randint(hi - lo, (1,), generator=g))
            for lo, hi in zip(cuts, cuts[1:])]
