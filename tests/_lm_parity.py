"""Shared runs for the LM parity tests of the MoE, Mamba2 and hybrid
stacks (``tests/test_torch_{moe,mamba,hybrid}.py``).

``repro.models.transformer.init_params`` draws the weights; they cross
over as numpy (``interop.lm_params_from_numpy``), and the prompts come
from a numpy seed. Everything runs in f32 on the CPU, where the port's
attention wrappers run their plain versions. ``repro``'s prefill runs on
its Pallas ``flash_prefill`` route (interpret mode) or its jnp route.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.models import layers as j_layers
from repro.models import transformer as T
from repro_torch import interop

#: prompt batch, prompt length and greedy decode steps
B, S, STEPS = 2, 40, 8


def setup(jcfg, seed: int = 0):
    """(repro params, port cfg, port model) on the same weights."""
    params = T.init_params(jcfg, jax.random.key(seed))
    cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
    model = interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return params, cfg, model


def prompts(cfg, b: int = B, s: int = S, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def repro_prefill(jcfg, params, tokens, *, max_len: int, pallas: bool):
    """``repro``'s prefill: (logits, cache as numpy)."""
    j_layers.set_pallas_attention(True if pallas else None)
    try:
        logits, cache, _ = T.prefill(jcfg, params, jnp.asarray(tokens),
                                     max_len=max_len)
        return np.asarray(logits), jax.tree.map(np.asarray, cache)
    finally:
        j_layers.set_pallas_attention(None)


def repro_greedy(jcfg, params, tokens, *, pallas: bool, steps: int = STEPS):
    """``repro``'s prefill + ``steps`` greedy ``decode_step``s: (logits of
    each step, (B, steps + 1) greedy ids, the prefill's cache)."""
    s = tokens.shape[1]
    logits, cache0 = repro_prefill(jcfg, params, tokens, max_len=s + steps,
                                   pallas=pallas)
    step = jax.jit(lambda p, c, t, pos: T.decode_step(jcfg, p, c, t, pos))
    cache = jax.tree.map(jnp.asarray, cache0)
    all_logits, ids = [logits], []
    for i in range(steps):
        tok = np.argmax(all_logits[-1][:, -1], axis=-1)[:, None]
        ids.append(tok)
        logits, cache = step(params, cache, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(s + i, jnp.int32))
        all_logits.append(np.asarray(logits))
    ids.append(np.argmax(all_logits[-1][:, -1], axis=-1)[:, None])
    return all_logits, np.concatenate(ids, axis=1), cache0


def port_greedy(model, tokens: np.ndarray, steps: int = STEPS):
    """The port's prefill + ``steps`` greedy ``decode_step``s: (logits of
    each step as numpy, (B, steps + 1) ids, the prefill's cache)."""
    s = tokens.shape[1]
    logits, cache = model.prefill(torch.from_numpy(tokens).long(),
                                  max_len=s + steps)
    cache0 = interop.kv_cache_to_numpy(model.cfg, cache)
    all_logits, ids = [logits.numpy()], []
    for i in range(steps + 1):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ids.append(tok.numpy())
        if i < steps:
            logits, cache = model.decode_step(cache, tok, s + i)
            all_logits.append(logits.numpy())
    return all_logits, np.concatenate(ids, axis=1), cache0


def assert_greedy_close(got, want, atol: float) -> float:
    """Equal ids and every step's logits within ``atol``; returns the
    largest difference."""
    (g_logits, g_ids, _), (w_logits, w_ids, _) = got, want
    np.testing.assert_array_equal(g_ids, w_ids)
    worst = 0.0
    for i, (g, w) in enumerate(zip(g_logits, w_logits)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"step {i}")
        worst = max(worst, float(np.abs(g - w).max()))
    return worst
