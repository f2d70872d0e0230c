"""Shared runs for the LM parity tests of the MoE, Mamba2, hybrid,
vision-prefixed and encoder-decoder stacks
(``tests/test_torch_{moe,mamba,hybrid,vlm,encdec}.py``).

``repro.models.transformer.init_params`` draws the weights; they cross
over as numpy (``interop.lm_params_from_numpy``), and the prompts and the
modality stubs' embeddings come from numpy seeds. Everything runs in f32
on the CPU, where the port's attention wrappers run their plain versions.
``repro``'s prefill runs on its Pallas ``flash_prefill`` route
(interpret mode) or its jnp route.
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


def embeds(jcfg, b: int = B, s: int = S, seed: int = 4) -> dict:
    """The modality stubs' inputs as ``repro``'s serve shapes them, as f32
    numpy: a vision model's 'modal_embeds' (b, P, D), an encoder-decoder
    model's 'enc_embeds' (b, max(s // 4, 8), D), each 0.02 * N(0, 1);
    {} for a text-only model."""
    rng = np.random.default_rng(seed)
    out = {}
    if jcfg.modality == "vision" and jcfg.modality_tokens:
        out["modal_embeds"] = rng.standard_normal(
            (b, jcfg.modality_tokens, jcfg.d_model), dtype=np.float32) * 0.02
    if jcfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal(
            (b, max(s // 4, 8), jcfg.d_model), dtype=np.float32) * 0.02
    return out


def positions(tokens, emb) -> int:
    """P + S: the positions a prefill of ``tokens`` after ``emb``'s
    modality prefix fills (where decoding starts)."""
    m = (emb or {}).get("modal_embeds")
    return tokens.shape[1] + (0 if m is None else m.shape[1])


def as_torch(emb) -> dict:
    return {k: torch.from_numpy(v) for k, v in (emb or {}).items()}


def repro_prefill(jcfg, params, tokens, *, max_len: int, pallas: bool,
                  emb=None):
    """``repro``'s prefill (after ``emb``'s stub embeddings): (logits,
    cache as numpy)."""
    j_layers.set_pallas_attention(True if pallas else None)
    try:
        logits, cache, _ = T.prefill(
            jcfg, params, jnp.asarray(tokens), max_len=max_len,
            **{k: jnp.asarray(v) for k, v in (emb or {}).items()})
        return np.asarray(logits), jax.tree.map(np.asarray, cache)
    finally:
        j_layers.set_pallas_attention(None)


_steps: dict = {}


def repro_decode_step(jcfg):
    """``repro``'s ``decode_step`` for ``jcfg``, jitted once."""
    if jcfg not in _steps:
        _steps[jcfg] = jax.jit(
            lambda p, c, t, pos: T.decode_step(jcfg, p, c, t, pos))
    return _steps[jcfg]


def repro_greedy(jcfg, params, tokens, *, pallas: bool, steps: int = STEPS,
                 emb=None):
    """``repro``'s prefill + ``steps`` greedy ``decode_step``s: (logits of
    each step, (B, steps + 1) greedy ids, the prefill's cache)."""
    s = positions(tokens, emb)
    logits, cache0 = repro_prefill(jcfg, params, tokens, max_len=s + steps,
                                   pallas=pallas, emb=emb)
    step = repro_decode_step(jcfg)
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


def port_greedy(model, tokens: np.ndarray, steps: int = STEPS, emb=None):
    """The port's prefill + ``steps`` greedy ``decode_step``s: (logits of
    each step as numpy, (B, steps + 1) ids, the prefill's cache)."""
    s = positions(tokens, emb)
    logits, cache = model.prefill(torch.from_numpy(tokens).long(),
                                  max_len=s + steps, **as_torch(emb))
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


#: AdamW's eps: where a clipped gradient g is near it, the first update
#: lr * g / (|g| + eps) is no longer ~lr * sign(g) but bends with g
ADAM_EPS = 1e-8


def train_step_parity(jcfg, *, b: int = 2, s: int = 64, lr: float = 1e-3,
                      emb_seed: int = 9):
    """One AdamW ``make_train_step`` of each package from ``repro``'s
    params and ``OptState``, on ``repro``'s ``TokenStream`` batch with the
    stub embeddings of :func:`embeds`, checked to
    ``tests/test_torch_train.py``'s bounds: the step-1 gradient within
    ``rtol=1e-5`` and ``2e-5`` of each leaf's largest entry, loss and grad
    norm within ``rtol=2e-6``, the learning rate exactly, the parameters
    within ``atol=5e-6`` plus what the two clipped gradients' difference
    dg moves AdamW's first update lr * g / (|g| + eps) by, at most
    lr * eps * dg / (min |g| + eps)^2 (and 2 lr): a gradient within a few
    eps of 0 summed in another order moves its update by a share of lr.
    Returns (repro's params before and after, the port's params after as
    numpy, the count of parameters more than 5e-6 from ``repro``'s)."""
    from repro import optim as jo
    from repro.data.tokens import TokenStream as JTokenStream
    from repro.launch import steps as jsteps
    from repro.launch.shapes import InputShape as JInputShape
    from repro_torch import optim as to
    from repro_torch.launch import shapes as t_shapes
    from repro_torch.launch import steps as tsteps

    params0 = T.init_params(jcfg, jax.random.key(0))
    jopt = jo.adamw()
    state = jopt.init(params0)
    cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
    model = interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params0), device="cpu")
    model.requires_grad_(True)
    opt = to.AdamW(model.parameters())
    interop.opt_state_from_numpy(cfg, model, opt,
                                 jax.tree.map(np.asarray, state._asdict()))
    nb = JTokenStream(vocab=jcfg.vocab, seq_len=s - (jcfg.modality_tokens
                                                     or 0),
                      global_batch=b, seed=0).batch(0)
    nb.update(embeds(jcfg, b, s, seed=emb_seed))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jshape = JInputShape("cli", "train", s, b)
    n_modal = jsteps.modal_tokens(jcfg)

    def jloss(p):
        h, aux = T.forward(jcfg, p, jb["tokens"],
                           modal_embeds=jb.get("modal_embeds"),
                           enc_embeds=jb.get("enc_embeds"))
        return T.lm_loss(jcfg, p, h[:, n_modal:], jb["labels"],
                         jb["mask"]) + jsteps.MOE_AUX_WEIGHT * aux

    jgrad = jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(params0))
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jshape, jopt, jo.linear_warmup_cosine(lr, 0, 2)))
    params1, _, jm = jstep(params0, state, jb)
    tstep = tsteps.make_train_step(
        cfg, t_shapes.InputShape("cli", "train", s, b),
        to.linear_warmup_cosine(lr, 0, 2))
    batch = {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32
                                       else torch.float32)
             for k, v in nb.items()}
    captured = {}
    real_step = opt.step

    def step(lr_, grads):        # the port's clipped gradients
        captured["grads"] = [g.detach().clone() for g in grads]
        return real_step(lr_, grads)

    opt.step = step
    tm = tstep(model, opt, batch)
    assert float(tm["lr"]) == float(jm["lr"])
    for k in ("loss", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   err_msg=k)
    names = [n for n, _ in model.named_parameters()]
    scale = min(1.0, 1.0 / float(jm["grad_norm"]))
    tgrad = interop.lm_tree_from_named(
        cfg, {n: g / scale for n, g in zip(names, captured["grads"])})
    got = interop.lm_params_to_numpy(model)
    flat = jax.tree_util.tree_flatten_with_path
    n_far = 0
    for (path, w1), w0, g, jg, tg in zip(
            flat(params1)[0], jax.tree.leaves(params0), jax.tree.leaves(got),
            jax.tree.leaves(jgrad), jax.tree.leaves(tgrad)):
        what = jax.tree_util.keystr(path)
        np.testing.assert_allclose(tg, jg, rtol=1e-5,
                                   atol=2e-5 * float(np.abs(jg).max()),
                                   err_msg=f"gradient {what}")
        ga, gb = np.abs(jg) * scale, np.abs(tg) * scale
        dg = np.abs(jg - tg) * scale
        moved = lr * ADAM_EPS * dg / (np.minimum(ga, gb) + ADAM_EPS) ** 2
        err = np.abs(g - np.asarray(w1))
        bound = 5e-6 + np.minimum(moved, 2 * lr)
        assert (err <= bound).all(), (what, float((err - bound).max()))
        n_far += int((err > 5e-6).sum())
    return params0, params1, got, n_far
