"""Reduced llava-next-mistral-7b (a dense decoder whose prompt begins with
projected patch embeddings) and llama4-scout-17b-a16e (the same early
fusion over top-1 MoE layers with a shared expert) against ``repro`` on
the CPU in f32.

``repro``'s params cross over through ``interop``; the prompts and the P
patch embeddings (8 at the reduced size) come from numpy seeds; decoding
starts at position P + S. Tolerances, from the measured differences:

* a prefill and 8 greedy decode steps: equal ids and logits within
  ``1e-4``, on both of ``repro``'s attention routes; the prefill's cache
  within ``2e-5``;
* decode steps from ``repro``'s own cache (``kv_cache_from_numpy``):
  logits within ``1e-4``;
* one ``make_train_step``: ``_lm_parity.train_step_parity``'s bounds
  (``tests/test_torch_train.py``'s), and at most 1e-4 of the parameters
  beyond 5e-6;
* parameter counts: exact.
"""
import numpy as np
import jax
import pytest
import torch

import _lm_parity as lp
from repro.models import transformer as T
from repro.models.arch import get_arch as j_get_arch
from repro_torch.models import arch as t_arch
from repro_torch.models.transformer import Transformer

NAMES = ("llava-next-mistral-7b", "llama4-scout-17b-a16e")
JCFGS = {n: j_get_arch(n).reduced() for n in NAMES}
ATOL = 1e-4
CACHE_ATOL = 2e-5

_cache: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    if name not in _cache:
        jcfg = JCFGS[name]
        params, cfg, model = lp.setup(jcfg)
        _cache[name] = params, cfg, model, lp.prompts(cfg), lp.embeds(jcfg)
    return _cache[name]


def _port_greedy(name):
    key = ("port", name)
    if key not in _cache:
        _, _, model, tokens, emb = _setup(name)
        _cache[key] = lp.port_greedy(model, tokens, emb=emb)
    return _cache[key]


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_greedy_decode_matches_repro(name, pallas):
    """A prefill of P patch rows + S tokens, then 8 greedy steps at
    positions P + S + i: equal ids, logits within 1e-4, and the prefill's
    cache within 2e-5 of ``repro``'s."""
    params, cfg, model, tokens, emb = _setup(name)
    p = emb["modal_embeds"].shape[1]
    assert p == cfg.modality_tokens == 8
    want = lp.repro_greedy(JCFGS[name], params, tokens, pallas=pallas,
                           emb=emb)
    got = _port_greedy(name)
    lp.assert_greedy_close(got, want, ATOL)
    assert got[2].keys() == want[2].keys() == {"l0"}
    for n, w in want[2]["l0"].items():
        g = got[2]["l0"][n]
        assert g.shape == w.shape == (cfg.n_rep, 2, p + lp.S + lp.STEPS,
                                      cfg.n_kv_heads, cfg.hd)
        np.testing.assert_allclose(g, w, rtol=0, atol=CACHE_ATOL, err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_decode_from_repros_cache(name):
    params, cfg, model, tokens, emb = _setup(name)
    from repro_torch import interop

    w_logits, w_ids, cache0 = lp.repro_greedy(JCFGS[name], params, tokens,
                                              pallas=False, emb=emb)
    cache = interop.kv_cache_from_numpy(cfg, cache0, device="cpu")
    s = lp.positions(tokens, emb)
    for i in range(lp.STEPS):
        tok = torch.from_numpy(w_ids[:, i:i + 1]).long()
        logits, cache = model.decode_step(cache, tok, s + i)
        np.testing.assert_allclose(logits.numpy(), w_logits[i + 1], rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")
    back = interop.kv_cache_to_numpy(cfg, cache)
    assert back["l0"]["k"].shape == cache0["l0"]["k"].shape


def test_modal_embeds_take_the_embeddings_dtype():
    """f32 patch embeddings into a bf16 model: the prefill casts them to
    the embedding's dtype, so it equals a prefill of bf16 ones."""
    jcfg = JCFGS["llava-next-mistral-7b"]
    _, cfg, _, tokens, emb = _setup("llava-next-mistral-7b")
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    t = torch.from_numpy(tokens[:, :12]).long()
    m = torch.from_numpy(emb["modal_embeds"])
    a, ca = model.prefill(t, modal_embeds=m)
    b, cb = model.prefill(t, modal_embeds=m.to(torch.bfloat16))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert ca[0]["k"].shape[1] == 12 + jcfg.modality_tokens


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_repro(name):
    """One AdamW step from ``repro``'s params and ``OptState``; the loss
    skips the P patch rows, as ``repro``'s does."""
    _, _, after, n_far = lp.train_step_parity(JCFGS[name])
    assert n_far <= 1e-4 * sum(a.size for a in jax.tree.leaves(after))


#: parameters at full size; llama4-scout also cut to 8 of its 48 layers,
#: the depth one card holds (chip_smoke.py phase 19)
FULL = {"llava-next-mistral-7b": (7_241_732_096, None),
        "llama4-scout-17b-a16e": (107_771_827_200, 19_687_756_800)}


@pytest.mark.parametrize("name", NAMES)
def test_full_size_parameter_counts(name):
    """``param_count`` and ``active_param_count`` equal to ``repro``'s at
    full size (on the meta device; llama4-scout: 15 of 16 experts of each
    MoE layer inactive), and at llama4-scout's 8-layer cut."""
    import dataclasses

    jcfg = j_get_arch(name)
    shapes = jax.eval_shape(lambda k: T.init_params(jcfg, k),
                            jax.random.key(0))
    meta = Transformer(t_arch.get_arch(name), device="meta")
    full, cut = FULL[name]
    assert meta.param_count() == T.param_count(shapes) == full
    assert meta.active_param_count() == T.active_param_count(jcfg, shapes)
    if cut is not None:
        assert meta.active_param_count() < full / 5
        cfg8 = dataclasses.replace(t_arch.get_arch(name), n_layers=8)
        assert Transformer(cfg8, device="meta").param_count() == cut


def test_prefill_step_passes_the_patch_embeddings():
    from repro_torch.launch import shapes as t_shapes
    from repro_torch.launch import steps as tsteps

    _, cfg, model, tokens, emb = _setup("llava-next-mistral-7b")
    batch = {"tokens": torch.from_numpy(tokens).long(), **lp.as_torch(emb)}
    logits, cache = tsteps.make_prefill_step(
        cfg, t_shapes.InputShape("cli", "prefill", lp.S, 2))(model, batch)
    want, _ = model.prefill(batch["tokens"], **lp.as_torch(emb))
    assert torch.equal(logits, want)
    assert cache[0]["k"].shape[1] == lp.S + cfg.modality_tokens
