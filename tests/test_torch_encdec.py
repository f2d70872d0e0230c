"""Reduced seamless-m4t-large-v2 (a bidirectional encoder over frame
embeddings, a causal decoder whose layers cross-attend to the encoder's
memory) against ``repro`` on the CPU in f32.

``repro``'s params cross over through ``interop`` (``enc_blocks``,
``enc_norm`` and each decoder layer's ``cross_norm`` / ``cross``); the
prompts and the encoder's frame embeddings come from numpy seeds.
Tolerances, from the measured differences:

* one attention layer, self or cross, prefill or one-token decode:
  ``1e-5`` (f32 sums in another order);
* the encoder's memory: ``1e-5`` of its largest entry;
* a prefill and 8 greedy decode steps: equal ids and logits within
  ``1e-4``, on both of ``repro``'s attention routes; the prefill's cache,
  its cross K/V included, within ``1e-5``;
* one ``make_train_step``: ``tests/test_torch_train.py``'s bounds
  (``_lm_parity.train_step_parity``: gradients within 2e-5 of each
  leaf's largest entry, loss and grad norm within ``rtol=2e-6``, the
  parameters within ``atol=5e-6`` plus what the gradients' difference
  moves AdamW's first update by near its eps (measured: 165 of 3.7M
  parameters beyond 5e-6, the farthest 2.2e-5), and at most 1e-4 of
  them beyond 5e-6;
* round trips: exact.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _lm_parity as lp
from repro.models import layers as j_layers
from repro.models import transformer as T
from repro.models.arch import get_arch as j_get_arch
from repro_torch import interop
from repro_torch.models import arch as t_arch
from repro_torch.models.transformer import Transformer

NAME = "seamless-m4t-large-v2"
JCFG = j_get_arch(NAME).reduced()
ATOL = 1e-4
LAYER_ATOL = 1e-5

_cache: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    if "model" not in _cache:
        _cache["model"] = lp.setup(JCFG)
    return _cache["model"]


def _inputs():
    """(prompts, {'enc_embeds'}) as numpy."""
    params, cfg, model = _setup()
    return lp.prompts(cfg), lp.embeds(JCFG)


def _repro_memory(params, enc):
    return np.asarray(T.encode(JCFG, params, jnp.asarray(enc)))


def test_model_has_the_encoder_and_cross_layers():
    params, cfg, model = _setup()
    assert cfg.is_encoder_decoder and len(model.enc_layers) == 2
    assert all(not b.spec.causal and not b.spec.cross_attn
               for b in model.enc_layers)
    assert all(b.spec.cross_attn and hasattr(b, "cross")
               for b in model.layers)
    assert model.param_count() == T.param_count(params)
    assert model.active_param_count() == T.active_param_count(JCFG, params)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_cross_attention_matches_repro(pallas):
    """``Attention(memory=)`` against ``repro``'s ``attention(memory=)``:
    the output, and K/V equal to ``memory @ wk`` / ``memory @ wv``
    reshaped; then the one-token cross decode against
    ``attention_decode(memory_kv=)``."""
    params, cfg, model = _setup()
    p = jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["cross"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    mem = rng.standard_normal((2, 10, cfg.d_model), dtype=np.float32)
    j_layers.set_pallas_attention(True if pallas else None)
    try:
        want, (wk, wv) = j_layers.attention(p, jnp.asarray(x), JCFG,
                                            memory=jnp.asarray(mem),
                                            return_kv=True)
    finally:
        j_layers.set_pallas_attention(None)
    cross = model.layers[0].cross
    got, (k, v) = cross(torch.from_numpy(x), memory=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), rtol=0,
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=0,
                               atol=LAYER_ATOL)
    hkv, hd = cfg.n_kv_heads, cfg.hd
    m = torch.from_numpy(mem)
    assert torch.equal(k, (m @ cross.wk).view(2, 10, hkv, hd))
    assert torch.equal(v, (m @ cross.wv).view(2, 10, hkv, hd))
    # cross decode: no RoPE (any position), every memory slot valid
    x1 = x[:, :1]
    dummy = {"k": jnp.zeros((2, 4, hkv, hd)), "v": jnp.zeros((2, 4, hkv, hd))}
    want1, _ = j_layers.attention_decode(
        p, jnp.asarray(x1), dummy, jnp.asarray(17, jnp.int32), JCFG,
        memory_kv=(wk, wv))
    got1 = cross.decode_cross(torch.from_numpy(x1), torch.from_numpy(
        np.asarray(wk)), torch.from_numpy(np.asarray(wv)))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=0,
                               atol=LAYER_ATOL)


def test_encode_matches_repro():
    params, cfg, model = _setup()
    _, emb = _inputs()
    want = _repro_memory(params, emb["enc_embeds"])
    got = model.encode(torch.from_numpy(emb["enc_embeds"])).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LAYER_ATOL * np.abs(want).max())


def _port_greedy():
    if "port" not in _cache:
        params, cfg, model = _setup()
        tokens, emb = _inputs()
        _cache["port"] = lp.port_greedy(model, tokens, emb=emb)
    return _cache["port"]


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_greedy_decode_matches_repro(pallas):
    """A prefill and 8 greedy steps: equal ids, logits within 1e-4; the
    prefill's cache (self K/V and the cross 'l0_xk' / 'l0_xv') through
    ``kv_cache_to_numpy`` within 1e-5 of ``repro``'s."""
    params, cfg, model = _setup()
    tokens, emb = _inputs()
    want = lp.repro_greedy(JCFG, params, tokens, pallas=pallas, emb=emb)
    got = _port_greedy()
    lp.assert_greedy_close(got, want, ATOL)
    assert sorted(got[2]) == sorted(want[2]) == ["l0", "l0_xk", "l0_xv"]
    for key, w in want[2].items():
        g = got[2][key]
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            pairs = [(g[n], w[n]) for n in w]
        else:
            pairs = [(g, w)]
        for a, b in pairs:
            assert a.shape == b.shape and a.dtype == b.dtype, key
            np.testing.assert_allclose(a, b, rtol=0, atol=LAYER_ATOL,
                                       err_msg=key)


def test_decode_from_repros_cache():
    """``repro``'s prefill cache into the port (``kv_cache_from_numpy``):
    the port's decode steps from it give ``repro``'s logits, and the cache
    converts back exactly."""
    params, cfg, model = _setup()
    tokens, emb = _inputs()
    w_logits, w_ids, cache0 = lp.repro_greedy(JCFG, params, tokens,
                                              pallas=False, emb=emb)
    cache = interop.kv_cache_from_numpy(cfg, cache0, device="cpu")
    assert all(set(c) == {"k", "v", "xk", "xv"} for c in cache)
    back = interop.kv_cache_to_numpy(cfg, cache)
    assert back.keys() == cache0.keys()
    np.testing.assert_array_equal(back["l0_xk"], cache0["l0_xk"])
    np.testing.assert_array_equal(back["l0"]["v"], cache0["l0"]["v"])
    s = lp.positions(tokens, emb)
    for i in range(lp.STEPS):
        tok = torch.from_numpy(w_ids[:, i:i + 1]).long()
        logits, cache = model.decode_step(cache, tok, s + i)
        np.testing.assert_allclose(logits.numpy(), w_logits[i + 1], rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")


def test_init_cache_and_prefill_cross_cache_match_repro():
    """``init_cache(memory_len=)``: ``repro``'s entries and shapes, all 0;
    ``prefill_cross_cache`` writes ``repro``'s cross K/V of the same
    memory, cast to the cache's dtype (a bf16 cross cache holds the f32
    product rounded once)."""
    params, cfg, model = _setup()
    _, emb = _inputs()
    mem = _repro_memory(params, emb["enc_embeds"])
    sm = mem.shape[1]
    jc = T.init_cache(JCFG, 2, 16, jnp.float32, memory_len=sm)
    cache = model.init_cache(2, 16, memory_len=sm)
    zero = interop.kv_cache_to_numpy(cfg, cache)
    assert zero.keys() == jc.keys()
    for key in jc:
        for w, g in zip(jax.tree.leaves(jc[key]), jax.tree.leaves(zero[key])):
            assert g.shape == w.shape and not g.any()
    assert not model.init_cache(2, 16)[0].keys() & {"xk", "xv"}
    want = jax.tree.map(np.asarray, T.prefill_cross_cache(
        JCFG, params, jc, jnp.asarray(mem)))
    got = interop.kv_cache_to_numpy(cfg, model.prefill_cross_cache(
        cache, torch.from_numpy(mem)))
    for n in ("l0_xk", "l0_xv"):
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=LAYER_ATOL)
    np.testing.assert_array_equal(got["l0"]["k"], want["l0"]["k"])
    for c in cache:
        c["xk"] = c["xk"].to(torch.bfloat16)
        c["xv"] = c["xv"].to(torch.bfloat16)
    bf = model.prefill_cross_cache(cache, torch.from_numpy(mem))
    assert bf[0]["xk"].dtype == torch.bfloat16
    assert torch.equal(bf[1]["xv"], torch.from_numpy(got["l0_xv"][1]).to(
        torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    """``repro``'s params into the port and back (``enc_blocks``,
    ``enc_norm``, ``cross_norm`` and ``cross`` included): the same tree
    and values, each parameter in its leaf's dtype."""
    params = T.init_params(JCFG, jax.random.key(1), getattr(jnp, dtype))
    tree = jax.tree.map(np.asarray, params)
    cfg = interop.arch_from_fields(dataclasses.asdict(JCFG))
    model = interop.lm_params_from_numpy(cfg, tree, device="cpu",
                                         dtype=getattr(torch, dtype))
    named = dict(model.named_parameters())
    assert {"enc_norm.scale", "enc_layers.1.mixer.wq",
            "layers.0.cross.wk", "layers.1.cross_norm.scale"} <= named.keys()
    back = interop.lm_params_to_numpy(model)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    assert all(p.dtype == getattr(torch, dtype) for p in named.values())


def test_cache_round_trip_in_bf16():
    params, cfg, model = _setup()
    tokens, emb = _inputs()
    _, want = lp.repro_prefill(JCFG, params, tokens[:, :12], max_len=16,
                               pallas=False, emb=emb)
    cache = interop.kv_cache_from_numpy(cfg, want, device="cpu",
                                        dtype=torch.bfloat16)
    assert cache[0]["xk"].dtype == torch.bfloat16
    back = interop.kv_cache_to_numpy(cfg, cache)
    for n in ("l0_xk", "l0_xv"):
        np.testing.assert_array_equal(
            back[n], torch.tensor(want[n]).bfloat16().float().numpy())


def test_train_step_matches_repro():
    """One AdamW step of ``make_train_step`` from ``repro``'s params and
    ``OptState`` (``_lm_parity.train_step_parity``'s bounds): the memory's
    gradient reaches the encoder through every cross layer, so the
    encoder's parameters move as ``repro``'s."""
    before, _, after, n_far = lp.train_step_parity(JCFG)
    moved = after["enc_blocks"]["l0"]["mixer"]["wq"] - np.asarray(
        before["enc_blocks"]["l0"]["mixer"]["wq"])
    assert np.abs(moved).max() > 5e-4
    assert n_far <= 1e-4 * sum(a.size for a in jax.tree.leaves(after))


def test_full_size_parameter_count():
    """seamless-m4t-large-v2 at full size (24 + 24 layers, vocab 256,206
    padded to 256,256) has ``repro``'s parameter count (on the meta
    device)."""
    jcfg = j_get_arch(NAME)
    shapes = jax.eval_shape(lambda k: T.init_params(jcfg, k),
                            jax.random.key(0))
    meta = Transformer(t_arch.get_arch(NAME), device="meta")
    assert meta.param_count() == T.param_count(shapes) == 2_034_886_656
    assert meta.active_param_count() == T.active_param_count(jcfg, shapes)
    assert jcfg.padded_vocab == 256_256


def test_prefill_step_passes_the_encoder_frames():
    from repro_torch.launch import shapes as t_shapes
    from repro_torch.launch import steps as tsteps

    params, cfg, model = _setup()
    tokens, emb = _inputs()
    batch = {"tokens": torch.from_numpy(tokens).long(), **lp.as_torch(emb)}
    logits, cache = tsteps.make_prefill_step(
        cfg, t_shapes.InputShape("cli", "prefill", lp.S, 2))(model, batch)
    want, _ = model.prefill(batch["tokens"], **lp.as_torch(emb))
    assert torch.equal(logits, want) and "xk" in cache[0]
