"""The port's LM serving path against ``repro``'s on the same weights.

``repro.models.transformer.init_params`` draws the weights; they cross
over as numpy (``interop.lm_params_from_numpy``), and the prompts come
from a numpy seed. Everything runs in f32 on the CPU, where the port's
kernel wrappers run their plain versions. Logits agree within
``atol=1e-4`` (f32 sums in another order through a few layers of
attention and MLP, on logits of order 1) and the greedy ids are equal.
``repro`` is run on both of its attention routes: the Pallas
``flash_prefill`` kernel in interpret mode, as ``tests/test_models.py``
runs it, and its default jnp route.
"""
import dataclasses
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as j_layers
from repro.models import transformer as T
from repro.models.arch import ArchConfig as JArchConfig
from repro.models.arch import LayerSpec as JLayerSpec
from repro.models.arch import get_arch as j_get_arch
from repro.models.arch import list_archs as j_list_archs
from repro_torch import interop, kernels
from repro_torch.launch import serve as t_serve
from repro_torch.models import arch as t_arch
from repro_torch.models.transformer import Transformer

ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: GQA with groups of 4 (granite-8b's reduced config has 4 heads over 4 KV
#: heads, so G = 1); vocab 500 pads to 512, so padding ids are masked
GQA = JArchConfig(name="gqa-test", family="dense", n_layers=2, d_model=128,
                  n_heads=8, n_kv_heads=2, d_ff=256, vocab=500, head_dim=32,
                  pattern=(JLayerSpec(mixer="attn", ff="mlp"),),
                  rope_theta=1e4)
CONFIGS = {"gqa": GQA, "granite-8b-reduced": j_get_arch("granite-8b").reduced()}

_cache: dict = {}


def _setup(name: str):
    """(repro cfg, repro params, port cfg, port model), built once."""
    if name not in _cache:
        jcfg = CONFIGS[name]
        params = T.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, params)
        cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
        model = interop.lm_params_from_numpy(cfg, tree, device="cpu")
        _cache[name] = (jcfg, params, cfg, model)
    return _cache[name]


def _prompts(cfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _j_prefill(jcfg, params, tokens, *, window, max_len, pallas: bool):
    j_layers.set_pallas_attention(True if pallas else None)
    try:
        logits, cache, _ = T.prefill(jcfg, params, jnp.asarray(tokens),
                                     window=window, max_len=max_len)
        return np.asarray(logits), jax.tree.map(np.asarray, cache)
    finally:
        j_layers.set_pallas_attention(None)


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_repro(name, pallas):
    jcfg, params, cfg, model = _setup(name)
    tokens = _prompts(cfg, 2, 40)
    want_logits, want_cache = _j_prefill(jcfg, params, tokens, window=0,
                                         max_len=48, pallas=pallas)
    logits, cache = model.prefill(torch.from_numpy(tokens).long(),
                                  max_len=48)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), want_logits, atol=ATOL, rtol=0)
    got_cache = interop.kv_cache_from_numpy(cfg, want_cache, device="cpu")
    assert len(cache) == cfg.n_layers
    for c, w in zip(cache, got_cache):
        for n in ("k", "v"):
            assert c[n].shape == w[n].shape == (2, 48, cfg.n_kv_heads, cfg.hd)
            np.testing.assert_allclose(_np(c[n]), _np(w[n]), atol=ATOL,
                                       rtol=0)
    if cfg.padded_vocab > cfg.vocab:
        assert (logits[..., cfg.vocab:] == -1e30).all()
    for window in (0, 16):  # init_cache: repro's slots, one dict per layer
        want = T.init_cache(jcfg, 2, 48, jnp.float32, window=window)["l0"]
        got = model.init_cache(2, 48, window=window)
        assert len(got) == cfg.n_layers
        assert tuple(got[0]["k"].shape) == want["k"].shape[1:]
        assert (got[-1]["v"] == 0).all()


#: prompt batch, prompt length and greedy steps of the decode tests
B, S, STEPS = 2, 40, 8


def _j_greedy(name: str, window: int, pallas: bool = False):
    """``repro``'s prefill (on the Pallas or the jnp attention route) +
    STEPS greedy ``decode_step``s on the seed-2 prompts: (logits of each
    step, (B, STEPS + 1) greedy ids), memoised."""
    key = (name, "greedy", window, pallas)
    if key not in _cache:
        jcfg, params, cfg, _ = _setup(name)
        tokens = _prompts(cfg, B, S, seed=2)
        logits, cache = _j_prefill(jcfg, params, tokens, window=window,
                                   max_len=S + STEPS, pallas=pallas)
        step = jax.jit(lambda p, c, t, pos: T.decode_step(
            jcfg, p, c, t, pos, window=window))
        cache = jax.tree.map(jnp.asarray, cache)
        all_logits, ids = [np.asarray(logits)], []
        for i in range(STEPS):
            tok = jnp.argmax(all_logits[-1][:, -1], axis=-1)[:, None]
            ids.append(np.asarray(tok))
            logits, cache = step(params, cache, tok.astype(jnp.int32),
                                 jnp.asarray(S + i, jnp.int32))
            all_logits.append(np.asarray(logits))
        ids.append(np.argmax(all_logits[-1][:, -1], axis=-1)[:, None])
        _cache[key] = (all_logits, np.concatenate(ids, axis=1))
    return _cache[key]


@pytest.mark.parametrize("name,window,pallas", [
    ("gqa", 0, False), ("gqa", 48, False),
    ("granite-8b-reduced", 0, False), ("granite-8b-reduced", 48, False),
    ("gqa", 48, True)],
    ids=["gqa-full", "gqa-window", "granite-8b-reduced-full",
         "granite-8b-reduced-window", "gqa-window-pallas"])
def test_greedy_decode_matches_repro(name, window, pallas):
    """8 greedy steps after a 40-token prompt. With a window (48 >= the
    prompt) both packages keep a 40-slot ring buffer: the windowed prefill
    does not pad its cache, so the decode wraps it from the first step.
    ``repro``'s prefill runs on its jnp route, and once on its Pallas
    route (interpret mode)."""
    _, _, cfg, model = _setup(name)
    want_logits, want_ids = _j_greedy(name, window, pallas)
    tokens = torch.from_numpy(_prompts(cfg, B, S, seed=2)).long()
    logits, cache = model.prefill(tokens, window=window, max_len=S + STEPS)
    assert cache[0]["k"].shape[1] == (S if window else S + STEPS)
    for i in range(STEPS + 1):
        np.testing.assert_allclose(_np(logits), want_logits[i], atol=ATOL,
                                   rtol=0)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        np.testing.assert_array_equal(_np(tok), want_ids[:, i:i + 1])
        if i < STEPS:
            logits, cache = model.decode_step(cache, tok, S + i,
                                              window=window)


@pytest.mark.parametrize("pos,window,sbuf", [
    (37, 16, 16),   # a wrapped ring buffer: every slot valid, out of order
    (9, 16, 16),    # a ring buffer not yet full: the first pos + 1 slots
    (20, 0, 32),    # unwindowed prefix
    (40, 0, 32),    # unwindowed, past the buffer: the last slot rewritten
])
def test_attention_decode_matches_kernel_route(pos, window, sbuf):
    """``repro``'s einsum ``attention_decode`` and the port's route through
    ``decode_attention`` (the cache transposed, no copy; ``pos`` the count
    of valid slots, ``min(pos + 1, Sbuf)``; no window) compute the same
    output and the same updated cache."""
    jcfg, params, cfg, model = _setup("gqa")
    rng = np.random.default_rng(pos + sbuf)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, sbuf, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["mixer"])
    want, want_cache = j_layers.attention_decode(
        jp, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(pos, jnp.int32), jcfg, window=window)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got = model.layers[0].mixer.decode(torch.from_numpy(x), cache, pos,
                                       window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(cache[n]), np.asarray(want_cache[n]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [0, 48], ids=["full", "window"])
def test_serve_matches_repro_greedy_ids(window):
    """``serve`` (prefill + gen - 1 decode steps) gives ``repro``'s greedy
    ids on ``repro``'s weights."""
    _, _, cfg, model = _setup("gqa")
    _, want_ids = _j_greedy("gqa", window)
    tokens = torch.from_numpy(_prompts(cfg, B, S, seed=2)).long()
    res = t_serve.serve(model, tokens, gen=STEPS + 1, window=window)
    assert res.ids.shape == (B, STEPS + 1) and res.logits_finite
    assert res.prefill_s > 0 and res.decode_s > 0
    np.testing.assert_array_equal(_np(res.ids), want_ids)


def test_serve_main_end_to_end(capsys):
    res = t_serve.main(["--arch", "granite-8b", "--reduced", "--device",
                        "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
                        "5"])
    assert res.ids.shape == (2, 5) and res.logits_finite
    assert int(res.ids.max()) < 1024
    out = capsys.readouterr().out
    assert "arch=granite-8b" in out and "dtype=torch.float32" in out
    assert "prefill:" in out and "decode :" in out
    # repro's size check: a 2x1 mesh on a one-rank world
    with pytest.raises(ValueError, match="requested 2x1 mesh on 1 devices"):
        t_serve.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                      "--data-par", "2"])


def test_serve_counts_attention_calls_on_the_cpu():
    """On the CPU the serving path runs the plain versions: no launch is
    counted, and the port never falls back to them on a card."""
    _, _, cfg, model = _setup("gqa")
    before = kernels.launches()
    t_serve.serve(model, torch.zeros(1, 8, dtype=torch.long), gen=3)
    assert kernels.launches() == before


def test_init_draws_repros_distributions():
    """The port draws its own weights (a torch.Generator, not jax.random)
    from ``repro``'s distributions and shapes; granite-8b at full width
    has ``repro``'s parameter count (counted on the meta device)."""
    cfg = interop.arch_from_fields(dataclasses.asdict(GQA))
    gen = torch.Generator().manual_seed(0)
    model = Transformer(cfg, device="cpu", generator=gen)
    d = cfg.d_model
    assert abs(float(model.embed.std()) - 0.02) < 0.002
    assert abs(float(model.unembed.std()) - d ** -0.5) < 0.1 * d ** -0.5
    blk = model.layers[0]
    assert abs(float(blk.mixer.wq.std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(blk.ff.w_down.std()) - cfg.d_ff ** -0.5) < \
        0.1 * cfg.d_ff ** -0.5
    assert (blk.mixer_norm.scale == 1).all()
    assert not any(p.requires_grad for p in model.parameters())
    params = T.init_params(GQA, jax.random.key(0))
    assert model.param_count() == T.param_count(params)

    full = j_get_arch("granite-8b")
    shapes = jax.eval_shape(lambda k: T.init_params(full, k),
                            jax.random.key(0))
    meta = Transformer(t_arch.get_arch("granite-8b"), device="meta")
    assert meta.param_count() == T.param_count(shapes)
    assert 8.1e9 < meta.param_count() < 8.3e9


@pytest.mark.parametrize("name", ["granite-8b", "granite-34b", "stablelm-3b",
                                  "mistral-nemo-12b", "qwen2-moe-a2.7b",
                                  "mamba2-370m", "jamba-1.5-large-398b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-large-v2",
                                  "llama4-scout-17b-a16e"])
def test_dense_configs_are_copies(name):
    """Every field ``repro``'s ArchConfig has is ``repro``'s, full and
    reduced; the port's own fields (NoPE, the attention scale, the muP
    multipliers, the dropless MoE) hold their neutral defaults."""
    for t, j in ((t_arch.get_arch(name), j_get_arch(name)),
                 (t_arch.get_arch(name).reduced(),
                  j_get_arch(name).reduced())):
        tf, jf = dataclasses.asdict(t), dataclasses.asdict(j)
        assert {k: tf[k] for k in jf} == jf
        assert {k: tf[k] for k in set(tf) - set(jf)} == PORT_ONLY_FIELDS


#: the port's ArchConfig fields ``repro``'s lacks, at their neutral values
PORT_ONLY_FIELDS = {"positional": "rope", "attention_multiplier": 0.0,
                    "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
                    "logits_scaling": 1.0, "moe_dropless": False}


def test_every_registered_arch_is_ported():
    """Every ``repro`` architecture is in the port; the port's own are
    exactly granite-4.0-h-small."""
    ported, jax = set(t_arch.list_archs()), set(j_list_archs())
    assert jax <= ported
    assert ported - jax == {"granite-4.0-h-small"}


@pytest.mark.parametrize("name,p", [("llava-next-mistral-7b", 8),
                                    ("llama4-scout-17b-a16e", 8),
                                    ("seamless-m4t-large-v2", 0)])
def test_serve_main_runs_the_stubs(name, p, capsys, monkeypatch):
    """``main`` serves the vision-prefixed and encoder-decoder models
    (reduced, on the CPU): ids in the vocab, the decode steps at positions
    S + P + i after a prefix of P = 8 patch rows (0 for seamless, whose
    frames go to its encoder)."""
    seen = []
    real = Transformer.decode_step

    def decode_step(self, cache, token, pos, **kw):
        seen.append(pos)
        if self.cfg.is_encoder_decoder:
            assert all(c["xk"].shape[1] == 8 for c in cache)  # max(16//4, 8)
        return real(self, cache, token, pos, **kw)

    monkeypatch.setattr(Transformer, "decode_step", decode_step)
    res = t_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "5"])
    assert res.ids.shape == (2, 5) and res.logits_finite
    assert 0 <= int(res.ids.min()) and int(res.ids.max()) < \
        j_get_arch(name).reduced().vocab
    assert seen == [16 + p + i for i in range(4)]
    assert f"arch={name}" in capsys.readouterr().out


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_arch.get_arch("granite-8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.build("granite-8b", reduced=True)


def test_lm_modules_import_neither_jax_nor_repro():
    """A grep over the LM slice's modules (the whole package and
    ``chip_smoke.py`` are covered by ``test_torch_interop.py``)."""
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
        re.MULTILINE)
    src = os.path.join(ROOT, "src", "repro_torch")
    files = [os.path.join(src, *p.split("/")) for p in (
        "models/arch.py", "models/layers.py", "models/transformer.py",
        "launch/serve.py", "kernels/flash_prefill.py",
        "kernels/decode_attention.py", "kernels/ref.py", "interop.py",
        "configs/granite_8b.py", "configs/qwen2_moe_a2_7b.py",
        "configs/mamba2_370m.py", "configs/jamba_1_5_large_398b.py",
        "configs/llava_next_mistral_7b.py",
        "configs/llama4_scout_17b_a16e.py",
        "configs/seamless_m4t_large_v2.py", "launch/steps.py",
        "launch/train.py")] + [
            os.path.join(ROOT, "chip_smoke.py")]
    for f in files:
        text = open(f).read()
        assert not pattern.search(text), f
        assert "jax" not in re.sub(r"#.*|\"\"\"[\s\S]*?\"\"\"", "", text), f
