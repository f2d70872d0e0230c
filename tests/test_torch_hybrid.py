"""Reduced jamba-1.5-large-398b (attention, Mamba2, MLP and MoE sublayers
in one 8-sublayer period), ``interop``'s round trips for the MoE, SSM and
hybrid configs, and one train step of reduced qwen2-moe-a2.7b and
mamba2-370m, against ``repro`` on the CPU in f32.

Tolerances, from the measured differences:

* jamba: equal greedy ids and logits within ``1e-3`` over a prefill and
  8 decode steps, on both of ``repro``'s attention routes (measured
  ~3.7e-4). Its 12 Mamba2 layers sit at the f32 SSD scan's noise floor:
  in_proj's f32 sums, in another order than XLA's, move the scan's
  inputs by ~1e-6 relative, and the gate and RMSNorm carry that to ~2e-5
  a layer; against the port with its whole scan in f64, the port is
  ~9.2e-5 off on these logits and ``repro`` ~3.4e-4. ``1e-3`` is the
  bound ``tests/test_models.py`` holds ``repro``'s own decode to. The
  prefill's caches: ``2e-4`` of each entry's largest value (at least 1;
  measured 4.5e-5 on the deepest conv tails);
* round trips: exact, each leaf in its dtype;
* one ``make_train_step``: loss, ``moe_aux`` and grad norm within
  ``rtol=2e-6`` (qwen2-moe; ``tests/test_torch_train.py``'s bound) and
  ``2e-5`` (mamba2: the scan's noise through the gradient; measured
  ~5e-6), the learning rate exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _lm_parity as lp
from repro import optim as jo
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch import steps as jsteps
from repro.launch.shapes import InputShape as JInputShape
from repro.models import transformer as T
from repro.models.arch import get_arch as j_get_arch
from repro_torch import interop
from repro_torch import optim as to
from repro_torch.launch import shapes as t_shapes
from repro_torch.launch import steps as tsteps

JAMBA_ATOL = 1e-3
NAMES = ("qwen2-moe-a2.7b", "mamba2-370m", "jamba-1.5-large-398b")
JCFGS = {n: j_get_arch(n).reduced() for n in NAMES}
#: leaves that stay f32 in a bf16 model
F32_LEAVES = ("router", "a_log", "dt_bias", "ssm_d")

_cache: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    if name not in _cache:
        _cache[name] = lp.setup(JCFGS[name])
    return _cache[name]


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_jamba_greedy_decode_matches_repro(pallas):
    jcfg = JCFGS["jamba-1.5-large-398b"]
    params, cfg, model = _setup("jamba-1.5-large-398b")
    kinds = {(l.spec.mixer, l.spec.ff) for l in model.layers}
    assert kinds == {("attn", "mlp"), ("mamba", "mlp"), ("mamba", "moe")}
    tokens = lp.prompts(cfg)
    if "jamba-port" not in _cache:
        _cache["jamba-port"] = lp.port_greedy(model, tokens)
    got = _cache["jamba-port"]
    want = lp.repro_greedy(jcfg, params, tokens, pallas=pallas)
    lp.assert_greedy_close(got, want, JAMBA_ATOL)
    for key, entry in want[2].items():
        for n, w in entry.items():
            np.testing.assert_allclose(got[2][key][n], w, rtol=0,
                                       atol=2e-4 * max(np.abs(w).max(), 1))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _dtype_name(a) -> str:
    return str(a.dtype).split(".")[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip_keeps_each_leafs_dtype(name, dtype):
    """``repro``'s params (f32, or bf16 with its f32 leaves) into the port
    and back: the same tree, the same values, and every port parameter
    in the dtype of its ``repro`` leaf."""
    jcfg = JCFGS[name]
    params = T.init_params(jcfg, jax.random.key(1), getattr(jnp, dtype))
    tree = jax.tree.map(np.asarray, params)
    cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
    model = interop.lm_params_from_numpy(cfg, tree, device="cpu",
                                         dtype=getattr(torch, dtype))
    back = interop.lm_params_to_numpy(model)
    want, got = _leaves(tree), _leaves(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    named = dict(model.named_parameters())
    for i, (key, rep) in enumerate(interop._layer_index(cfg)):
        for port_name, path in interop._layer_leaves(
                cfg, cfg.pattern[int(key[1:])]):
            leaf = params["blocks"][key]
            for k in path:
                leaf = leaf[k]
            p = named[f"layers.{i}.{port_name}"]
            assert _dtype_name(p) == _dtype_name(leaf), port_name
            if path[-1] in F32_LEAVES:
                assert p.dtype == torch.float32
    assert model.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("name", NAMES)
def test_opt_state_round_trip(name):
    """An ``OptState`` with distinct moments in every leaf into the port's
    AdamW and back, exactly."""
    params, cfg, model = _setup(name)
    rng = np.random.default_rng(3)
    state = {"step": np.int32(5), "moments": {
        m: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params) for m in ("mu", "nu")}}
    opt = to.AdamW(model.parameters())
    interop.opt_state_from_numpy(cfg, model, opt, state)
    back = interop.opt_state_to_numpy(cfg, model, opt)
    assert int(back["step"]) == 5
    for m in ("mu", "nu"):
        want, got = _leaves(state["moments"][m]), _leaves(back["moments"][m])
        assert [p for p, _ in want] == [p for p, _ in got]
        for (path, w), (_, g) in zip(want, got):
            np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_cache_round_trip(name, dtype):
    """``repro``'s prefill cache into the port's per-layer list and back:
    K/V and conv tails in ``dtype``, the SSM state f32, values equal."""
    params, cfg, model = _setup(name)
    tokens = lp.prompts(cfg, s=12, seed=5)
    _, want = lp.repro_prefill(JCFGS[name], params, tokens, max_len=16,
                               pallas=False)
    tdt = getattr(torch, dtype)
    cache = interop.kv_cache_from_numpy(cfg, want, device="cpu", dtype=tdt)
    assert len(cache) == cfg.n_layers
    for c, blk in zip(cache, model.layers):
        names = ("k", "v") if blk.spec.mixer == "attn" else ("conv", "ssm")
        assert tuple(c) == names
        for n in names:
            assert c[n].dtype == (torch.float32 if n == "ssm" else tdt)
    back = interop.kv_cache_to_numpy(cfg, cache)
    assert back.keys() == want.keys()
    for key in want:
        for n, w in want[key].items():
            if dtype == "bfloat16" and n != "ssm":
                w = torch.tensor(w).to(tdt).float().numpy()
            np.testing.assert_array_equal(back[key][n], w)
    zero = interop.kv_cache_to_numpy(cfg, model.init_cache(2, 16))
    want_zero = T.init_cache(JCFGS[name], 2, 16, jnp.float32)
    for key in want_zero:
        for n, w in want_zero[key].items():
            assert zero[key][n].shape == w.shape and not zero[key][n].any()


B, S, LR = 2, 64, 1e-3


@pytest.mark.parametrize("name,rtol", [("qwen2-moe-a2.7b", 2e-6),
                                       ("mamba2-370m", 2e-5)])
def test_train_step_matches_repro(name, rtol):
    """One AdamW step of ``make_train_step`` from ``repro``'s params and
    ``OptState`` on ``repro``'s ``TokenStream`` batch (at capacity 1.25,
    so qwen2-moe drops assignments in the step)."""
    jcfg = JCFGS[name]
    params = T.init_params(jcfg, jax.random.key(0))
    jopt = jo.adamw()
    state = jopt.init(params)
    cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
    model = interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    model.requires_grad_(True)
    opt = to.AdamW(model.parameters())
    interop.opt_state_from_numpy(cfg, model, opt,
                                 jax.tree.map(np.asarray, state._asdict()))
    nb = JTokenStream(vocab=jcfg.vocab, seq_len=S, global_batch=B,
                      seed=0).batch(0)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JInputShape("cli", "train", S, B), jopt,
        jo.linear_warmup_cosine(LR, 0, 2)))
    _, _, jm = jstep(params, state, {k: jnp.asarray(v) for k, v in nb.items()})
    tstep = tsteps.make_train_step(
        cfg, t_shapes.InputShape("cli", "train", S, B),
        to.linear_warmup_cosine(LR, 0, 2))
    batch = {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32
                                       else torch.float32)
             for k, v in nb.items()}
    tm = tstep(model, opt, batch)
    assert float(tm["lr"]) == float(jm["lr"])
    for k in ("loss", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    assert (float(tm["moe_aux"]) > 0) == (name == "qwen2-moe-a2.7b")


@pytest.mark.parametrize("name", NAMES)
def test_serve_main_runs_the_family(name, capsys):
    from repro_torch.launch import serve as t_serve

    res = t_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert res.ids.shape == (2, 4) and res.logits_finite
    assert int(res.ids.max()) < JCFGS[name].vocab
    assert f"arch={name}" in capsys.readouterr().out
