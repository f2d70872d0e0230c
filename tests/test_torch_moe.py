"""The port's MoE feed-forward and reduced qwen2-moe-a2.7b against
``repro``'s, on the CPU, in f32, on the same weights and inputs.

Tolerances, from the measured differences:

* routing: equal expert ids; gates and router probabilities within
  ``1e-6`` (f32 softmax and the gate normalisation in another order);
* the layer: equal dropped assignments; output within ``1e-5`` and aux
  within ``rtol=1e-6``. The port gathers each token's k slot outputs and
  adds them in ascending expert order, the order of ``repro``'s
  slot-order scatter-add; what differs is the expert products' and the
  router's f32 sums (measured ~2e-6 on outputs of order 1);
* the model: equal greedy ids and logits within ``1e-4`` over a prefill
  and 8 decode steps (measured ~5e-6), on both of ``repro``'s attention
  routes, at capacity factor 64 (no drops) and 1.25 (drops).
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
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import Transformer

ATOL = 1e-4
BASE = j_get_arch("qwen2-moe-a2.7b").reduced()
#: capacity factor 64: every assignment fits; 1.25: the reduced config's
#: 4 real experts of 16 padded overflow their slots at B x S = 80 tokens
CONFIGS = {"cap64": dataclasses.replace(BASE, moe_capacity_factor=64.0),
           "cap1.25": BASE}

_cache: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    if name not in _cache:
        _cache[name] = lp.setup(CONFIGS[name])
    return _cache[name]


def _layer(name):
    """(repro's first MoE params, the port's MoE module, port cfg)."""
    params, cfg, model = _setup(name)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["ff"])
    return jp, model.layers[0].ff, cfg


def _x(cfg, t, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (t, cfg.d_model)).astype(np.float32)


def test_route_matches_repro():
    jp, moe, cfg = _layer("cap1.25")
    x = _x(cfg, 300)
    want_gate, want_ids, want_probs = j_layers._route(jp, jnp.asarray(x),
                                                      BASE)
    gate, ids, probs = moe.route(torch.from_numpy(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(gate.numpy(), np.asarray(want_gate),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs),
                               atol=1e-6, rtol=0)
    assert gate.dtype == probs.dtype == torch.float32
    assert (ids < cfg.moe_experts).all()       # padding experts never win
    assert (probs[:, cfg.moe_experts:] == 0).all()


def _repro_keep(exp_ids: np.ndarray, e: int, cap: int) -> np.ndarray:
    """Which (token, expert) assignments ``repro``'s ``_dispatch_ffn``
    keeps, read from its output: one hidden unit a constant h for every
    expert, expert e's down-projection the unit vector e / h, all gates 1,
    so token t's output is the sum of the unit vectors of its kept
    experts."""
    t, k = exp_ids.shape
    xf = jnp.ones((t, e), jnp.float32)
    wgate = jnp.full((e, e, 1), 1.0 / e)
    wi = jnp.full((e, e, 1), 1.0 / e)
    h = float(jax.nn.silu(1.0))
    wdown = jnp.eye(e)[:, None, :] / h
    out = j_layers._dispatch_ffn(xf, jnp.ones((t, k)), jnp.asarray(exp_ids),
                                 wgate, wi, wdown, cap)
    keep = np.rint(np.asarray(out)).astype(np.int64)
    assert set(np.unique(keep)) <= {0, 1}
    return keep.astype(bool)


@pytest.mark.parametrize("t", [80, 300])
def test_moe_drops_exactly_repros_assignments(t):
    jp, moe, cfg = _layer("cap1.25")
    x = _x(cfg, t, seed=t)
    _, ids, _ = moe.route(torch.from_numpy(x))
    e = cfg.padded_experts
    cap = t_layers.moe_capacity(cfg, t, e)
    assert cap == j_layers._capacity(BASE, t, e)
    slot, counts = t_layers.moe_slots(ids, e, cap)
    kept = np.zeros((t, e), bool)
    flat_t = np.arange(t * cfg.moe_top_k) // cfg.moe_top_k
    mine = (slot < e * cap).numpy()
    kept[flat_t[mine], ids.reshape(-1).numpy()[mine]] = True
    want = _repro_keep(ids.numpy(), e, cap)
    np.testing.assert_array_equal(kept, want)
    assert (~mine).sum() > 0                   # the case drops for real
    assert int(moe.dropped(torch.from_numpy(x)[None])) == (~mine).sum()
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(ids.reshape(-1).numpy(), minlength=e))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_matches_repro(name):
    jp, moe, cfg = _layer(name)
    x = _x(cfg, 2 * 40, seed=5).reshape(2, 40, cfg.d_model)
    want, want_aux = j_layers.moe(jp, jnp.asarray(x), CONFIGS[name])
    got, aux = moe(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    # drops happen at 1.25 and not at 64, by repro's own routing
    t, e = 80, cfg.padded_experts
    _, ids, _ = j_layers._route(jp, jnp.asarray(x.reshape(t, -1)), BASE)
    per_expert = np.bincount(np.asarray(ids).reshape(-1), minlength=e)
    dropped = np.maximum(per_expert - j_layers._capacity(
        CONFIGS[name], t, e), 0).sum()
    assert (dropped > 0) == (name == "cap1.25")


def _repro_greedy(name, pallas):
    key = (name, "greedy", pallas)
    if key not in _cache:
        params, cfg, _ = _setup(name)
        _cache[key] = lp.repro_greedy(CONFIGS[name], params,
                                      lp.prompts(cfg), pallas=pallas)
    return _cache[key]


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_decode_matches_repro(name, pallas):
    """Reduced qwen2-moe: a 40-token prefill and 8 greedy decode steps
    (each step routes the batch's 2 tokens together), the prefill's
    caches equal."""
    _, cfg, model = _setup(name)
    want = _repro_greedy(name, pallas)
    got = lp.port_greedy(model, lp.prompts(cfg))
    lp.assert_greedy_close(got, want, ATOL)
    for key, entry in want[2].items():
        for n in ("k", "v"):
            np.testing.assert_allclose(got[2][key][n], entry[n], atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_aux_match_repro(name):
    params, cfg, model = _setup(name)
    tokens = lp.prompts(cfg, seed=4)
    want_h, want_aux = T.forward(CONFIGS[name], params, jnp.asarray(tokens))
    h, aux = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert aux.dtype == torch.float32 and float(aux) > 0


def test_active_param_count_matches_repro():
    params, _, model = _setup("cap1.25")
    assert model.param_count() == T.param_count(params)
    assert model.active_param_count() == T.active_param_count(BASE, params)
    assert 0 < model.active_param_count() < model.param_count()
    full = j_get_arch("qwen2-moe-a2.7b")
    shapes = jax.eval_shape(lambda k: T.init_params(full, k),
                            jax.random.key(0))
    meta = Transformer(t_arch.get_arch("qwen2-moe-a2.7b"), device="meta")
    assert meta.param_count() == T.param_count(shapes)
    assert meta.active_param_count() == T.active_param_count(full, shapes)
    assert 15.0e9 < meta.param_count() < 15.3e9


def test_init_draws_repros_distributions():
    """The port's own draws (a torch.Generator) follow ``repro``'s
    ``init_moe``: the router N(0, 1/d) in f32 whatever the dtype, the
    experts N(0, 1/fan_in) in the model's dtype, the shared expert an
    MLP."""
    cfg = interop.arch_from_fields(dataclasses.asdict(BASE))
    gen = torch.Generator().manual_seed(0)
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16,
                        generator=gen)
    moe = model.layers[0].ff
    d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
    assert moe.router.dtype == torch.float32 and moe.router.shape == (d, e)
    for w, fan_in, shape in ((moe.exp_wgate, d, (e, d, f)),
                             (moe.exp_wi, d, (e, d, f)),
                             (moe.exp_w_down, f, (e, f, d))):
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == shape
        assert abs(float(w.float().std()) - fan_in ** -0.5) < \
            0.05 * fan_in ** -0.5
    assert abs(float(moe.router.std()) - d ** -0.5) < 0.05 * d ** -0.5
    assert moe.shared.w_down.shape == (cfg.moe_shared_ff, d)
    jp = j_layers.init_moe(jax.random.key(0), BASE, jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32
    assert {n: tuple(a.shape) for n, a in jp.items() if n != "shared"} == {
        n: tuple(getattr(moe, n).shape) for n in jp if n != "shared"}
    assert not any(p.requires_grad for p in model.parameters())
