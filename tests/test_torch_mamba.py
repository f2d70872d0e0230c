"""The port's Mamba2 mixer and reduced mamba2-370m against ``repro``'s, on
the CPU, in f32, on the same weights and inputs.

Tolerances, from the measured differences:

* ``causal_conv``: ``1e-6`` (the same shifted sum; measured ~5e-7);
* ``ssd_scan``: both it and ``repro``'s ``_ssd_scan`` against an f64
  witness, the plain step-by-step recurrence in numpy. The port takes
  the decays' prefix sums in f64 and ``repro`` in f32, whose ulp of a
  sum of hundreds is ~1e-4 of a decay, so the port must be within
  ``5e-7`` of the witness's largest |y| and state entry (measured
  ≤ 2.4e-7) and no farther from it than ``repro`` (measured 1.2e-7 to
  2.5e-5 for ``repro``, the most at S = 512 in chunks of 256);
* the mixer: the conv tail ``1e-5`` of order-1 values (in_proj's output:
  a matmul's sums in another order, ~1e-6), the output ``3e-5`` (those
  differences through the scan, the gate and the RMSNorm; measured
  ~1e-5) and the SSM state ``1e-5`` of its largest entry (measured
  ~5e-6); one decode step: output and conv tail ``1e-5``, the state
  ``1e-6`` of its largest entry (measured ~3e-7);
* the model: equal greedy ids and logits within ``1e-4`` over a prefill
  and 8 decode steps (measured ~7e-6); the model is attention-free, so
  ``repro``'s two attention routes are one run;
* prefill + a decode step against ``forward`` at the next position, and
  causality: ``1e-4``, the bounds ``tests/test_models.py`` holds
  ``repro`` to.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _lm_parity as lp
from repro.models import layers as j_layers
from repro.models.arch import get_arch as j_get_arch
from repro_torch.models import layers as t_layers

ATOL = 1e-4
JCFG = j_get_arch("mamba2-370m").reduced()

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


def _mixer():
    """(repro's first Mamba2 params, the port's mixer)."""
    params, _, model = _setup()
    return (jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["mixer"]),
            model.layers[0].mixer)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_causal_conv_matches_repro():
    rng = np.random.default_rng(0)
    x, w, b = _normal(rng, 2, 40, 96), _normal(rng, 4, 96), _normal(rng, 96)
    want = j_layers._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))
    got = t_layers.causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _ssd_witness(xh, dt, a_log, bm, cm):
    """The SSM recurrence one step at a time in f64: state_t = state_{t-1}
    * exp(a dt_t) + dt_t x_t B_t^T, y_t = state_t C_t."""
    xh, dt, bm, cm = (v.astype(np.float64) for v in (xh, dt, bm, cm))
    a = -np.exp(a_log.astype(np.float64))
    b, s, h, p = xh.shape
    state = np.zeros((b, h, p, bm.shape[-1]))
    ys = []
    for t in range(s):
        state = state * np.exp(a * dt[:, t])[:, :, None, None] \
            + (dt[:, t, :, None] * xh[:, t])[..., None] * bm[:, t, None, None]
        ys.append(np.einsum("bn,bhpn->bhp", cm[:, t], state))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("s,chunk", [(40, 40), (40, 8), (40, 16), (40, 256),
                                     (48, 7), (33, 256), (512, 256)],
                         ids=["one-chunk", "divides", "not-divides-40",
                              "cap-above-S", "prime-chunk", "prime-S",
                              "two-long-chunks"])
def test_ssd_scan_matches_repro(s, chunk):
    """Chunk lengths that divide S and ones that do not (the scan takes
    ``largest_divisor(S, chunk)``, 5 for (40, 16), 6 for (48, 7), 33 for
    (33, 256)), and chunks of mamba2-370m's 256, whose prefix sums reach
    thousands: the port within 5e-7 of the f64 witness and no farther
    from it than ``repro``'s scan."""
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 2, 16, 32, 16
    xh, bm, cm = _normal(rng, b, s, h, p), _normal(rng, b, s, n), \
        _normal(rng, b, s, n)
    dt = np.log1p(np.exp(_normal(rng, b, s, h))).astype(np.float32)
    a_log = np.log(np.linspace(1, 16, h)).astype(np.float32)
    args = (xh, dt, a_log, bm, cm)
    repro_out = j_layers._ssd_scan(*map(jnp.asarray, args), chunk)
    port_out = t_layers.ssd_scan(*map(torch.from_numpy, args), chunk)
    for got, ref, exact in zip(port_out, repro_out, _ssd_witness(*args)):
        assert got.shape == exact.shape and got.dtype == torch.float32
        scale = np.abs(exact).max()
        err = np.abs(got.numpy() - exact).max() / scale
        assert err <= 5e-7
        assert err <= np.abs(np.asarray(ref) - exact).max() / scale


@pytest.mark.parametrize("s", [40, 2], ids=["S=40", "S<W-1"])
def test_mamba_with_cache_matches_repro(s):
    """The mixer's output and the cache it leaves: the raw pre-conv tail
    (zero-padded on the left when S < W - 1) and the final state."""
    jp, mixer = _mixer()
    x = _normal(np.random.default_rng(s), 2, s, JCFG.d_model)
    want, want_cache = j_layers.mamba(jp, jnp.asarray(x), JCFG,
                                      return_cache=True)
    got, cache = mixer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=0)
    w = JCFG.ssm_conv_width
    assert cache["conv"].shape == (2, w - 1, JCFG.d_inner
                                   + 2 * JCFG.ssm_state)
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(want_cache["conv"]), atol=1e-5,
                               rtol=0)
    if s < w - 1:
        assert (cache["conv"][:, :w - 1 - s] == 0).all()
    ssm = np.asarray(want_cache["ssm"])
    assert cache["ssm"].dtype == torch.float32
    np.testing.assert_allclose(cache["ssm"].numpy(), ssm, rtol=0,
                               atol=1e-5 * np.abs(ssm).max())


def test_mamba_decode_matches_repro():
    jp, mixer = _mixer()
    rng = np.random.default_rng(7)
    x = _normal(rng, 2, 1, JCFG.d_model)
    conv = _normal(rng, 2, JCFG.ssm_conv_width - 1,
                   JCFG.d_inner + 2 * JCFG.ssm_state)
    ssm = _normal(rng, 2, JCFG.ssm_heads, JCFG.ssm_head_dim, JCFG.ssm_state)
    want, want_cache = j_layers.mamba_decode(
        jp, jnp.asarray(x), {"conv": jnp.asarray(conv),
                             "ssm": jnp.asarray(ssm)}, JCFG)
    cache = {"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)}
    got = mixer.decode(torch.from_numpy(x), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(want_cache["conv"]), atol=1e-5,
                               rtol=0)
    ssm = np.asarray(want_cache["ssm"])
    np.testing.assert_allclose(cache["ssm"].numpy(), ssm, rtol=0,
                               atol=1e-6 * np.abs(ssm).max())
    zero = j_layers.init_mamba_cache(2, JCFG, jnp.float32)
    mine = t_layers.init_mamba_cache(2, _setup()[1], device="cpu",
                                     dtype=torch.float32)
    for n in ("conv", "ssm"):
        assert tuple(mine[n].shape) == zero[n].shape
        assert (mine[n] == 0).all()


def test_greedy_decode_matches_repro():
    params, cfg, model = _setup()
    tokens = lp.prompts(cfg)
    want = lp.repro_greedy(JCFG, params, tokens, pallas=False)
    got = lp.port_greedy(model, tokens)
    lp.assert_greedy_close(got, want, ATOL)
    for key, entry in want[2].items():
        np.testing.assert_allclose(got[2][key]["conv"], entry["conv"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[2][key]["ssm"], entry["ssm"], rtol=0,
                                   atol=1e-5 * np.abs(entry["ssm"]).max())


def test_prefill_then_decode_equals_forward():
    """The port's counterpart of ``tests/test_models.py::
    test_smoke_decode_consistency``: prefill + one decode step gives the
    logits of ``forward`` at the next position."""
    _, _, model = _setup()
    toks = torch.from_numpy(lp.prompts(model.cfg, b=2, s=17, seed=3)).long()
    logits, cache = model.prefill(toks[:, :16])
    h, _ = model(toks[:, :16])
    np.testing.assert_allclose(logits.numpy(),
                               model.logits(h[:, -1:]).detach().numpy(),
                               atol=ATOL, rtol=0)
    logits, _ = model.decode_step(cache, toks[:, 16:], 16)
    h, _ = model(toks)
    np.testing.assert_allclose(logits.numpy(),
                               model.logits(h[:, -1:]).detach().numpy(),
                               atol=ATOL, rtol=0)


def test_causality():
    _, _, model = _setup()
    t1 = torch.from_numpy(lp.prompts(model.cfg, b=1, s=16, seed=9)).long()
    t2 = t1.clone()
    t2[:, -1] = (t2[:, -1] + 3) % model.cfg.vocab
    with torch.no_grad():
        h1, _ = model(t1)
        h2, _ = model(t2)
    np.testing.assert_allclose(h1[:, :-1].numpy(), h2[:, :-1].numpy(),
                               atol=ATOL, rtol=0)
    assert not torch.equal(h1[:, -1], h2[:, -1])


def test_f32_leaves_and_repros_init():
    """``a_log``, ``dt_bias`` and ``ssm_d`` are f32 in a bf16 model, and
    the port's own draws follow ``repro``'s ``init_mamba``."""
    from repro_torch.models.transformer import Transformer

    cfg = _setup()[1]
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    mixer = model.layers[0].mixer
    jp = j_layers.init_mamba(jax.random.key(0), JCFG, jnp.bfloat16)
    for name, want in jp.items():
        got = getattr(mixer, name)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    for name in ("a_log", "dt_bias", "ssm_d"):
        np.testing.assert_allclose(getattr(mixer, name).numpy(),
                                   np.asarray(jp[name]), rtol=1e-6)
    conv_std = 3.0 / JCFG.ssm_conv_width ** 0.5
    assert abs(float(mixer.conv_w.float().std()) - conv_std) < \
        0.05 * conv_std
    assert not hasattr(model.layers[0], "ff_norm")
