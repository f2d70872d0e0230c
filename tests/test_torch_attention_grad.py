"""The gradient route of the port's training path against ``repro``'s.

``flash_prefill``'s ``autograd.Function`` (the plain version forward on
the CPU, and the chunked PyTorch backward of ``kernels.flash_prefill``)
is held to ``jax.grad`` of ``repro.models.layers._flash_attn`` (the
route ``repro``'s training differentiates) and to autograd through
``kernels.ref.flash_prefill_ref``, on the same numpy inputs. The two
packages compute the same softmax in another order (online against whole
rows), so the f32 gradients agree within ``rtol=1e-5`` and an absolute
``4e-6`` of the leaf's largest entry (measured: at most 1.3e-6 of it).
``RMSNorm``'s VJP is ``repro``'s ``_rmsnorm_bwd`` op for op: equal to
``_rmsnorm_core``'s custom VJP within a few f32 ulps, and within one bf16
ulp in bf16.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels import flash_prefill, ref
from repro_torch.models import layers as tl

#: the module (the package exports the wrapper under the same name)
fp_mod = importlib.import_module("repro_torch.kernels.flash_prefill")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_grad(got, want):
    want = np.asarray(want, np.float32)
    m = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=4e-6 * m)


def _inputs(b, s, hq, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, hq, dh), (b, s, hkv, dh),
                               (b, s, hkv, dh), (b, s, hq, dh)))


def _port_grads(fn, q, k, v, do, dtype=torch.float32, **kw):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts, **kw)
    grads = torch.autograd.grad(out, ts, torch.tensor(do, dtype=dtype))
    return out, grads


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", [
    (1, 64, 4, 4, 32, True, 0),      # MHA
    (2, 72, 8, 2, 32, True, 0),      # GQA G = 4
    (1, 100, 4, 1, 64, True, 24),    # MQA, sliding window
    (1, 64, 4, 2, 32, False, 0),     # non-causal
    (1, 48, 8, 2, 16, False, 20),    # non-causal with a window
    (1, 2100, 2, 1, 32, True, 0),    # 3 query chunks of 700 (not 1024)
    (1, 1100, 2, 2, 32, True, 300),  # windowed chunks that skip keys
])
def test_flash_prefill_grad_matches_repro(b, s, hq, hkv, dh, causal, window):
    q, k, v, do = _inputs(b, s, hq, hkv, dh, seed=s + hq)

    def loss(q, k, v):
        o = jl._flash_attn(q.reshape(b, s, hkv, hq // hkv, dh), k, v,
                           causal=causal, window=window)
        return jnp.sum(o.reshape(b, s, hq, dh) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    out, got = _port_grads(flash_prefill, q, k, v, do, causal=causal,
                           window=window)
    _, plain = _port_grads(ref.flash_prefill_ref, q, k, v, do, causal=causal,
                           window=window)
    for g, w, p in zip(got, want, plain):
        _close_grad(g.numpy(), w)
        _close_grad(g.numpy(), p.numpy())
    assert out.grad_fn is not None


def test_flash_prefill_grad_bf16():
    """bf16 operands: the forward and the backward in f32 inside, each
    gradient rounded once to bf16 (so within 2 bf16 ulps of autograd
    through the plain version, which rounds the same f32 values)."""
    q, k, v, do = _inputs(2, 96, 8, 2, 32, seed=5)
    _, got = _port_grads(flash_prefill, q, k, v, do, torch.bfloat16,
                         causal=True, window=40)
    _, plain = _port_grads(ref.flash_prefill_ref, q, k, v, do,
                           torch.bfloat16, causal=True, window=40)
    for g, p in zip(got, plain):
        assert g.dtype == torch.bfloat16
        m = float(p.float().abs().max())
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(),
                                   rtol=2 ** -7, atol=2 ** -8 * m)


def test_no_grad_route_skips_autograd():
    q, k, v, _ = _inputs(1, 16, 2, 2, 32)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    out = flash_prefill(*ts)
    assert out.grad_fn is None
    with torch.no_grad():
        ts = [t.requires_grad_() for t in ts]
        assert flash_prefill(*ts).grad_fn is None


def test_checkpointed_layers_rerun_the_forward(monkeypatch):
    """Under the blocks' checkpoints the forward (the kernel, on the card)
    runs twice per layer and step, and the gradients equal those of the
    unrematerialised stack."""
    from repro_torch.models.arch import ArchConfig, LayerSpec
    from repro_torch.models.transformer import Transformer

    cfg = ArchConfig(name="grad-test", family="dense", n_layers=3,
                     d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=300,
                     pattern=(LayerSpec(),), rope_theta=1e4)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    calls = []
    real = fp_mod._forward
    monkeypatch.setattr(fp_mod, "_forward",
                        lambda *a: calls.append(1) or real(*a))
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(1))

    def grads():
        h, aux = model(tokens)
        loss = model.lm_loss(h, tokens.roll(-1, 1))
        return torch.autograd.grad(loss, list(model.parameters()))

    with_remat = grads()
    assert len(calls) == 2 * cfg.n_layers
    from repro_torch.models import transformer as tm
    monkeypatch.setattr(tm, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    calls.clear()
    plain = grads()
    assert len(calls) == cfg.n_layers
    for a, b in zip(with_remat, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vjp_matches_repro(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 2
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 48)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    y, vjp = jax.vjp(lambda s, x: jl._rmsnorm_core(s, x, 1e-5),
                     jnp.asarray(scale, jdt), jnp.asarray(x, jdt))
    want_ds, want_dx = vjp(jnp.asarray(dy, jdt))
    norm = tl.RMSNorm(48, 1e-5, device="cpu", dtype=tdt)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    norm.requires_grad_(True)
    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    out = norm(tx)
    dx, ds = torch.autograd.grad(out, (tx, norm.scale),
                                 torch.tensor(dy, dtype=tdt))
    assert dx.dtype == ds.dtype == tdt
    if dtype == "float32":
        kw = dict(rtol=1e-6, atol=1e-6)
    else:  # one bf16 rounding of nearly equal f32 values
        kw = dict(rtol=2 ** -7, atol=2 ** -7)
    for got, want in ((out, y), (dx, want_dx), (ds, want_ds)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), **kw)
