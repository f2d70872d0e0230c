"""Building blocks of the dense LM: RMSNorm, RoPE, GQA attention and the
SwiGLU MLP, as ``nn.Module``s.

The port of the dense subset of ``repro.models.layers``. Weights keep
``repro``'s (d_in, d_out) layout and apply as ``x @ W``, so carrying
``repro``'s params across is a copy. The dtype policy is ``repro``'s:
weights and activations in the parameter dtype, norm statistics and
softmax in f32. Attention goes through the port's kernel wrappers:
``flash_prefill`` for the full sequence (the route ``repro`` takes on its
accelerator; differentiable), ``decode_attention`` for one token against
the cache. Parameters are made frozen; ``module.requires_grad_()`` makes
them trainable. Serving runs under ``torch.no_grad``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels import decode_attention, flash_prefill


def normal_param(shape, *, device, dtype, generator=None, std: float = 1.0
                 ) -> nn.Parameter:
    """A frozen parameter on ``device``: N(0, std^2) drawn there in f32 and
    cast to ``dtype`` (``repro`` draws in f32 and casts), or left
    uninitialised for a loader when ``generator`` is None."""
    if generator is None:
        w = torch.empty(shape, device=device, dtype=dtype)
    else:
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32).mul_(std).to(dtype)
    return nn.Parameter(w, requires_grad=False)


def dense_param(shape, *, device, dtype, generator=None, scale: float = 1.0
                ) -> nn.Parameter:
    """``repro``'s ``_dense_init``: normal times ``scale / sqrt(fan_in)``,
    fan_in the second-to-last axis."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_param(shape, device=device, dtype=dtype,
                        generator=generator, std=scale / math.sqrt(fan_in))


def _rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    rms = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale


class _RMSNormFn(torch.autograd.Function):
    """``repro``'s explicit VJP of ``_rmsnorm_core``: f32 inside this op,
    dx cast to x's dtype and dscale to the scale's (autograd through the
    forward would round differently in bf16)."""

    @staticmethod
    def forward(ctx, scale, x, eps: float):
        ctx.save_for_backward(scale, x)
        ctx.eps = eps
        return _rmsnorm(scale, x, eps)

    @staticmethod
    def backward(ctx, dy):
        scale, x = ctx.saved_tensors
        xf, dyf = x.to(torch.float32), dy.to(torch.float32)
        rms = torch.rsqrt(xf.square().mean(-1, keepdim=True) + ctx.eps)
        xhat = xf * rms
        dscale = (dyf * xhat).sum(dim=tuple(range(x.dim() - 1)))
        g = dyf * scale.to(torch.float32)
        dx = rms * (g - xhat * (g * xhat).mean(-1, keepdim=True))
        return dscale.to(scale.dtype), dx.to(x.dtype), None


class RMSNorm(nn.Module):
    """x / rms(x) * scale, the statistics in f32, cast back to x's dtype
    before the scale (as ``repro``'s ``_rmsnorm_core``), with its VJP."""

    def __init__(self, d: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.scale.requires_grad):
            return _RMSNormFn.apply(self.scale, x, self.eps)
        return _rmsnorm(self.scale, x, self.eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, Dh) at integer ``positions``
    (..., S) (broadcastable), rotating the two halves of Dh."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def init_kv_cache(b: int, sbuf: int, hkv: int, hd: int, *, device, dtype
                  ) -> dict:
    """One attention layer's cache: {'k', 'v'}: zeros (B, Sbuf, Hkv, Dh)."""
    return {"k": torch.zeros((b, sbuf, hkv, hd), device=device, dtype=dtype),
            "v": torch.zeros((b, sbuf, hkv, hd), device=device, dtype=dtype)}


class Attention(nn.Module):
    """GQA self-attention with RoPE; ``cfg.n_kv_heads`` divides
    ``cfg.n_heads``."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wq = dense_param((d, h * hd), **kw)
        self.wk = dense_param((d, hkv * hd), **kw)
        self.wv = dense_param((d, hkv * hd), **kw)
        self.wo = dense_param((h * hd, d), **kw)

    def forward(self, x: torch.Tensor, *, causal: bool = True,
                window: int = 0, positions: torch.Tensor | None = None):
        """x (B, S, D) -> (out (B, S, D), (k, v)): the post-RoPE K/V, each
        (B, S, Hkv, Dh) — exactly what the decode cache holds."""
        b, s, _ = x.shape
        h, hkv, hd = self.cfg.n_heads, self.cfg.n_kv_heads, self.cfg.hd
        q = (x @ self.wq).view(b, s, h, hd)
        k = (x @ self.wk).view(b, s, hkv, hd)
        v = (x @ self.wv).view(b, s, hkv, hd)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = rope(q, positions, self.cfg.rope_theta)
        k = rope(k, positions, self.cfg.rope_theta)
        out = flash_prefill(q, k, v, causal=causal, window=window)
        return out.reshape(b, s, h * hd).to(x.dtype) @ self.wo, (k, v)

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """One token x (B, 1, D) at absolute position ``pos`` (host int)
        against ``cache`` {'k', 'v': (B, Sbuf, Hkv, Dh)}, which it updates
        in place (``repro`` returns a new cache). The slot is ``pos % Sbuf``
        with a window (a ring buffer), else ``min(pos, Sbuf - 1)``; the
        valid entries are the first ``min(pos + 1, Sbuf)`` slots in both
        cases, in whatever order, which is all the softmax needs."""
        b = x.shape[0]
        h, hkv, hd = self.cfg.n_heads, self.cfg.n_kv_heads, self.cfg.hd
        q = (x @ self.wq).view(b, 1, h, hd)
        k_new = (x @ self.wk).view(b, 1, hkv, hd)
        v_new = (x @ self.wv).view(b, 1, hkv, hd)
        positions = torch.arange(pos, pos + 1, device=x.device)[None, :]
        q = rope(q, positions, self.cfg.rope_theta)
        k_new = rope(k_new, positions, self.cfg.rope_theta)
        sbuf = cache["k"].shape[1]
        slot = pos % sbuf if window else min(pos, sbuf - 1)
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        o = decode_attention(q.view(b, h, hd), cache["k"].transpose(1, 2),
                             cache["v"].transpose(1, 2), min(pos + 1, sbuf))
        return o.reshape(b, 1, h * hd).to(x.dtype) @ self.wo


class MLP(nn.Module):
    """SwiGLU: (silu(x @ wgate) * (x @ wi)) @ w_down."""

    def __init__(self, d: int, f: int, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wgate = dense_param((d, f), **kw)
        self.wi = dense_param((d, f), **kw)
        self.w_down = dense_param((f, d), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (nn.functional.silu(x @ self.wgate) * (x @ self.wi)) @ self.w_down
