"""Building blocks of the LM: RMSNorm, RoPE, GQA attention, the SwiGLU
MLP, the token-choice MoE and the Mamba2 (SSD) mixer, as ``nn.Module``s.

The port of ``repro.models.layers`` on one device (its expert-parallel
MoE branches arrive with the LM mesh). Weights keep
``repro``'s (d_in, d_out) layout and apply as ``x @ W``, so carrying
``repro``'s params across is a copy. The dtype policy is ``repro``'s:
weights and activations in the parameter dtype, norm statistics and
softmax in f32, and the MoE router and the SSM scan in f32 with their
f32 leaves (``router``, ``a_log``, ``dt_bias``, ``ssm_d``) f32 whatever
the model's dtype. Attention (self and cross) goes through the port's
kernel wrappers: ``flash_prefill`` for the full sequence (the route
``repro`` takes on its accelerator; differentiable), ``decode_attention``
for one token against the cache or the cross cache. Parameters are made
frozen; ``module.requires_grad_()`` makes them trainable. Serving runs
under ``torch.no_grad``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels import decode_attention, flash_prefill
from repro_torch.kernels.flash_prefill import largest_divisor


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


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """x / rms(x) * scale, the statistics in f32, cast back to x's dtype
    before the scale (as ``repro``'s ``_rmsnorm_core``), with its VJP."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(scale, x, eps)
    return _rmsnorm(scale, x, eps)


def const_param(t: torch.Tensor) -> nn.Parameter:
    """A frozen parameter holding ``t``."""
    return nn.Parameter(t, requires_grad=False)


class RMSNorm(nn.Module):
    """:func:`rmsnorm` with a scale of ones and ``eps``."""

    def __init__(self, d: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.scale = const_param(torch.ones(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


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
    """GQA attention with RoPE, or cross-attention over an encoder's
    memory without it; ``cfg.n_kv_heads`` divides ``cfg.n_heads``."""

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
                window: int = 0, positions: torch.Tensor | None = None,
                memory: torch.Tensor | None = None):
        """x (B, S, D) -> (out (B, S, D), (k, v)), each (B, Skv, Hkv, Dh)
        — exactly what the decode cache holds. Self-attention: the
        post-RoPE K/V of x. Cross-attention (``memory`` (B, Sm, D)): K/V
        are ``memory @ wk`` / ``memory @ wv``, no RoPE on q or k, and every
        query sees every memory row (``causal`` and ``window`` apply to
        self-attention only, as in ``repro``)."""
        b, s, _ = x.shape
        h, hkv, hd = self.cfg.n_heads, self.cfg.n_kv_heads, self.cfg.hd
        src = x if memory is None else memory
        sm = src.shape[1]
        q = (x @ self.wq).view(b, s, h, hd)
        k = (src @ self.wk).view(b, sm, hkv, hd)
        v = (src @ self.wv).view(b, sm, hkv, hd)
        if memory is None:
            if positions is None:
                positions = torch.arange(s, device=x.device)[None, :]
            q = rope(q, positions, self.cfg.rope_theta)
            k = rope(k, positions, self.cfg.rope_theta)
        else:
            causal, window = False, 0
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

    def decode_cross(self, x: torch.Tensor, xk: torch.Tensor,
                     xv: torch.Tensor) -> torch.Tensor:
        """One token x (B, 1, D) against a cross cache ``xk``/``xv`` (B,
        Sm, Hkv, Dh): no RoPE, nothing written, every slot valid (the port
        of ``repro``'s ``attention_decode(memory_kv=)``)."""
        b = x.shape[0]
        h, hd = self.cfg.n_heads, self.cfg.hd
        q = (x @ self.wq).view(b, h, hd)
        o = decode_attention(q, xk.transpose(1, 2), xv.transpose(1, 2),
                             xk.shape[1])
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


def moe_capacity(cfg, t: int, e: int) -> int:
    """Slots an expert takes of ``t`` tokens: ceil(capacity_factor * t *
    top_k / e), rounded up to a multiple of 8 and at least 8."""
    cap = math.ceil(cfg.moe_capacity_factor * t * cfg.moe_top_k / e)
    return max(8, -(-cap // 8) * 8)


def moe_slots(exp_ids: torch.Tensor, e: int, cap: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``repro``'s sort-based capacity assignment of the flat assignments
    ``t * k + j`` of ``exp_ids`` (T, k) to ``e * cap`` expert slots: a
    stable sort by expert keeps each expert's first ``cap`` assignments
    in flat order and drops the rest. Returns (slot of each flat
    assignment (T * k,), ``e * cap`` where dropped; assignments an expert
    received (e,)). Fixed-length counts and no host read, so a decode
    step stays free of device-to-host syncs."""
    flat = exp_ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    sorted_exp = flat[order]
    counts = torch.zeros(e, dtype=torch.long, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat.numel(), device=flat.device) - starts[sorted_exp]
    slot_sorted = torch.where(pos < cap, sorted_exp * cap + pos, e * cap)
    return torch.empty_like(flat).scatter_(0, order, slot_sorted), counts


class MoE(nn.Module):
    """Token-choice top-k mixture of experts with capacity and drops, and
    the always-on shared expert (the port of ``repro``'s ``moe`` without a
    mesh). The router is f32; padding experts (``padded_experts`` rounds
    the count to 16) get logit -1e30.

    The combine gathers each token's k slot outputs (0 where dropped),
    scales them by their gates and adds them in ascending expert order:
    the order of ``repro``'s slot-order scatter-add, computed without
    atomics, so it is the same on every run and device.
    """

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.router = dense_param((d, e), **{**kw, "dtype": torch.float32})
        self.exp_wgate = dense_param((e, d, f), **kw)
        self.exp_wi = dense_param((e, d, f), **kw)
        self.exp_w_down = dense_param((e, f, d), **kw)
        self.shared = MLP(d, cfg.moe_shared_ff, **kw) \
            if cfg.moe_shared_ff else None

    def route(self, xf: torch.Tensor):
        """xf (T, D) -> (gate (T, k) f32, exp_ids (T, k), probs (T, E))."""
        cfg = self.cfg
        logits = xf.to(torch.float32) @ self.router
        if cfg.padded_experts != cfg.moe_experts:
            pad = torch.arange(cfg.padded_experts, device=xf.device) \
                >= cfg.moe_experts
            logits = logits.masked_fill(pad, -1e30)
        probs = torch.softmax(logits, dim=-1)
        gate, exp_ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, exp_ids, probs

    def dropped(self, x: torch.Tensor) -> torch.Tensor:
        """How many of the token-expert assignments of x (B, S, D) the
        capacity drops (a 0-d tensor on x's device)."""
        t, e = x.shape[0] * x.shape[1], self.cfg.padded_experts
        _, exp_ids, _ = self.route(x.reshape(t, -1))
        cap = moe_capacity(self.cfg, t, e)
        return (moe_slots(exp_ids, e, cap)[1] - cap).clamp(min=0).sum()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, D) -> (output (B, S, D), Switch load-balance aux loss
        f32)."""
        b, s, d = x.shape
        e, t = self.cfg.padded_experts, b * s
        xf = x.reshape(t, d)
        gate, exp_ids, probs = self.route(xf)
        first = torch.zeros(e, dtype=torch.float32, device=x.device)
        first.scatter_add_(0, exp_ids[:, 0], torch.ones_like(gate[:, 0]))
        aux = e * torch.sum(first / t * probs.mean(0))

        cap = moe_capacity(self.cfg, t, e)
        slot, counts = moe_slots(exp_ids, e, cap)
        n_slots = e * cap
        tok = torch.arange(slot.numel(), device=x.device) // gate.shape[1]
        tok_for_slot = torch.zeros(n_slots + 1, dtype=torch.long,
                                   device=x.device).scatter_(0, slot, tok)
        valid = torch.arange(cap, device=x.device)[None, :] < counts[:, None]
        buf = torch.where(valid.reshape(-1, 1), xf[tok_for_slot[:n_slots]], 0)
        buf = buf.view(e, cap, d)
        hidden = nn.functional.silu(torch.bmm(buf, self.exp_wgate)) \
            * torch.bmm(buf, self.exp_wi)
        out_buf = torch.bmm(hidden, self.exp_w_down).view(n_slots, d)
        out_buf = torch.cat([out_buf, out_buf.new_zeros(1, d)])

        _, by_expert = torch.sort(exp_ids, dim=-1)
        slot = slot.view(t, -1).gather(1, by_expert)
        gate = gate.gather(1, by_expert).to(x.dtype)
        out = out_buf[slot[:, 0]] * gate[:, :1]
        for j in range(1, slot.shape[1]):
            out = out + out_buf[slot[:, j]] * gate[:, j:j + 1]
        out = out.view(b, s, d)
        if self.shared is not None:
            out = out + self.shared(x)
        return out, aux


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv of width W over xbc (B, S, C), w (W, C), then
    silu: ``repro``'s sum of W shifted products, in its order."""
    width, s = w.shape[0], xbc.shape[1]
    pad = nn.functional.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, :s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return nn.functional.silu(out + b)


def ssd_scan(xh, dt, a_log, bmat, cmat, chunk: int):
    """Chunked SSD (state-space duality, arXiv:2405.21060 §6), ``repro``'s
    ``_ssd_scan``: xh (B, S, H, P) f32, dt (B, S, H) after softplus, B/C
    (B, S, N) f32. A loop over chunks of ``largest_divisor(S, chunk)``
    carries the (B, H, P, N) f32 state; each chunk adds the masked
    "attention" form inside it and the carried state's term. The decay
    mask is applied to the exponent (-inf before exp), so a masked slot
    is exp(-inf) = 0 and its gradient 0, never inf * 0. The decays'
    prefix sums and their differences are taken in f64 (``repro``: f32),
    since exp(cum_i - cum_j) subtracts sums of up to thousands from one
    another and an f32 ulp of such a sum is ~1e-4 of a decay.
    Returns (y (B, S, H, P), final state (B, H, P, N))."""
    b, s, h, p = xh.shape
    l = largest_divisor(s, chunk)
    keep = torch.ones((l, l), dtype=torch.bool, device=xh.device).tril()
    a = -torch.exp(a_log)
    state = xh.new_zeros((b, h, p, bmat.shape[-1]))
    ys = []
    for c0 in range(0, s, l):
        xc, dtc, bc, cc = (v[:, c0:c0 + l] for v in (xh, dt, bmat, cmat))
        cum = torch.cumsum(a * dtc, dim=1, dtype=torch.float64)  # (B, l, H)
        scores = cc @ bc.transpose(1, 2)                      # (B, i, j)
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).float()  # B,i,j,H
        decay = torch.exp(diff.masked_fill(~keep[None, :, :, None],
                                           float("-inf")))
        w = scores[..., None] * decay * dtc[:, None]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
        y_inter = torch.einsum("bin,bhpn->bihp", cc, state) \
            * torch.exp(cum.float())[..., None]
        seg = (torch.exp((cum[:, -1:] - cum).float()) * dtc)[..., None] * xc
        state = state * torch.exp(cum[:, -1].float())[:, :, None, None] \
            + torch.einsum("bjn,bjhp->bhpn", bc, seg)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), state


def ssd_chunk(b: int, s: int, h: int, budget_bytes: int = 4 * 2**30) -> int:
    """``repro``'s ``_ssd_sizes``: the chunk length l whose (B, l, l, H)
    f32 decay stays under ``budget_bytes``."""
    for l in (256, 128, 64, 32):
        if b * l * l * h * 4 <= budget_bytes:
            return l
    return 16


def init_mamba_cache(b: int, cfg, *, device, dtype) -> dict:
    """One Mamba2 layer's cache: {'conv': the last W - 1 pre-conv inputs
    (B, W - 1, C) in ``dtype``, 'ssm': the state (B, H, P, N) f32}."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {"conv": torch.zeros((b, cfg.ssm_conv_width - 1, conv_ch),
                                device=device, dtype=dtype),
            "ssm": torch.zeros((b, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), device=device,
                               dtype=torch.float32)}


class Mamba2(nn.Module):
    """The Mamba2 mixer: in_proj to [z, x, B, C, dt], the causal conv over
    [x, B, C], the SSD scan, the skip ``ssm_d``, the silu(z) gate, an
    RMSNorm (eps 1e-5, not ``cfg.norm_eps``, as ``repro``) and out_proj.
    ``a_log``, ``dt_bias`` and ``ssm_d`` are f32 whatever the dtype."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        self.cfg = cfg
        d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * n
        kw = dict(device=device, dtype=dtype, generator=generator)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = dense_param((d, 2 * di + 2 * n + nh), **kw)
        self.conv_w = dense_param((cfg.ssm_conv_width, conv_ch), scale=3.0,
                                  **kw)
        self.conv_b = const_param(torch.zeros(conv_ch, device=device,
                                              dtype=dtype))
        self.a_log = const_param(torch.log(torch.linspace(1.0, 16.0, nh,
                                                          **f32)))
        self.dt_bias = const_param(torch.zeros(nh, **f32))
        self.ssm_d = const_param(torch.ones(nh, **f32))
        self.out_proj = dense_param((di, d), **kw)
        self.norm_scale = const_param(torch.ones(di, device=device,
                                                 dtype=dtype))

    def _split(self, proj: torch.Tensor):
        di, n = self.cfg.d_inner, self.cfg.ssm_state
        return proj.split([di, di, n, n, self.cfg.ssm_heads], dim=-1)

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        y = y * nn.functional.silu(z)
        return rmsnorm(self.norm_scale, y) @ self.out_proj

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """x (B, S, D) -> (out (B, S, D), cache {'conv', 'ssm'}): the
        last W - 1 pre-conv inputs, zero-padded on the left when S < W - 1,
        and the final SSM state."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        z, xin, bmat, cmat, dt = self._split(x @ self.in_proj)
        xbc_raw = torch.cat([xin, bmat, cmat], dim=-1)
        xin, bmat, cmat = causal_conv(xbc_raw, self.conv_w,
                                      self.conv_b).split([di, n, n], dim=-1)
        dt = nn.functional.softplus(dt.to(torch.float32) + self.dt_bias)
        xh = xin.reshape(b, s, nh, hp).to(torch.float32)
        y, state = ssd_scan(xh, dt, self.a_log, bmat.to(torch.float32),
                            cmat.to(torch.float32), ssd_chunk(b, s, nh))
        y = y + self.ssm_d[:, None] * xh
        out = self._out(y.reshape(b, s, di).to(x.dtype), z)
        w = cfg.ssm_conv_width
        tail = xbc_raw[:, -(w - 1):] if s >= w - 1 else \
            nn.functional.pad(xbc_raw, (0, 0, w - 1 - s, 0))
        return out, {"conv": tail.clone(), "ssm": state}

    def decode(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """One token x (B, 1, D) against ``cache`` {'conv', 'ssm'}, whose
        entries it replaces with the stepped ones."""
        cfg = self.cfg
        b = x.shape[0]
        di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        z, xin, bmat, cmat, dt = self._split(x @ self.in_proj)
        conv_in = torch.cat([cache["conv"],
                             torch.cat([xin, bmat, cmat], dim=-1)], dim=1)
        conv = torch.sum(conv_in * self.conv_w, dim=1, keepdim=True)
        xin, bmat, cmat = nn.functional.silu(conv + self.conv_b).split(
            [di, n, n], dim=-1)
        dt = nn.functional.softplus(dt.to(torch.float32)
                                    + self.dt_bias)[:, 0]         # (B, H)
        decay = torch.exp(-torch.exp(self.a_log) * dt)
        xh = xin.reshape(b, nh, hp).to(torch.float32)
        bm, cm = bmat[:, 0].to(torch.float32), cmat[:, 0].to(torch.float32)
        state = cache["ssm"] * decay[:, :, None, None] \
            + (dt[:, :, None] * xh)[..., None] * bm[:, None, None, :]
        y = torch.einsum("bn,bhpn->bhp", cm, state) + self.ssm_d[:, None] * xh
        cache["conv"], cache["ssm"] = conv_in[:, 1:], state
        return self._out(y.reshape(b, 1, di).to(x.dtype), z)
