"""Building blocks of the LM: RMSNorm, RoPE, GQA attention, the SwiGLU
MLP, the token-choice MoE and the Mamba2 (SSD) mixer, as ``nn.Module``s.

The port of ``repro.models.layers``, on one device or on a mesh. Weights
keep ``repro``'s (d_in, d_out) layout and apply as ``x @ W``, so carrying
``repro``'s params across is a copy. Built with a ``shard``
(``sharding.LMShard``), each module holds the rank's slices of its
weights and runs ``repro``'s sharded branches with explicit collectives:
attention over its Q heads (and the K/V heads they read), ``wo``
row-parallel and all-reduced; the MLP column- then row-parallel; the MoE
expert-parallel over ``model`` (capacity per data shard), or 2-D (ep2d:
experts over ``model``, d_ff over ``data``, the decode tokens gathered);
Mamba2 over its heads, the gated norm's mean of squares all-reduced.
Each rank's attention still runs the kernels, on its own heads. The dtype policy is ``repro``'s:
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

from repro_torch import trace
from repro_torch.kernels import decode_attention, flash_prefill
from repro_torch.kernels.flash_prefill import largest_divisor


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


def add_param(mod: nn.Module, name: str, shape: tuple, *, device, dtype,
              generator=None, std: float | None = None,
              fill: torch.Tensor | None = None, shard=None, tp: bool = True,
              model_index=None) -> None:
    """Register frozen parameter ``name`` of full ``shape`` on ``mod``:
    ``fill`` (a full tensor), else N(0, std^2) drawn on ``device`` in f32
    and cast (the same draws as without a mesh), else uninitialised for a
    loader. With a ``shard`` the rank keeps its slice of the full leaf by
    ``shard.layout(name, shape, tp=, model_index=)``, drawn whole and cut
    one leaf at a time, and the layout goes into ``mod.layouts``."""
    lay = None if shard is None else shard.layout(
        name, shape, tp=tp, model_index=model_index)
    full = fill
    if full is None and generator is not None:
        full = torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)
    if full is None:
        local = torch.empty(shape if lay is None else shard.local_shape(lay),
                            device=device, dtype=dtype)
    else:
        local = full if lay is None else shard.cut(full, lay)
    del full
    setattr(mod, name, nn.Parameter(local, requires_grad=False))
    if lay is not None:
        mod.layouts[name] = lay


def add_dense(mod, name, shape, *, scale: float = 1.0, **kw) -> None:
    """:func:`add_param` with ``repro``'s ``_dense_init``: normal times
    ``scale / sqrt(fan_in)``, fan_in the full shape's second-to-last."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    add_param(mod, name, shape, std=scale / math.sqrt(fan_in), **kw)


class Sharded(nn.Module):
    """A module that may hold its weights' slices on a mesh: ``shard`` (an
    ``LMShard`` or None), ``layouts`` {parameter name: Layout}, and
    :meth:`w`, a weight as the rank computes with it."""

    def __init__(self, shard=None):
        super().__init__()
        self.shard = shard
        self.layouts: dict = {}

    def w(self, name: str, gather: bool | None = None) -> torch.Tensor:
        p = getattr(self, name)
        if self.shard is None:
            return p
        return self.shard.use(p, self.layouts.get(name), gather)

    def _enter(self, x):
        return self.shard.enter(x) if self.tp > 1 else x

    def _reduce(self, x):
        return self.shard.reduce(x) if self.tp > 1 else x

    def _tp(self, units: int) -> int:
        """The model-parallel degree over ``units`` (heads, columns,
        experts): the model axis when it divides them, else 1."""
        m = 1 if self.shard is None else self.shard.msize
        return m if m > 1 and units % m == 0 else 1


class _ReduceBoth(torch.autograd.Function):
    """All-reduce forward and backward: a sum every rank's output uses on
    its own slice (the gated norm's mean of squares)."""

    @staticmethod
    def forward(ctx, x, group):
        from .sharding import all_reduce

        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        from .sharding import all_reduce

        return all_reduce(g, ctx.group), None


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


def kv_heads_kept(h: int, hkv: int, m: int) -> torch.Tensor:
    """(m, k) K/V heads each of ``m`` model ranks keeps when it holds the
    Q heads [r*h/m, (r+1)*h/m): a contiguous block of hkv/m when m
    divides hkv; else the heads its Q heads read, k of them serving h/(mk)
    consecutive Q heads each when every rank's heads group so evenly,
    and otherwise one per Q head (k = h/m, repeats allowed)."""
    if hkv % m == 0:
        return torch.arange(hkv).view(m, hkv // m)
    g, hl = h // hkv, h // m
    per = [[(r * hl + j) // g for j in range(hl)] for r in range(m)]
    kept = [sorted(set(p)) for p in per]
    k = len(kept[0])
    if all(len(u) == k for u in kept) and hl % k == 0 and all(
            per[r][j] == kept[r][j // (hl // k)]
            for r in range(m) for j in range(hl)):
        return torch.tensor(kept)
    return torch.tensor(per)


class Attention(Sharded):
    """GQA attention with RoPE (none under ``cfg.positional == "nope"``),
    or cross-attention over an encoder's memory without it;
    ``cfg.n_kv_heads`` divides ``cfg.n_heads``. The softmax scale is
    ``cfg.attention_multiplier``, or 1/sqrt(Dh) where it is 0 (``scale``
    None: the kernels' own default). On a mesh whose model axis divides
    the heads, a rank holds ``h_loc`` Q heads and the ``hkv_loc`` K/V
    heads they read (``kv_heads_kept``), and ``wo``'s product is
    all-reduced over ``model``."""

    def __init__(self, cfg, *, device, dtype, generator=None, shard=None):
        super().__init__(shard)
        self.cfg = cfg
        self.rope = cfg.positional == "rope"
        self.scale = cfg.attention_multiplier or None
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.tp = self._tp(h)
        self.h_loc, self.hkv_loc = h // self.tp, hkv
        kv_index = None
        if self.tp > 1:
            kept = kv_heads_kept(h, hkv, self.tp)
            self.hkv_loc = kept.shape[1]
            if hkv % self.tp:
                kv_index = (1, (kept[..., None] * hd
                                + torch.arange(hd)).flatten(1))
        kw = dict(device=device, dtype=dtype, generator=generator,
                  shard=shard, tp=self.tp > 1)
        add_dense(self, "wq", (d, h * hd), **kw)
        add_dense(self, "wk", (d, hkv * hd), model_index=kv_index, **kw)
        add_dense(self, "wv", (d, hkv * hd), model_index=kv_index, **kw)
        add_dense(self, "wo", (h * hd, d), **kw)

    def kv(self, src: torch.Tensor):
        """The rank's K/V heads of ``src`` (B, S, D): (B, S, hkv_loc, Dh)
        each, before RoPE."""
        b, sm, _ = src.shape
        hkv, hd = self.hkv_loc, self.cfg.hd
        return ((src @ self.w("wk")).view(b, sm, hkv, hd),
                (src @ self.w("wv")).view(b, sm, hkv, hd))

    def forward(self, x: torch.Tensor, *, causal: bool = True,
                window: int = 0, positions: torch.Tensor | None = None,
                memory: torch.Tensor | None = None):
        """x (B, S, D) -> (out (B, S, D), (k, v)), each (B, Skv, Hkv, Dh)
        — exactly what the decode cache holds (the rank's heads on a
        mesh). Self-attention: the post-RoPE K/V of x. Cross-attention
        (``memory`` (B, Sm, D)): K/V are ``memory @ wk`` / ``memory @ wv``,
        no RoPE on q or k, and every query sees every memory row
        (``causal`` and ``window`` apply to self-attention only, as in
        ``repro``)."""
        b, s, _ = x.shape
        h, hd = self.h_loc, self.cfg.hd
        x = self._enter(x)
        src = x if memory is None else self._enter(memory)
        q = (x @ self.w("wq")).view(b, s, h, hd)
        k, v = self.kv(src)
        if memory is not None:
            causal, window = False, 0
        elif self.rope:
            if positions is None:
                positions = torch.arange(s, device=x.device)[None, :]
            q = rope(q, positions, self.cfg.rope_theta)
            k = rope(k, positions, self.cfg.rope_theta)
        out = flash_prefill(q, k, v, causal=causal, window=window,
                            scale=self.scale)
        out = out.reshape(b, s, h * hd).to(x.dtype) @ self.w("wo")
        return self._reduce(out), (k, v)

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """One token x (B, 1, D) at absolute position ``pos`` (host int)
        against ``cache`` {'k', 'v': (B, Sbuf, Hkv, Dh)}, which it updates
        in place (``repro`` returns a new cache). The slot is ``pos % Sbuf``
        with a window (a ring buffer), else ``min(pos, Sbuf - 1)``; the
        valid entries are the first ``min(pos + 1, Sbuf)`` slots in both
        cases, in whatever order, which is all the softmax needs."""
        b = x.shape[0]
        h, hd = self.h_loc, self.cfg.hd
        q = (x @ self.w("wq")).view(b, 1, h, hd)
        k_new, v_new = self.kv(x)
        if self.rope:
            positions = torch.arange(pos, pos + 1, device=x.device)[None, :]
            q = rope(q, positions, self.cfg.rope_theta)
            k_new = rope(k_new, positions, self.cfg.rope_theta)
        sbuf = cache["k"].shape[1]
        slot = pos % sbuf if window else min(pos, sbuf - 1)
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        o = decode_attention(q.view(b, h, hd), cache["k"].transpose(1, 2),
                             cache["v"].transpose(1, 2), min(pos + 1, sbuf),
                             scale=self.scale)
        return self._reduce(o.reshape(b, 1, h * hd).to(x.dtype)
                            @ self.w("wo"))

    def decode_cross(self, x: torch.Tensor, xk: torch.Tensor,
                     xv: torch.Tensor) -> torch.Tensor:
        """One token x (B, 1, D) against a cross cache ``xk``/``xv`` (B,
        Sm, Hkv, Dh): no RoPE, nothing written, every slot valid (the port
        of ``repro``'s ``attention_decode(memory_kv=)``)."""
        b = x.shape[0]
        h, hd = self.h_loc, self.cfg.hd
        q = (x @ self.w("wq")).view(b, h, hd)
        o = decode_attention(q, xk.transpose(1, 2), xv.transpose(1, 2),
                             xk.shape[1], scale=self.scale)
        return self._reduce(o.reshape(b, 1, h * hd).to(x.dtype)
                            @ self.w("wo"))


class MLP(Sharded):
    """SwiGLU: (silu(x @ wgate) * (x @ wi)) @ w_down; on a mesh ``wgate``
    and ``wi`` column-parallel, ``w_down`` row-parallel and all-reduced."""

    def __init__(self, d: int, f: int, *, device, dtype, generator=None,
                 shard=None):
        super().__init__(shard)
        self.tp = self._tp(f)
        kw = dict(device=device, dtype=dtype, generator=generator,
                  shard=shard, tp=self.tp > 1)
        add_dense(self, "wgate", (d, f), **kw)
        add_dense(self, "wi", (d, f), **kw)
        add_dense(self, "w_down", (f, d), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._enter(x)
        hidden = nn.functional.silu(x @ self.w("wgate")) * (x @ self.w("wi"))
        return self._reduce(hidden @ self.w("w_down"))


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
    in flat order and drops the rest. Ids outside [0, e) are another
    rank's experts (``repro``'s expert-parallel remap): they take no slot.
    Returns (slot of each flat assignment (T * k,), ``e * cap`` where
    dropped or not this rank's; assignments each expert received (e,)).
    Fixed-length counts and no host read, so a decode step stays free of
    device-to-host syncs."""
    flat = exp_ids.reshape(-1)
    key = torch.where((flat >= 0) & (flat < e), flat, e)
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    counts = torch.zeros(e + 1, dtype=torch.long, device=flat.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat.numel(), device=flat.device) - starts[sorted_key]
    keep = (pos < cap) & (sorted_key < e)
    slot_sorted = torch.where(keep, sorted_key * cap + pos, e * cap)
    return torch.empty_like(flat).scatter_(0, order, slot_sorted), counts[:e]


class _GatherRows(torch.autograd.Function):
    """All-gather of the batch's shards along dim 0 forward; backward, the
    rank's own rows (its output rows depend on no other shard's tokens
    through a gradient: routing is discrete)."""

    @staticmethod
    def forward(ctx, x, shard, batch):
        ctx.index, ctx.rows = batch.index, x.shape[0]
        return shard.batch_cat(x, batch.axes)

    @staticmethod
    def backward(ctx, g):
        r = ctx.index
        return g[r * ctx.rows:(r + 1) * ctx.rows], None, None


class MoE(Sharded):
    """Token-choice top-k mixture of experts with capacity and drops, and
    the always-on shared expert (the port of ``repro``'s ``moe``). The
    router is f32; padding experts (``padded_experts`` rounds the count to
    16) get logit -1e30.

    The combine gathers each token's k slot outputs (0 where dropped),
    scales them by their gates and adds them in ascending expert order:
    the order of ``repro``'s slot-order scatter-add, computed without
    atomics, so it is the same on every run and device.

    With ``cfg.moe_dropless`` (``dropless``) nothing is dropped: every
    assignment is computed (``_dropless``: rows sorted by expert, grouped
    GEMMs), combined in the same order. One device only: the mesh
    branches keep the capacity.

    On a mesh, ``repro``'s rule picks the branch: when the model axis
    divides the experts (a (1, 1) mesh included) the layer is expert
    parallel (``_moe_expert_parallel``): each rank routes its data
    shard's tokens, runs its E/M experts at a capacity per data shard
    (``moe_capacity`` of the shard's tokens), and one all-reduce over
    ``model`` sums the experts' parts, combined in expert order on each
    rank before it; the aux loss is averaged over the batch's shards. A
    decode step of a model built 2-D (``LMShard.ep2d``) gathers the
    step's tokens over the data axes instead and runs its experts' d_ff
    slice (``_moe_ep2d``, one all-reduce over model and data). Otherwise
    (the model axis does not divide the experts) the tokens are gathered
    and every rank runs every expert, as ``repro``'s global dispatch.
    """

    def __init__(self, cfg, *, device, dtype, generator=None, shard=None):
        super().__init__(shard)
        self.cfg = cfg
        self.dropless = cfg.moe_dropless
        if self.dropless and shard is not None:
            raise NotImplementedError(f"{cfg.name}: the dropless MoE runs "
                                      f"on one device; it has no mesh path")
        d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
        self.use_ep = shard is not None and e % shard.msize == 0
        self.tp = shard.msize if self.use_ep else 1
        self.e_loc = e // self.tp
        kw = dict(device=device, dtype=dtype, generator=generator,
                  shard=shard, tp=self.tp > 1)
        add_dense(self, "router", (d, e), **{**kw, "dtype": torch.float32})
        add_dense(self, "exp_wgate", (e, d, f), **kw)
        add_dense(self, "exp_wi", (e, d, f), **kw)
        add_dense(self, "exp_w_down", (e, f, d), **kw)
        self.shared = MLP(d, cfg.moe_shared_ff, device=device, dtype=dtype,
                          generator=generator, shard=shard) \
            if cfg.moe_shared_ff else None

    def route(self, xf: torch.Tensor):
        """xf (T, D) -> (gate (T, k) f32, exp_ids (T, k), probs (T, E))."""
        cfg = self.cfg
        logits = xf.to(torch.float32) @ self.w("router")
        if cfg.padded_experts != cfg.moe_experts:
            pad = torch.arange(cfg.padded_experts, device=xf.device) \
                >= cfg.moe_experts
            logits = logits.masked_fill(pad, -1e30)
        probs = torch.softmax(logits, dim=-1)
        gate, exp_ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, exp_ids, probs

    def _branch(self, decode: bool) -> str:
        """"single", "ep", "ep2d" or "gathered": the branch a call
        takes."""
        sh = self.shard
        if sh is None:
            return "single"
        if not self.use_ep:
            return "gathered"
        if (decode and sh.ep2d and sh.bsize > 1
                and self.cfg.d_ff % sh.bsize == 0):
            return "ep2d"
        return "ep"

    def dropped(self, x: torch.Tensor, decode: bool = False, batch=None
                ) -> torch.Tensor:
        """How many of the token-expert assignments of x (B, S, D) the
        capacity drops (a 0-d tensor on x's device; a dropless layer
        reads what its capacity path would drop): on a mesh, the
        count over the whole mesh under the branch ``forward`` takes
        (every rank calls it with ``forward``'s ``batch`` and gets the
        total)."""
        branch = self._branch(decode)
        batch = self._batch(batch)
        e = self.cfg.padded_experts
        if branch in ("ep2d", "gathered"):
            x = self.shard.batch_cat(x, batch.axes)
        t = x.shape[0] * x.shape[1]
        _, exp_ids, _ = self.route(x.reshape(t, -1))
        cap = moe_capacity(self.cfg, t, e)
        lo = self.shard.mrank * self.e_loc if self.tp > 1 else 0
        n = (moe_slots(exp_ids - lo, self.e_loc, cap)[1] - cap) \
            .clamp(min=0).sum()
        if branch == "single":
            return n
        if self.tp > 1:
            n = self.shard.reduce(n)
        if branch == "ep":
            n = self.shard.batch_sum(n, batch.axes)
        return n

    def _batch(self, batch):
        """``batch`` (a ``sharding.BatchShard``), which a call on a mesh
        must pass: whether x is the rank's block of a global batch
        decides what the capacity counts."""
        if self.shard is not None and batch is None:
            raise ValueError("a MoE layer on a mesh needs its batch's "
                             "BatchShard (Transformer passes it)")
        return batch

    def _experts(self, xf, gate, exp_ids, lo: int, cap: int,
                 gather: bool = True):
        """(T, D) output of the experts [lo, lo + e_loc) for the
        assignments routed to them within ``cap`` slots each, each token's
        parts added in ascending expert order; 0 for the others. The
        weights' data blocks are all-gathered first unless ``gather`` is
        False (ep2d: the rank's d_ff slice, a partial sum)."""
        t, d = xf.shape
        e_loc = self.exp_wgate.shape[0]
        trace.count("moe_rows", e_loc * cap)
        slot, counts = moe_slots(exp_ids - lo, e_loc, cap)
        n_slots = e_loc * cap
        tok = torch.arange(slot.numel(), device=xf.device) // gate.shape[1]
        tok_for_slot = torch.zeros(n_slots + 1, dtype=torch.long,
                                   device=xf.device).scatter_(0, slot, tok)
        valid = torch.arange(cap, device=xf.device)[None, :] \
            < counts[:, None]
        buf = torch.where(valid.reshape(-1, 1),
                          xf[tok_for_slot[:n_slots]], 0)
        buf = buf.view(e_loc, cap, d)
        wg, wi, wd = (self.w(n, gather) for n in ("exp_wgate", "exp_wi",
                                                   "exp_w_down"))
        hidden = nn.functional.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
        out_buf = torch.bmm(hidden, wd).view(n_slots, d)
        out_buf = torch.cat([out_buf, out_buf.new_zeros(1, d)])

        _, by_expert = torch.sort(exp_ids, dim=-1)
        slot = slot.view(t, -1).gather(1, by_expert)
        gate = gate.gather(1, by_expert).to(xf.dtype)
        return self._combine(out_buf, slot, gate)

    @staticmethod
    def _combine(rows, where, gate) -> torch.Tensor:
        """Each token's k expert outputs ``rows[where[:, j]]`` scaled by
        ``gate[:, j]`` (both (T, k), in ascending expert order) and added
        in that order."""
        out = rows.index_select(0, where[:, 0]) * gate[:, :1]
        for j in range(1, where.shape[1]):
            out = out + rows.index_select(0, where[:, j]) * gate[:, j:j + 1]
        return out

    def _dropless(self, xf, gate, exp_ids) -> torch.Tensor:
        """(T, D) output of the experts for every one of the T * k
        assignments, none dropped: the assignments sorted by expert (each
        token's in ascending expert order, a stable sort, so tokens keep
        their order within an expert), their rows gathered, SwiGLU through
        ``torch._grouped_mm`` over the experts held (rows [ends[e - 1],
        ends[e]) through expert e's weights; ``ends`` counted and left on
        the device), then ``_combine``. No host read."""
        t, k = exp_ids.shape
        trace.count("moe_rows", t * k)
        ids, by_expert = torch.sort(exp_ids, dim=-1)
        gate = gate.gather(1, by_expert).to(xf.dtype)
        flat = ids.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        ends = torch.zeros(self.exp_wgate.shape[0], dtype=torch.int32,
                           device=xf.device)
        ends = ends.scatter_add_(0, flat, torch.ones_like(
            flat, dtype=torch.int32)).cumsum(0, dtype=torch.int32)
        rows = xf.index_select(0, order // k)
        hidden = nn.functional.silu(torch._grouped_mm(
            rows, self.w("exp_wgate"), offs=ends)) \
            * torch._grouped_mm(rows, self.w("exp_wi"), offs=ends)
        del rows
        out_rows = torch._grouped_mm(hidden, self.w("exp_w_down"), offs=ends)
        del hidden
        where = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=xf.device))
        return self._combine(out_rows, where.view(t, k), gate)

    @staticmethod
    def _aux(probs, exp_ids, e: int) -> torch.Tensor:
        """Switch load-balance loss over the token set of ``probs``."""
        first = torch.zeros(e, dtype=torch.float32, device=probs.device)
        first.scatter_add_(0, exp_ids[:, 0],
                           torch.ones_like(probs[:, 0]))
        return e * torch.sum(first / probs.shape[0] * probs.mean(0))

    def forward(self, x: torch.Tensor, decode: bool = False, batch=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, D) -> (output (B, S, D), Switch load-balance aux loss
        f32). ``decode``: a decode step (a 2-D model takes ep2d);
        ``batch``: on a mesh, how the global batch lies on it (x holds
        the rank's rows of it)."""
        with trace.span("repro_torch.moe", x.device):
            return self._forward(x, decode, batch)

    def _forward(self, x, decode, batch):
        b, s, d = x.shape
        e = self.cfg.padded_experts
        branch = self._branch(decode)
        batch = self._batch(batch)
        if branch == "ep":
            out, aux = self._moe_expert_parallel(x, batch)
        elif branch == "single":
            t = b * s
            xf = x.reshape(t, d)
            gate, exp_ids, probs = self.route(xf)
            aux = self._aux(probs, exp_ids, e)
            with trace.span("repro_torch.experts"):
                if self.dropless:
                    out = self._dropless(xf, gate, exp_ids)
                else:
                    out = self._experts(xf, gate, exp_ids, 0,
                                        moe_capacity(self.cfg, t, e))
            out = out.view(b, s, d)
        else:
            out, aux = self._moe_gathered(x, branch == "ep2d", batch)
        if self.shared is not None:
            out = out + self.shared(x)
        return out, aux

    def _moe_expert_parallel(self, x, batch):
        """``repro``'s ``_moe_expert_parallel`` on this rank's batch
        shard."""
        sh = self.shard
        b, s, d = x.shape
        e, t = self.cfg.padded_experts, b * s
        xf = x.reshape(t, d)
        gate, exp_ids, probs = self.route(xf)
        aux = sh.batch_mean(self._aux(probs, exp_ids, e), batch.axes)
        cap = moe_capacity(self.cfg, t, e)
        lo = sh.mrank * self.e_loc if self.tp > 1 else 0
        part = self._experts(self._enter(xf), self._enter(gate), exp_ids,
                             lo, cap)
        return self._reduce(part).view(b, s, d), aux

    def _moe_gathered(self, x, ep2d: bool, batch):
        """The step's tokens gathered over the batch's shards: routing and
        capacity over all of them, the rank's experts (``ep2d``: experts
        over ``model``, d_ff over ``data``, one all-reduce over both), and
        the rank's own rows kept (``repro``'s ``_moe_ep2d``; with every
        expert on every rank, its global dispatch)."""
        sh = self.shard
        b, s, d = x.shape
        e = self.cfg.padded_experts
        split = bool(batch.axes)
        x_all = _GatherRows.apply(x, sh, batch) if split else x
        xf = x_all.reshape(-1, d)
        gate, exp_ids, probs = self.route(xf)
        aux = self._aux(probs, exp_ids, e)
        cap = moe_capacity(self.cfg, xf.shape[0], e)
        lo = sh.mrank * self.e_loc if self.tp > 1 else 0
        part = self._experts(self._enter(xf), self._enter(gate), exp_ids,
                             lo, cap, gather=not ep2d)
        if ep2d:
            # d_ff lies over ``data`` alone, the same slices in every pod:
            # the sum is complete over model and data (``repro``'s psum
            # also over pod counts each expert once a pod)
            part = sh.reduce(sh.reduce(part), sh.dgroup)
        else:
            part = self._reduce(part)
        out = part.view(-1, s, d)
        if split:
            out = out[batch.index * b:(batch.index + 1) * b]
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
    (B, S, N) f32, in chunks of ``largest_divisor(S, chunk)``. Each chunk
    adds the masked "attention" form inside it and the term of the
    (B, H, P, N) f32 state it starts with. The chunks go ``ssd_group``
    at a time: their inner forms and their own states' parts batched,
    then the carried state stepped through them one by one (a multiply
    and an add a chunk, ``repro``'s order), then their carried terms
    batched. The decay mask is applied to the exponent (-inf before exp),
    so a masked slot is exp(-inf) = 0 and its gradient 0, never inf * 0.
    The decays' prefix sums and their differences are taken in f64
    (``repro``: f32), since exp(cum_i - cum_j) subtracts sums of up to
    thousands from one another and an f32 ulp of such a sum is ~1e-4 of a
    decay. Returns (y (B, S, H, P), final state (B, H, P, N)). Counts its
    chunks (``ssd_chunks``) under the span ``repro_torch.ssd``."""
    with trace.span("repro_torch.ssd", xh.device):
        return _ssd_scan(xh, dt, a_log, bmat, cmat, chunk)


def ssd_group(b: int, l: int, h: int, budget_bytes: int = 2**30) -> int:
    """Chunks of length l one batched step of :func:`ssd_scan` takes: as
    many as keep its (B, G, l, l, H) f64 decay differences under
    ``budget_bytes``, at least 1."""
    return max(1, budget_bytes // (b * l * l * h * 8))


def _ssd_scan(xh, dt, a_log, bmat, cmat, chunk: int):
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    l = largest_divisor(s, chunk)
    nc = s // l
    trace.count("ssd_chunks", nc)
    keep = torch.ones((l, l), dtype=torch.bool, device=xh.device).tril()
    a = -torch.exp(a_log)
    xs, dts = xh.view(b, nc, l, h, p), dt.view(b, nc, l, h)
    bs, cs = bmat.view(b, nc, l, n), cmat.view(b, nc, l, n)
    state = xh.new_zeros((b, h, p, n))
    ys = []
    g = ssd_group(b, l, h)
    for c0 in range(0, nc, g):
        xc, dtc, bc, cc = (v[:, c0:c0 + g] for v in (xs, dts, bs, cs))
        cum = torch.cumsum(a * dtc, dim=2, dtype=torch.float64)  # B,G,l,H
        scores = cc @ bc.transpose(-1, -2)                      # B,G,i,j
        diff = (cum[:, :, :, None] - cum[:, :, None]).float()   # B,G,i,j,H
        decay = torch.exp(diff.masked_fill(~keep[:, :, None],
                                           float("-inf")))
        w = scores[..., None] * decay * dtc[:, :, None]
        y_intra = torch.einsum("bgijh,bgjhp->bgihp", w, xc)
        seg = (torch.exp((cum[:, :, -1:] - cum).float())
               * dtc)[..., None] * xc
        own = torch.einsum("bgjn,bgjhp->bghpn", bc, seg)
        last = torch.exp(cum[:, :, -1].float())[..., None, None]
        starts = []
        for k in range(own.shape[1]):
            starts.append(state)
            state = state * last[:, k] + own[:, k]
        y_inter = torch.einsum("bgin,bghpn->bgihp", cc,
                               torch.stack(starts, 1)) \
            * torch.exp(cum.float())[..., None]
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1).view(b, s, h, p), state


def ssd_chunk(b: int, s: int, h: int, budget_bytes: int = 4 * 2**30) -> int:
    """``repro``'s ``_ssd_sizes``: the chunk length l whose (B, l, l, H)
    f32 decay stays under ``budget_bytes``."""
    for l in (256, 128, 64, 32):
        if b * l * l * h * 4 <= budget_bytes:
            return l
    return 16


def init_mamba_cache(b: int, cfg, *, device, dtype, tp: int = 1) -> dict:
    """One Mamba2 layer's cache: {'conv': the last W - 1 pre-conv inputs
    (B, W - 1, C) in ``dtype``, 'ssm': the state (B, H, P, N) f32}; with
    ``tp`` model ranks over the heads, one rank's (C = d_inner / tp +
    2 N, H / tp heads)."""
    conv_ch = cfg.d_inner // tp + 2 * cfg.ssm_state
    return {"conv": torch.zeros((b, cfg.ssm_conv_width - 1, conv_ch),
                                device=device, dtype=dtype),
            "ssm": torch.zeros((b, cfg.ssm_heads // tp, cfg.ssm_head_dim,
                                cfg.ssm_state), device=device,
                               dtype=torch.float32)}


class Mamba2(Sharded):
    """The Mamba2 mixer: in_proj to [z, x, B, C, dt], the causal conv over
    [x, B, C], the SSD scan, the skip ``ssm_d``, the silu(z) gate, an
    RMSNorm (eps 1e-5, not ``cfg.norm_eps``, as ``repro``) and out_proj.
    ``a_log``, ``dt_bias`` and ``ssm_d`` are f32 whatever the dtype.

    On a mesh whose model axis divides the SSM heads, a rank holds its
    heads' z, x and dt columns of ``in_proj`` and every B and C column
    (stored [z | x | B | C | dt] as ``repro``'s, the layout is not
    head-aligned), the conv's x channels of its heads and every B and C
    channel, its heads' ``a_log``/``dt_bias``/``ssm_d``, its slice of
    ``norm_scale`` and its rows of ``out_proj`` (all-reduced after). The
    gated RMSNorm normalises over the whole d_inner: its sum of squares
    is all-reduced over ``model``."""

    def __init__(self, cfg, *, device, dtype, generator=None, shard=None):
        super().__init__(shard)
        self.cfg = cfg
        d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        hp = cfg.ssm_head_dim
        self.tp = self._tp(nh)
        self.nh_loc, self.di_loc = nh // self.tp, di // self.tp
        conv_ch = di + 2 * n
        proj_ix = conv_ix = norm_ix = None
        if self.tp > 1:
            heads = torch.arange(nh).view(self.tp, -1)
            ch = (heads[..., None] * hp + torch.arange(hp)).flatten(1)
            bc = torch.arange(2 * n).expand(self.tp, -1)
            proj_ix = (1, torch.cat([ch, di + ch, 2 * di + bc,
                                     2 * di + 2 * n + heads], dim=1))
            conv_ix = (1, torch.cat([ch, di + bc], dim=1))
            norm_ix = (0, ch)
        kw = dict(device=device, dtype=dtype, generator=generator,
                  shard=shard, tp=self.tp > 1)
        f32 = dict(device=device, dtype=torch.float32)
        add_dense(self, "in_proj", (d, 2 * di + 2 * n + nh),
                  model_index=proj_ix, **kw)
        add_dense(self, "conv_w", (cfg.ssm_conv_width, conv_ch), scale=3.0,
                  model_index=conv_ix, **kw)
        add_param(self, "conv_b", (conv_ch,),
                  model_index=conv_ix and (0, conv_ix[1]),
                  fill=torch.zeros(conv_ch, device=device, dtype=dtype),
                  **kw)
        kw32 = {**kw, "dtype": torch.float32}
        add_param(self, "a_log", (nh,), **kw32,
                  fill=torch.log(torch.linspace(1.0, 16.0, nh, **f32)))
        add_param(self, "dt_bias", (nh,), fill=torch.zeros(nh, **f32),
                  **kw32)
        add_param(self, "ssm_d", (nh,), fill=torch.ones(nh, **f32), **kw32)
        add_dense(self, "out_proj", (di, d), **kw)
        add_param(self, "norm_scale", (di,), model_index=norm_ix,
                  fill=torch.ones(di, device=device, dtype=dtype), **kw)

    def _split(self, proj: torch.Tensor):
        di, n = self.di_loc, self.cfg.ssm_state
        return proj.split([di, di, n, n, self.nh_loc], dim=-1)

    def _norm(self, y: torch.Tensor) -> torch.Tensor:
        """The gated RMSNorm (eps 1e-5) over the whole d_inner: on a mesh
        the f32 sum of squares of the rank's slice, all-reduced."""
        scale = self.w("norm_scale")
        if self.tp == 1:
            return rmsnorm(scale, y)
        yf = y.to(torch.float32)
        ss = yf.square().sum(-1, keepdim=True)
        if torch.is_grad_enabled() and ss.requires_grad:
            ss = _ReduceBoth.apply(ss, self.shard.mgroup)
        else:
            ss = self.shard.reduce(ss)
        rms = torch.rsqrt(ss / self.cfg.d_inner + 1e-5)
        return (yf * rms).to(y.dtype) * scale

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        y = y * nn.functional.silu(z)
        return self._reduce(self._norm(y) @ self.w("out_proj"))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """x (B, S, D) -> (out (B, S, D), cache {'conv', 'ssm'}): the
        last W - 1 pre-conv inputs, zero-padded on the left when S < W - 1,
        and the final SSM state (the rank's channels and heads); under the
        span ``repro_torch.mamba``."""
        with trace.span("repro_torch.mamba", x.device):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        b, s, _ = x.shape
        di, n, nh, hp = self.di_loc, cfg.ssm_state, self.nh_loc, \
            cfg.ssm_head_dim
        z, xin, bmat, cmat, dt = self._split(self._enter(x)
                                             @ self.w("in_proj"))
        xbc_raw = torch.cat([xin, bmat, cmat], dim=-1)
        xin, bmat, cmat = causal_conv(xbc_raw, self.w("conv_w"),
                                      self.w("conv_b")).split([di, n, n],
                                                              dim=-1)
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
        di, n, nh, hp = self.di_loc, cfg.ssm_state, self.nh_loc, \
            cfg.ssm_head_dim
        z, xin, bmat, cmat, dt = self._split(x @ self.w("in_proj"))
        conv_in = torch.cat([cache["conv"],
                             torch.cat([xin, bmat, cmat], dim=-1)], dim=1)
        conv = torch.sum(conv_in * self.w("conv_w"), dim=1, keepdim=True)
        xin, bmat, cmat = nn.functional.silu(conv + self.w("conv_b")).split(
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
