"""The LM: embeddings, the modality prefix, the encoder and the layer
stack, the training forward and loss, prefill and one-token decode
against a cache.

The port of ``repro.models.transformer``. ``repro`` stacks the layers'
params over ``n_rep`` and scans them; here they are an ``nn.ModuleList``
of ``Block``s, one per layer in stack order, each built for its
``LayerSpec`` (``interop.lm_params_from_numpy`` unstacks ``repro``'s
params); an encoder-decoder model has a second list, ``enc_layers``, for
``cfg.encoder_pattern``. The cache is a list with one dict per layer:
{'k', 'v': (B, Sbuf, Hkv, Dh)} for attention, {'conv', 'ssm'} for
Mamba2, and with cross-attention also {'xk', 'xv': (B, Sm, Hkv, Dh)},
the encoder memory's K/V (``repro``'s ``l<i>_xk`` / ``l<i>_xv``);
``decode_step`` updates it in place.

On a mesh (``Transformer(cfg, mesh=...)``, a ``("data", "model")`` or
``("pod", "data", "model")`` ``DeviceMesh``) each rank holds its slices
of the weights (``sharding.LMShard``). Every rank passes the global
batch to ``forward``, ``prefill``, ``decode_step``, ``init_cache`` and
``lm_loss``; the model takes its rows (``batch_shard``: sharded over the
data axes when they divide it, else all of it) and returns theirs. The
embedding is vocab-parallel over
``model`` (a masked local lookup, then an all-reduce), the unembedding
column-parallel: ``logits`` all-gathers them over ``model`` (serving's
argmax sees the whole vocabulary) and ``lm_loss`` takes a vocab-parallel
log-sum-exp. The cache holds the rank's rows, K/V heads and SSM
channels. Without a mesh the code is the single-device one.

The modality frontends are stubs, as in ``repro``: a vision model takes
projected patch embeddings (B, P, D) that go before the token embeddings
(``modal_embeds``), an audio model frame embeddings (B, Sm, D) that its
encoder reads (``enc_embeds``).

Training (``forward`` + ``lm_loss``) rematerialises as ``repro`` does:
each block (encoder blocks too) runs under ``torch.utils.checkpoint``
(``repro`` checkpoints its scan bodies), and each 512-token chunk of the
loss too, so the (B, S, V) f32 logits never exist at once.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch._device import resolve_device
from repro_torch.kernels.flash_prefill import largest_divisor

from . import layers
from .arch import ArchConfig, LayerSpec
from .sharding import all_reduce, cache_pspec, shard_of

#: logit of a vocab-padding id
VOCAB_PAD_NEG = -1e30


class Block(nn.Module):
    """One sublayer of kind ``spec``: x + mixer(norm(x)) with an attention
    or Mamba2 mixer; with ``spec.cross_attn``, x + cross(cross_norm(x))
    over the encoder's memory (skipped without one); then x + ff(norm(x))
    with an MLP or an MoE, or no feed-forward (and no ``ff_norm``). Each
    sublayer's output is multiplied by ``residual`` (the config's
    ``residual_multiplier``) before its add, where that is not 1."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, device, dtype,
                 generator=None, shard=None):
        super().__init__()
        self.spec = spec
        self.residual = cfg.residual_multiplier
        kw = dict(device=device, dtype=dtype)
        mk = dict(kw, generator=generator, shard=shard)
        self.mixer_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        mixer = layers.Attention if spec.mixer == "attn" else layers.Mamba2
        self.mixer = mixer(cfg, **mk)
        if spec.cross_attn:
            self.cross_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
            self.cross = layers.Attention(cfg, **mk)
        if spec.ff != "none":
            self.ff_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
            self.ff = layers.MoE(cfg, **mk) if spec.ff == "moe" else \
                layers.MLP(cfg.d_model, cfg.d_ff, **mk)

    def feed_forward(self, x, decode: bool = False, batch=None):
        """(x + ff(ff_norm(x)), the MoE's aux loss or None); ``decode``: a
        decode step (the MoE's branch may differ); ``batch``: on a mesh,
        the global batch's ``BatchShard``."""
        if self.spec.ff == "none":
            return x, None
        h = self.ff_norm(x)
        if self.spec.ff == "moe":
            out, aux = self.ff(h, decode=decode, batch=batch)
            return self.add(x, out), aux
        return self.add(x, self.ff(h)), None

    def add(self, x, h):
        """The residual add x + h, h times ``residual`` where that is not
        1."""
        return x + h if self.residual == 1 else x + h * self.residual

    def forward(self, x, *, window: int, positions, memory=None,
                batch=None):
        """(x out, the MoE's aux or None, this layer's cache entries:
        {'k', 'v'} of the prompt or Mamba2's {'conv', 'ssm'}, and the
        cross K/V {'xk', 'xv'} of ``memory`` (B, Sm, D) when the layer
        cross-attends)."""
        h = self.mixer_norm(x)
        if self.spec.mixer == "attn":
            h, (k, v) = self.mixer(h, causal=self.spec.causal,
                                   window=window, positions=positions)
            cache = {"k": k, "v": v}
        else:
            h, cache = self.mixer(h)
        x = self.add(x, h)
        if self.spec.cross_attn and memory is not None:
            h, (xk, xv) = self.cross(self.cross_norm(x), memory=memory)
            x = self.add(x, h)
            cache = {**cache, "xk": xk, "xv": xv}
        x, aux = self.feed_forward(x, batch=batch)
        return x, aux, cache

    def train_forward(self, x, window: int, positions, memory=None,
                      batch=None):
        """forward without the cache (the function each checkpoint
        reruns; ``memory`` is an input, so its gradient reaches the
        encoder)."""
        return self(x, window=window, positions=positions,
                    memory=memory, batch=batch)[:2]

    def decode(self, x, cache: dict, pos: int, *, window: int,
               batch=None):
        h = self.mixer_norm(x)
        if self.spec.mixer == "attn":
            h = self.mixer.decode(h, cache, pos, window=window)
        else:
            h = self.mixer.decode(h, cache)
        x = self.add(x, h)
        if self.spec.cross_attn and "xk" in cache:
            x = self.add(x, self.cross.decode_cross(
                self.cross_norm(x), cache["xk"], cache["xv"]))
        return self.feed_forward(x, decode=True, batch=batch)[0]


class Transformer(layers.Sharded):
    """The LM for ``cfg``: one ``Block`` per layer, of its ``LayerSpec``,
    and for an encoder-decoder ``cfg`` the encoder's blocks
    (``enc_layers``, ``cfg.encoder_pattern`` repeated) and ``enc_norm``.

    With a ``generator`` the weights are drawn on ``device`` from
    ``repro``'s distributions (the port of ``init_params``): embed
    N(0, 0.02^2), unembed N(0, 1/d), projections N(0, 1/fan_in) (the conv
    kernel 3^2 / W), norm scales 1, Mamba2's constants as ``repro``'s.
    Without one they are left uninitialised for a loader
    (``interop.lm_params_from_numpy``). ``dtype`` is the weights' and the
    activations'; the MoE router and Mamba2's ``a_log``, ``dt_bias`` and
    ``ssm_d`` stay f32 (move a model with ``.to(device)``, never
    ``.to(dtype)``).

    ``mesh`` (a ``DeviceMesh``) shards it (``sharding.LMShard``):
    ``fsdp`` puts the weights' FSDP dims over ``data``; ``ep2d`` lays the
    experts out 2-D for decode. With a generator every rank draws each
    full leaf in turn and keeps its slice, so every mesh serves the same
    model, and no rank holds more than one full leaf at a time.
    """

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, mesh=None,
                 fsdp: bool = False, ep2d: bool = False):
        super().__init__(shard_of(mesh, fsdp=fsdp, ep2d=ep2d))
        self.cfg = cfg
        dev = resolve_device(device)
        # a model on the meta device holds no data: any mesh may hold it
        # (the dry run's production meshes, ``launch.dryrun``)
        if mesh is not None and dev.type not in (mesh.device_type, "meta"):
            raise ValueError(f"a {mesh.device_type} mesh cannot hold a "
                             f"model on {dev}")
        kw = dict(device=dev, dtype=dtype)
        mk = dict(kw, generator=generator, shard=self.shard)
        d, v = cfg.d_model, cfg.padded_vocab
        self.tp = self._tp(v)
        layers.add_param(self, "embed", (v, d), std=0.02, tp=self.tp > 1,
                         **mk)
        self.layers = nn.ModuleList(
            Block(cfg, spec, **mk)
            for _ in range(cfg.n_rep) for spec in cfg.pattern)
        if cfg.is_encoder_decoder:
            pat = cfg.encoder_pattern
            self.enc_layers = nn.ModuleList(
                Block(cfg, spec, **mk)
                for _ in range(cfg.encoder_layers // len(pat))
                for spec in pat)
            self.enc_norm = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.final_norm = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.unembed = None
        if not cfg.tie_embeddings:
            layers.add_param(self, "unembed", (d, v), std=d ** -0.5,
                             tp=self.tp > 1, **mk)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def param_layouts(self) -> dict:
        """{parameter name: its ``sharding.Layout``, None where every rank
        holds it whole} (all None without a mesh)."""
        out = {}
        for mname, mod in self.named_modules():
            lays = getattr(mod, "layouts", {})
            for pname, _ in mod.named_parameters(recurse=False):
                out[f"{mname}.{pname}" if mname else pname] = \
                    lays.get(pname)
        return out

    def placements(self) -> dict:
        """{parameter name: ``sharding.Placement``, or None where every
        rank holds it whole} — ``checkpoint``'s ``shardings``."""
        from .sharding import Placement

        return {n: None if lay is None else Placement(self.shard, lay)
                for n, lay in self.param_layouts().items()}

    def full_named(self, named: dict) -> dict:
        """{name: full leaf} of {name: this rank's tensor} (parameters,
        gradients or moments, by parameter name); on a mesh every rank
        calls it and gets the full leaves."""
        lays = self.param_layouts()
        return {n: t if lays[n] is None else self.shard.gather(t, lays[n])
                for n, t in named.items()}

    def full_shapes(self) -> dict:
        """{parameter name: its full shape} (``repro``'s leaf shapes)."""
        lays = self.param_layouts()
        return {n: lays[n].shape if lays[n] is not None else tuple(p.shape)
                for n, p in self.named_parameters()}

    def param_count(self) -> int:
        """The full model's parameters (on a mesh too)."""
        return sum(math.prod(s) for s in self.full_shapes().values())

    def active_param_count(self) -> int:
        """Parameters a token touches: the MoE's top_k of its padded
        routed experts."""
        e, k = self.cfg.padded_experts, self.cfg.moe_top_k
        shapes = self.full_shapes()
        inactive = sum((e - k) * (math.prod(s) // e)
                       for n, s in shapes.items()
                       if n.rsplit(".", 1)[-1] in ("exp_wgate", "exp_wi",
                                                   "exp_w_down"))
        return self.param_count() - inactive

    def _unembedding(self) -> torch.Tensor:
        return self.w("embed").t() if self.unembed is None \
            else self.w("unembed")

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings, times ``cfg.embedding_multiplier`` where that
        is not 1; vocab-parallel on a mesh: the rank looks up the ids in
        its rows, the rest are 0, and an all-reduce over ``model``
        completes them."""
        emb, mult = self.w("embed"), self.cfg.embedding_multiplier
        if self.tp == 1:
            x = nn.functional.embedding(tokens, emb)
        else:
            lo, rows = self.shard.mrank * emb.shape[0], emb.shape[0]
            local = tokens - lo
            ok = (local >= 0) & (local < rows)
            x = nn.functional.embedding(local.clamp(0, rows - 1), emb)
            x = self.shard.reduce(torch.where(ok[..., None], x, 0))
        return x if mult == 1 else x * mult

    def _scale_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """``logits`` over ``cfg.logits_scaling`` where that is not 1."""
        div = self.cfg.logits_scaling
        return logits if div == 1 else logits / div

    def _mask_pad_logits(self, logits: torch.Tensor, lo: int = 0
                         ) -> torch.Tensor:
        """Padding ids' logits at -1e30, out of place (autograd-safe);
        ``logits``' last axis holds the ids from ``lo`` on."""
        if self.cfg.padded_vocab == self.cfg.vocab:
            return logits
        pad = torch.arange(lo, lo + logits.shape[-1],
                           device=logits.device) >= self.cfg.vocab
        return logits.masked_fill(pad, VOCAB_PAD_NEG)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., D) -> logits (..., padded_vocab) over
        ``cfg.logits_scaling``, padding ids at -1e30 so softmax and argmax
        never see them (on a mesh, the ranks' vocabulary blocks
        all-gathered over ``model``)."""
        logits = self._scale_logits(hidden @ self._unembedding())
        if self.tp > 1:
            logits = self.shard.model_cat(logits, -1)
        return self._mask_pad_logits(logits)

    def batch_shard(self, b: int):
        """How a global batch of ``b`` rows lies on the mesh (a
        ``sharding.BatchShard``: its axes and this rank's rows); None
        without a mesh."""
        return None if self.shard is None else self.shard.batch(b)

    @staticmethod
    def _rows(batch, *xs):
        """``xs`` (global batches, or None) cut to ``batch``'s rows."""
        if batch is None:
            return xs
        return tuple(None if x is None else x[batch.rows] for x in xs)

    def _run(self, blocks, x, window: int, positions, memory=None,
             batch=None):
        """``blocks`` over x (the training forward): (x, aux summed over
        the MoE layers), each block checkpointed when autograd records."""
        remat = torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in blocks:
            if remat:
                x, a = checkpoint(blk.train_forward, x, window, positions,
                                  memory, batch, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = blk.train_forward(x, window, positions, memory,
                                         batch)
            if a is not None:
                aux = aux + a
        return x, aux

    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder over frame embeddings (B, Sm, D), cast to the
        model's dtype: its blocks (RoPE over ``arange(Sm)``, no window;
        bidirectional where the pattern says so), then ``enc_norm``. On a
        mesh, the rank's rows of the global batch."""
        batch = self.batch_shard(enc_embeds.shape[0])
        (x,) = self._rows(batch, enc_embeds.to(self.dtype))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _ = self._run(self.enc_layers, x, 0, positions, batch=batch)
        return self.enc_norm(x)

    def _inputs(self, tokens, modal_embeds, enc_embeds):
        """(x: the modal prefix (cast to the embedding's dtype) before the
        token embeddings, (B, P + S, D); positions ``arange(P + S)``; the
        encoder's memory or None; the batch's ``BatchShard``): on a mesh
        the rank's rows of the global inputs."""
        batch = self.batch_shard(tokens.shape[0])
        tokens, modal_embeds = self._rows(batch, tokens, modal_embeds)
        x = self._embed(tokens)
        if modal_embeds is not None:
            x = torch.cat([modal_embeds.to(x.dtype), x], dim=1)
        memory = None
        if self.cfg.is_encoder_decoder:
            if enc_embeds is None:
                raise ValueError(f"{self.cfg.name} is an encoder-decoder "
                                 f"model: pass enc_embeds")
            memory = self.encode(enc_embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return x, positions, memory, batch

    def forward(self, tokens: torch.Tensor, *,
                modal_embeds: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None, window: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward: tokens (B, S), the modality prefix
        ``modal_embeds`` (B, P, D) and the encoder's ``enc_embeds``
        (B, Sm, D) -> (final-normed hidden (B, P + S, D), aux loss f32):
        ``repro``'s MoE load-balance terms summed over the MoE layers, 0
        without one. Each block is checkpointed when autograd records. On
        a mesh the inputs are the global batch and the hidden the rank's
        rows."""
        x, positions, memory, batch = self._inputs(tokens, modal_embeds,
                                                   enc_embeds)
        x, aux = self._run(self.layers, x, window, positions, memory, batch)
        return self.final_norm(x), aux

    def _chunk_loss(self, h, t, m, unemb):
        """(sum of masked token losses, sum of the mask) of one chunk; on a
        mesh the log-sum-exp and the target's logit are vocab-parallel
        (the max, the sum of exponentials and the target's logit
        all-reduced over ``model``)."""
        if self.tp == 1:
            logits = self._mask_pad_logits(
                self._scale_logits(h @ unemb).to(torch.float32))
            lse = torch.logsumexp(logits, dim=-1)
            correct = logits.gather(-1, t[..., None])[..., 0]
            return ((lse - correct) * m).sum(), m.sum()
        sh, rows = self.shard, unemb.shape[1]
        lo = sh.mrank * rows
        logits = self._mask_pad_logits(
            self._scale_logits(sh.enter(h) @ unemb).to(torch.float32), lo)
        mx = all_reduce(logits.detach().amax(-1, keepdim=True), sh.mgroup,
                        torch.distributed.ReduceOp.MAX)
        lse = mx[..., 0] + sh.reduce((logits - mx).exp().sum(-1)).log()
        local = t - lo
        ok = (local >= 0) & (local < rows)
        mine = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
        correct = sh.reduce(torch.where(ok, mine, 0.0))
        return ((lse - correct) * m).sum(), m.sum()

    def lm_loss(self, hidden: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor | None = None, chunk: int = 512
                ) -> torch.Tensor:
        """Mean softmax cross-entropy of ``targets`` (B, S) under the
        logits of ``hidden`` (B, S, D), over ``mask`` (default all ones):
        f32 over ``largest_divisor(S, chunk)``-token chunks, each
        checkpointed when autograd records; the masked sum over
        ``max(sum(mask), 1)``. On a mesh ``targets`` and ``mask`` are the
        global batch and ``hidden`` the rank's rows (``forward``'s): the
        rank's masked sum over the global count, its share of the
        mean."""
        unemb = self._unembedding()
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=hidden.device)
        denom = None
        if self.shard is not None:
            denom = mask.sum()
            targets, mask = self._rows(self.batch_shard(targets.shape[0]),
                                       targets, mask)
        s = hidden.shape[1]
        c = largest_divisor(s, chunk)
        remat = torch.is_grad_enabled()
        losses, counts = [], []
        for i0 in range(0, s, c):
            args = (hidden[:, i0:i0 + c], targets[:, i0:i0 + c],
                    mask[:, i0:i0 + c], unemb)
            out = checkpoint(self._chunk_loss, *args, use_reentrant=False,
                             preserve_rng_state=False) if remat \
                else self._chunk_loss(*args)
            losses.append(out[0])
            counts.append(out[1])
        if denom is None:
            denom = torch.stack(counts).sum()
        return torch.stack(losses).sum() / torch.clamp(denom, min=1.0)

    def init_cache(self, batch: int, max_len: int, *, window: int = 0,
                   memory_len: int = 0) -> list[dict]:
        """Zeroed caches, one per layer, for a (global) batch of ``batch``
        rows: attention's in the model's dtype with ``min(max_len,
        window)`` slots with a window, else ``max_len``; Mamba2's conv
        tail in the model's dtype and its state in f32; with
        ``memory_len``, a cross-attending layer's 'xk'/'xv' (B,
        memory_len, Hkv, Dh) in the model's dtype. On a mesh each leaf is
        the rank's block of it by ``sharding.cache_pspec``: its rows, its
        K/V heads (the heads it keeps where the spec says "model*") and
        its SSM heads and conv channels."""
        sbuf = min(max_len, window) if window else max_len
        cfg, dt = self.cfg, self.dtype
        bs = self.batch_shard(batch)
        f32 = torch.float32
        caches = []
        for blk in self.layers:
            m = blk.mixer
            if blk.spec.mixer == "attn":
                kv = (batch, sbuf, cfg.n_kv_heads, cfg.hd)
                c = {k: self._cache_leaf(k, kv, m.hkv_loc, bs, dt)
                     for k in ("k", "v")}
            else:
                conv = (batch, cfg.ssm_conv_width - 1,
                        cfg.d_inner + 2 * cfg.ssm_state)
                ssm = (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state)
                c = {"conv": self._cache_leaf(
                        "conv", conv, m.di_loc + 2 * cfg.ssm_state, bs, dt),
                     "ssm": self._cache_leaf("ssm", ssm, None, bs, f32)}
            if blk.spec.cross_attn and memory_len:
                kv = (batch, memory_len, cfg.n_kv_heads, cfg.hd)
                c.update({k: self._cache_leaf(k, kv, blk.cross.hkv_loc, bs,
                                              dt) for k in ("xk", "xv")})
            caches.append(c)
        return caches

    def _cache_leaf(self, name: str, shape: tuple, kept, batch, dtype
                    ) -> torch.Tensor:
        """Zeros of the rank's block of a cache leaf of global ``shape``
        (``kept``: its size along a "model*" dim)."""
        local = list(shape)
        if self.shard is not None:
            spec = cache_pspec(name, shape, self.cfg, self.shard.mesh,
                               batch.axes or None)
            for i, a in enumerate(spec):
                if a == "model":
                    local[i] //= self.shard.msize
                elif a == "model*":
                    local[i] = kept
                elif a is not None:
                    local[i] //= batch.size
        return torch.zeros(local, device=self.device, dtype=dtype)

    @torch.no_grad()
    def prefill_cross_cache(self, cache: list[dict], memory: torch.Tensor
                            ) -> list[dict]:
        """Write each cross-attending layer's K/V of the encoder's
        ``memory`` (B, Sm, D) into ``cache``'s 'xk'/'xv' (from
        ``init_cache(memory_len=Sm)``), cast to their dtype, in place
        (``repro``'s ``prefill_cross_cache``); returns ``cache``."""
        for blk, c in zip(self.layers, cache):
            if blk.spec.cross_attn:
                xk, xv = blk.cross.kv(memory)
                c["xk"].copy_(xk)
                c["xv"].copy_(xv)
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *,
                modal_embeds: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None, window: int = 0,
                max_len: int = 0) -> tuple[torch.Tensor, list[dict]]:
        """Run the prompt tokens (B, S) after the modality prefix
        ``modal_embeds`` (B, P, D), and for an encoder-decoder model over
        the encoder's memory of ``enc_embeds`` (B, Sm, D); returns
        (last-position logits (B, 1, V), cache) so that ``decode_step``
        continues at position P + S.

        An attention layer's cache holds the post-RoPE K/V of the P + S
        positions. Without a window it has ``max_len`` slots when
        ``max_len > P + S`` (the rest zero), else P + S. With a window it
        has P + S slots whatever ``max_len`` says, as in ``repro`` (its
        prefill pads only unwindowed caches), and the positions must fit
        the window. A Mamba2 layer's cache is its conv tail and final
        state, never padded. A cross-attending layer's 'xk'/'xv' are the
        memory's K/V as its cross-attention computed them, uncast (as
        ``repro``'s ``prefill_cross_cache_from``).

        On a mesh the inputs are the global batch; the logits and the
        cache are the rank's rows. The call is the root span
        ``repro_torch.prefill``.
        """
        with trace.span("repro_torch.prefill", self.device):
            return self._prefill(tokens, modal_embeds, enc_embeds, window,
                                 max_len)

    def _prefill(self, tokens, modal_embeds, enc_embeds, window, max_len):
        x, positions, memory, batch = self._inputs(tokens, modal_embeds,
                                                   enc_embeds)
        b, s = x.shape[:2]
        if window and s > window:
            raise ValueError(f"windowed prefill of {s} positions is longer "
                             f"than the window {window}")
        sbuf = max_len if max_len > s and not window else s
        cache = []
        for blk in self.layers:
            x, _, c = blk(x, window=window, positions=positions,
                          memory=memory, batch=batch)
            if blk.spec.mixer == "attn":
                kv = layers.init_kv_cache(b, sbuf, blk.mixer.hkv_loc,
                                          self.cfg.hd, device=self.device,
                                          dtype=self.dtype)
                kv["k"][:, :s] = c["k"]
                kv["v"][:, :s] = c["v"]
                c = {**c, **kv}
            cache.append(c)
        x = self.final_norm(x[:, -1:, :])
        return self.logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: list[dict], token: torch.Tensor, pos: int,
                    *, window: int = 0) -> tuple[torch.Tensor, list[dict]]:
        """One serve step: token (B, 1) at absolute position ``pos`` (a host
        int); returns (logits (B, 1, V), cache), the cache updated in
        place. MoE layers route the B tokens of the step together and
        drop their aux loss, as ``repro`` does. On a mesh ``token`` is the
        global batch's and the logits the rank's rows (``prefill``'s
        cache)."""
        batch = self.batch_shard(token.shape[0])
        (token,) = self._rows(batch, token)
        x = self._embed(token)
        for blk, c in zip(self.layers, cache):
            x = blk.decode(x, c, int(pos), window=window, batch=batch)
        return self.logits(self.final_norm(x)), cache
