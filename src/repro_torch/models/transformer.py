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
``decode_step`` updates it in place. ``repro``'s sharding constraints are
no-ops without a mesh and the port has no mesh, so they are dropped.

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

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.kernels.flash_prefill import largest_divisor

from . import layers
from .arch import ArchConfig, LayerSpec

#: logit of a vocab-padding id
VOCAB_PAD_NEG = -1e30


class Block(nn.Module):
    """One sublayer of kind ``spec``: x + mixer(norm(x)) with an attention
    or Mamba2 mixer; with ``spec.cross_attn``, x + cross(cross_norm(x))
    over the encoder's memory (skipped without one); then x + ff(norm(x))
    with an MLP or an MoE, or no feed-forward (and no ``ff_norm``)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, device, dtype,
                 generator=None):
        super().__init__()
        self.spec = spec
        kw = dict(device=device, dtype=dtype)
        self.mixer_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        mixer = layers.Attention if spec.mixer == "attn" else layers.Mamba2
        self.mixer = mixer(cfg, generator=generator, **kw)
        if spec.cross_attn:
            self.cross_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
            self.cross = layers.Attention(cfg, generator=generator, **kw)
        if spec.ff != "none":
            self.ff_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
            self.ff = layers.MoE(cfg, generator=generator, **kw) \
                if spec.ff == "moe" else \
                layers.MLP(cfg.d_model, cfg.d_ff, generator=generator, **kw)

    def feed_forward(self, x):
        """(x + ff(ff_norm(x)), the MoE's aux loss or None)."""
        if self.spec.ff == "none":
            return x, None
        h = self.ff_norm(x)
        if self.spec.ff == "moe":
            out, aux = self.ff(h)
            return x + out, aux
        return x + self.ff(h), None

    def forward(self, x, *, window: int, positions, memory=None):
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
        x = x + h
        if self.spec.cross_attn and memory is not None:
            h, (xk, xv) = self.cross(self.cross_norm(x), memory=memory)
            x = x + h
            cache = {**cache, "xk": xk, "xv": xv}
        x, aux = self.feed_forward(x)
        return x, aux, cache

    def train_forward(self, x, window: int, positions, memory=None):
        """forward without the cache (the function each checkpoint
        reruns; ``memory`` is an input, so its gradient reaches the
        encoder)."""
        return self(x, window=window, positions=positions,
                    memory=memory)[:2]

    def decode(self, x, cache: dict, pos: int, *, window: int):
        h = self.mixer_norm(x)
        if self.spec.mixer == "attn":
            h = self.mixer.decode(h, cache, pos, window=window)
        else:
            h = self.mixer.decode(h, cache)
        x = x + h
        if self.spec.cross_attn and "xk" in cache:
            x = x + self.cross.decode_cross(self.cross_norm(x), cache["xk"],
                                            cache["xv"])
        return self.feed_forward(x)[0]


class Transformer(nn.Module):
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
    """

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        d, v = cfg.d_model, cfg.padded_vocab
        self.embed = layers.normal_param((v, d), generator=generator,
                                         std=0.02, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, spec, generator=generator, **kw)
            for _ in range(cfg.n_rep) for spec in cfg.pattern)
        if cfg.is_encoder_decoder:
            pat = cfg.encoder_pattern
            self.enc_layers = nn.ModuleList(
                Block(cfg, spec, generator=generator, **kw)
                for _ in range(cfg.encoder_layers // len(pat))
                for spec in pat)
            self.enc_norm = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.final_norm = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = layers.normal_param((d, v), generator=generator,
                                               std=d ** -0.5, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def active_param_count(self) -> int:
        """Parameters a token touches: the MoE's top_k of its padded
        routed experts."""
        e, k = self.cfg.padded_experts, self.cfg.moe_top_k
        inactive = sum((e - k) * (w.numel() // e)
                       for blk in self.layers if blk.spec.ff == "moe"
                       for w in (blk.ff.exp_wgate, blk.ff.exp_wi,
                                 blk.ff.exp_w_down))
        return self.param_count() - inactive

    def _unembedding(self) -> torch.Tensor:
        return self.embed.t() if self.unembed is None else self.unembed

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Padding ids' logits at -1e30, out of place (autograd-safe)."""
        if self.cfg.padded_vocab == self.cfg.vocab:
            return logits
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= self.cfg.vocab
        return logits.masked_fill(pad, VOCAB_PAD_NEG)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., D) -> logits (..., padded_vocab), padding ids at
        -1e30 so softmax and argmax never see them."""
        return self._mask_pad_logits(hidden @ self._unembedding())

    def _run(self, blocks, x, window: int, positions, memory=None):
        """``blocks`` over x (the training forward): (x, aux summed over
        the MoE layers), each block checkpointed when autograd records."""
        remat = torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in blocks:
            if remat:
                x, a = checkpoint(blk.train_forward, x, window, positions,
                                  memory, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = blk.train_forward(x, window, positions, memory)
            if a is not None:
                aux = aux + a
        return x, aux

    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder over frame embeddings (B, Sm, D), cast to the
        model's dtype: its blocks (RoPE over ``arange(Sm)``, no window;
        bidirectional where the pattern says so), then ``enc_norm``."""
        x = enc_embeds.to(self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _ = self._run(self.enc_layers, x, 0, positions)
        return self.enc_norm(x)

    def _inputs(self, tokens, modal_embeds, enc_embeds):
        """(x: the modal prefix (cast to the embedding's dtype) before the
        token embeddings, (B, P + S, D); positions ``arange(P + S)``; the
        encoder's memory or None)."""
        x = nn.functional.embedding(tokens, self.embed)
        if modal_embeds is not None:
            x = torch.cat([modal_embeds.to(x.dtype), x], dim=1)
        memory = None
        if self.cfg.is_encoder_decoder:
            if enc_embeds is None:
                raise ValueError(f"{self.cfg.name} is an encoder-decoder "
                                 f"model: pass enc_embeds")
            memory = self.encode(enc_embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return x, positions, memory

    def forward(self, tokens: torch.Tensor, *,
                modal_embeds: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None, window: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward: tokens (B, S), the modality prefix
        ``modal_embeds`` (B, P, D) and the encoder's ``enc_embeds``
        (B, Sm, D) -> (final-normed hidden (B, P + S, D), aux loss f32):
        ``repro``'s MoE load-balance terms summed over the MoE layers, 0
        without one. Each block is checkpointed when autograd records."""
        x, positions, memory = self._inputs(tokens, modal_embeds, enc_embeds)
        x, aux = self._run(self.layers, x, window, positions, memory)
        return self.final_norm(x), aux

    def _chunk_loss(self, h, t, m, unemb):
        """(sum of masked token losses, sum of the mask) of one chunk."""
        logits = self._mask_pad_logits((h @ unemb).to(torch.float32))
        lse = torch.logsumexp(logits, dim=-1)
        correct = logits.gather(-1, t[..., None])[..., 0]
        return ((lse - correct) * m).sum(), m.sum()

    def lm_loss(self, hidden: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor | None = None, chunk: int = 512
                ) -> torch.Tensor:
        """Mean softmax cross-entropy of ``targets`` (B, S) under the
        logits of ``hidden`` (B, S, D), over ``mask`` (default all ones):
        f32 over ``largest_divisor(S, chunk)``-token chunks, each
        checkpointed when autograd records; the masked sum over
        ``max(sum(mask), 1)``."""
        b, s, _ = hidden.shape
        unemb = self._unembedding()
        if mask is None:
            mask = torch.ones((b, s), dtype=torch.float32,
                              device=hidden.device)
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
        return torch.stack(losses).sum() / torch.clamp(
            torch.stack(counts).sum(), min=1.0)

    def init_cache(self, batch: int, max_len: int, *, window: int = 0,
                   memory_len: int = 0) -> list[dict]:
        """Zeroed caches, one per layer: attention's in the model's dtype
        with ``min(max_len, window)`` slots with a window, else
        ``max_len``; Mamba2's conv tail in the model's dtype and its state
        in f32; with ``memory_len``, a cross-attending layer's 'xk'/'xv'
        (B, memory_len, Hkv, Dh) in the model's dtype."""
        sbuf = min(max_len, window) if window else max_len
        cfg, kw = self.cfg, dict(device=self.device, dtype=self.dtype)
        caches = []
        for blk in self.layers:
            c = layers.init_kv_cache(batch, sbuf, cfg.n_kv_heads, cfg.hd,
                                     **kw) if blk.spec.mixer == "attn" \
                else layers.init_mamba_cache(batch, cfg, **kw)
            if blk.spec.cross_attn and memory_len:
                x = layers.init_kv_cache(batch, memory_len, cfg.n_kv_heads,
                                         cfg.hd, **kw)
                c.update(xk=x["k"], xv=x["v"])
            caches.append(c)
        return caches

    @torch.no_grad()
    def prefill_cross_cache(self, cache: list[dict], memory: torch.Tensor
                            ) -> list[dict]:
        """Write each cross-attending layer's K/V of the encoder's
        ``memory`` (B, Sm, D) into ``cache``'s 'xk'/'xv' (from
        ``init_cache(memory_len=Sm)``), cast to their dtype, in place
        (``repro``'s ``prefill_cross_cache``); returns ``cache``."""
        b, sm, _ = memory.shape
        hkv, hd = self.cfg.n_kv_heads, self.cfg.hd
        for blk, c in zip(self.layers, cache):
            if blk.spec.cross_attn:
                for name, w in (("xk", blk.cross.wk), ("xv", blk.cross.wv)):
                    c[name].copy_((memory @ w).view(b, sm, hkv, hd))
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
        """
        x, positions, memory = self._inputs(tokens, modal_embeds, enc_embeds)
        b, s = x.shape[:2]
        if window and s > window:
            raise ValueError(f"windowed prefill of {s} positions is longer "
                             f"than the window {window}")
        sbuf = max_len if max_len > s and not window else s
        cache = []
        for blk in self.layers:
            x, _, c = blk(x, window=window, positions=positions,
                          memory=memory)
            if blk.spec.mixer == "attn":
                kv = layers.init_kv_cache(b, sbuf, self.cfg.n_kv_heads,
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
        drop their aux loss, as ``repro`` does."""
        x = self.embed[token]
        for blk, c in zip(self.layers, cache):
            x = blk.decode(x, c, int(pos), window=window)
        return self.logits(self.final_norm(x)), cache
