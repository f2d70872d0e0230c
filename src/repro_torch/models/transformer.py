"""The dense transformer LM: embeddings, the layer stack, prefill and
one-token decode against a KV cache.

The port of the dense path of ``repro.models.transformer``. ``repro``
stacks the layers' params over ``n_rep`` and scans them; here they are an
``nn.ModuleList`` of ``Block``s, one per layer (``interop.lm_params_from_numpy``
unstacks ``repro``'s params). The cache is a list with one
{'k', 'v': (B, Sbuf, Hkv, Dh)} dict per layer; ``decode_step`` updates it
in place. ``repro``'s sharding constraints are no-ops without a mesh and
the port has no mesh, so they are dropped.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device

from . import layers
from .arch import ArchConfig, check_supported

#: logit of a vocab-padding id
VOCAB_PAD_NEG = -1e30


class Block(nn.Module):
    """One dense sublayer: x + attn(norm(x)), then + mlp(norm(x))."""

    def __init__(self, cfg: ArchConfig, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.mixer_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.mixer = layers.Attention(cfg, generator=generator, **kw)
        self.ff_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.ff = layers.MLP(cfg.d_model, cfg.d_ff, generator=generator, **kw)

    def forward(self, x, *, causal: bool, window: int, positions):
        h, kv = self.mixer(self.mixer_norm(x), causal=causal, window=window,
                           positions=positions)
        x = x + h
        return x + self.ff(self.ff_norm(x)), kv

    def decode(self, x, cache: dict, pos: int, *, window: int):
        x = x + self.mixer.decode(self.mixer_norm(x), cache, pos,
                                  window=window)
        return x + self.ff(self.ff_norm(x))


class Transformer(nn.Module):
    """A dense decoder-only LM for ``cfg`` (attention + SwiGLU MLP
    sublayers; other families raise ``NotImplementedError``).

    With a ``generator`` the weights are drawn on ``device`` from
    ``repro``'s distributions (the port of ``init_params``): embed
    N(0, 0.02^2), unembed N(0, 1/d), projections N(0, 1/fan_in), norm
    scales 1. Without one they are left uninitialised for a loader
    (``interop.lm_params_from_numpy``).
    """

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        d, v = cfg.d_model, cfg.padded_vocab
        self.embed = layers.normal_param((v, d), generator=generator,
                                         std=0.02, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, generator=generator, **kw) for _ in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = layers.normal_param((d, v), generator=generator,
                                               std=d ** -0.5, **kw)
        self._causal = [spec.causal for spec in cfg.pattern] * cfg.n_rep

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., D) -> logits (..., padded_vocab), padding ids at
        -1e30 so softmax and argmax never see them."""
        unemb = self.embed.t() if self.unembed is None else self.unembed
        out = hidden @ unemb
        if self.cfg.padded_vocab != self.cfg.vocab:
            out[..., self.cfg.vocab:] = VOCAB_PAD_NEG
        return out

    def init_cache(self, batch: int, max_len: int, *, window: int = 0
                   ) -> list[dict]:
        """Zeroed caches in the model's dtype, one per layer:
        ``min(max_len, window)`` slots with a window, else ``max_len``."""
        sbuf = min(max_len, window) if window else max_len
        cfg = self.cfg
        return [layers.init_kv_cache(batch, sbuf, cfg.n_kv_heads, cfg.hd,
                                     device=self.device, dtype=self.dtype)
                for _ in self.layers]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, window: int = 0,
                max_len: int = 0) -> tuple[torch.Tensor, list[dict]]:
        """Run the prompt tokens (B, S); returns (last-position logits
        (B, 1, V), cache) so that ``decode_step`` continues at position S.

        The cache holds the post-RoPE K/V of the prompt. Without a window
        it has ``max_len`` slots when ``max_len > S`` (the rest zero), else
        S. With a window it has S slots whatever ``max_len`` says, as in
        ``repro`` (its prefill pads only unwindowed caches), and the
        prompt must fit the window.
        """
        b, s = tokens.shape
        if window and s > window:
            raise ValueError(f"windowed prefill of {s} tokens is longer "
                             f"than the window {window}")
        x = self.embed[tokens]
        positions = torch.arange(s, device=x.device)[None, :]
        cache = self.init_cache(b, max_len if max_len > s and not window
                                else s)
        for blk, causal, c in zip(self.layers, self._causal, cache):
            x, (k, v) = blk(x, causal=causal, window=window,
                            positions=positions)
            c["k"][:, :s] = k
            c["v"][:, :s] = v
        x = self.final_norm(x[:, -1:, :])
        return self.logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: list[dict], token: torch.Tensor, pos: int,
                    *, window: int = 0) -> tuple[torch.Tensor, list[dict]]:
        """One serve step: token (B, 1) at absolute position ``pos`` (a host
        int); returns (logits (B, 1, V), cache), the cache updated in
        place."""
        x = self.embed[token]
        for blk, c in zip(self.layers, cache):
            x = blk.decode(x, c, int(pos), window=window)
        return self.logits(self.final_norm(x)), cache
