"""The dense transformer LM: embeddings, the layer stack, the training
forward and loss, prefill and one-token decode against a KV cache.

The port of the dense path of ``repro.models.transformer``. ``repro``
stacks the layers' params over ``n_rep`` and scans them; here they are an
``nn.ModuleList`` of ``Block``s, one per layer (``interop.lm_params_from_numpy``
unstacks ``repro``'s params). The cache is a list with one
{'k', 'v': (B, Sbuf, Hkv, Dh)} dict per layer; ``decode_step`` updates it
in place. ``repro``'s sharding constraints are no-ops without a mesh and
the port has no mesh, so they are dropped.

Training (``forward`` + ``lm_loss``) rematerialises as ``repro`` does:
each block runs under ``torch.utils.checkpoint`` (``repro`` checkpoints
its scan body), and each 512-token chunk of the loss too, so the (B, S, V)
f32 logits never exist at once.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.kernels.flash_prefill import largest_divisor

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

    def train_forward(self, x, causal: bool, window: int, positions):
        """forward without the K/V (the function each checkpoint reruns)."""
        return self(x, causal=causal, window=window, positions=positions)[0]

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

    def forward(self, tokens: torch.Tensor, *, window: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward: tokens (B, S) -> (final-normed hidden
        (B, S, D), aux loss). Each block is checkpointed when autograd
        records; ``aux`` is ``repro``'s MoE load-balance term, 0 for the
        dense stacks the port runs."""
        s = tokens.shape[1]
        x = nn.functional.embedding(tokens, self.embed)
        positions = torch.arange(s, device=x.device)[None, :]
        remat = torch.is_grad_enabled()
        for blk, causal in zip(self.layers, self._causal):
            if remat:
                x = checkpoint(blk.train_forward, x, causal, window,
                               positions, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk.train_forward(x, causal, window, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
