"""Step builders: the train step (loss, gradient, clip, update), the
prefill step and the serve step.

The port of ``repro.launch.steps``'s step functions for one device. A
``repro`` step is a pure function of (params, opt_state, batch); here the
model and the optimizer hold that state and the step updates them in
place. ``repro``'s optimizer is a stateless (init, update) recipe that
its builder takes; the port's optimizer object carries its recipe and its
state, so the builder takes none and the step takes the optimizer.
``batch_specs``, the sharding functions and ``build_program`` arrive with
the LM mesh.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.arch import ArchConfig
from repro_torch.optim import clip_by_global_norm

from .shapes import InputShape

MOE_AUX_WEIGHT = 0.01


# Modality frontends are stubs, as in ``repro``: a batch carries the
# projected patch embeddings ('modal_embeds', (B, P, D)) or the encoder's
# frame embeddings ('enc_embeds', (B, Sm, D)) directly.

def modal_tokens(cfg: ArchConfig) -> int:
    """P: the embedding rows a vision model's prompt begins with."""
    return cfg.modality_tokens if cfg.modality == "vision" else 0


def encoder_frames(cfg: ArchConfig, shape: InputShape) -> int:
    """Audio encoder length: 1 frame per 4 decoder tokens (codec ratio),
    capped so the bidirectional encoder stays O(seq^2)-sane at 500k."""
    if not cfg.is_encoder_decoder:
        return 0
    return min(shape.seq_len // 4, 8_192)


def text_len(cfg: ArchConfig, shape: InputShape) -> int:
    """Text positions s.t. text + modality prefix == shape.seq_len."""
    return shape.seq_len - modal_tokens(cfg)


def stub_rows(cfg: ArchConfig, seq_len: int) -> dict:
    """{input: rows} of the stub embeddings ``repro``'s serve and train
    entry points draw for ``seq_len``-token prompts: a vision model's
    'modal_embeds' (P rows), an encoder-decoder model's 'enc_embeds'
    (max(seq_len // 4, 8) frames); {} for a text-only model."""
    rows = {"modal_embeds": modal_tokens(cfg),
            "enc_embeds": max(seq_len // 4, 8) if cfg.is_encoder_decoder
            else 0}
    return {k: n for k, n in rows.items() if n}


def make_train_step(cfg: ArchConfig, shape: InputShape, schedule: Callable,
                    grad_clip: float = 1.0, microbatches: int = 1):
    """A step ``(model, optimizer, batch) -> metrics``: the loss and its
    gradient, clipped by global norm, then one optimizer update at
    ``schedule(optimizer.step_count)`` (read before the update increments
    the count, as ``repro`` does).

    ``batch`` holds 'tokens', 'labels' (B, S) and optionally 'mask',
    'modal_embeds' (B, P, D) and 'enc_embeds' (B, Sm, D); the loss drops
    the hidden rows of the P prefix positions.
    ``microbatches > 1`` splits the batch along dim 0 into equal slices
    and runs them one after another, summing their gradients in f32 and
    dividing by the count (``repro``'s ``lax.scan``): the same gradient as
    the full batch for token-mean losses, with a smaller activation peak.
    Metrics are {loss, moe_aux, grad_norm}: tensors on the model's device
    (nothing is read back), and lr, the host's f32.
    """
    window = cfg.window_for(shape.name)
    n_modal = modal_tokens(cfg)

    def loss_fn(model, mb):
        h, aux = model(mb["tokens"], modal_embeds=mb.get("modal_embeds"),
                       enc_embeds=mb.get("enc_embeds"), window=window)
        if n_modal:
            h = h[:, n_modal:, :]
        loss = model.lm_loss(h, mb["labels"], mb.get("mask"))
        return loss + MOE_AUX_WEIGHT * aux, loss, aux

    def train_step(model, optimizer, batch: dict) -> dict:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if microbatches == 1:
            total, loss, aux = loss_fn(model, batch)
            grads = list(torch.autograd.grad(total, params))
            loss, aux = loss.detach(), aux.detach()
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"a batch of {b} does not split into "
                                 f"{microbatches} microbatches")
            size = b // microbatches
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = aux = 0.0
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                total, l, a = loss_fn(model, mb)
                for acc, g in zip(gsum, torch.autograd.grad(total, params)):
                    acc += g.to(torch.float32)
                loss, aux = loss + l.detach(), aux + a.detach()
            grads = [g / microbatches for g in gsum]
            loss, aux = loss / microbatches, aux / microbatches
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = schedule(optimizer.step_count)
        optimizer.step(lr, grads)
        return {"loss": loss, "moe_aux": aux, "grad_norm": gnorm, "lr": lr}

    return train_step


def auto_microbatches(cfg: ArchConfig, shape: InputShape,
                      budget_bytes: float = 2 * 2**30) -> int:
    """Smallest power-of-two microbatch count keeping the residual stack
    the checkpointed blocks keep (n_rep x B x S x d x 2 bytes) under
    ``budget_bytes``: ``repro``'s rule with one data shard."""
    b = max(shape.global_batch, 1)
    stack = cfg.n_rep * b * shape.seq_len * cfg.d_model * 2
    if cfg.is_encoder_decoder:
        stack *= 2  # encoder stack of similar depth
    mb = 1
    while stack / mb > budget_bytes and mb < b and mb < 64:
        mb *= 2
    return mb


def make_prefill_step(cfg: ArchConfig, shape: InputShape):
    """``(model, batch) -> (last-position logits, cache)``."""
    window = cfg.window_for(shape.name)

    def prefill_step(model, batch: dict):
        return model.prefill(batch["tokens"],
                             modal_embeds=batch.get("modal_embeds"),
                             enc_embeds=batch.get("enc_embeds"),
                             window=window)

    return prefill_step


def make_serve_step(cfg: ArchConfig, shape: InputShape):
    """``(model, cache, token, pos) -> (logits, cache)``: one decode step,
    ``pos`` a host int."""
    window = cfg.window_for(shape.name)

    def serve_step(model, cache, token, pos: int):
        return model.decode_step(cache, token, pos, window=window)

    return serve_step
