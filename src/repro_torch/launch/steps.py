"""Step builders: the train step (loss, gradient, clip, update), the
prefill step and the serve step, and the layouts a mesh gives the
parameters, the batch and the cache.

The port of ``repro.launch.steps``. A ``repro`` step is a pure function
of (params, opt_state, batch); here the model and the optimizer hold
that state and the step updates them in place. ``repro``'s optimizer is
a stateless (init, update) recipe that ``make_train_step`` takes; the
port's optimizer object carries its recipe and its state, so
``make_train_step`` takes none and the step takes the optimizer.

On a mesh (a model built with one) the step runs on the rank's shard of
the batch: the loss is the rank's masked sum over the global count, the
gradients of FSDP'd weights come reduce-scattered over ``data`` out of
the backward, the others are summed over ``data`` (and ``pod``), and
the global norm counts each element once. ``repro``'s ``build_program``
and ``lower_program`` lower XLA programs, which the port does not have;
:func:`inference_layout` is their inference choice of layout.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.models.arch import ArchConfig
from repro_torch.models.sharding import (  # noqa: F401  (repro's names)
    axis_size, batch_axes_for, cache_pspec)
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
        if model.shard is not None:
            return _sharded_step(model, optimizer, batch)
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

    def _sharded_step(model, optimizer, batch: dict) -> dict:
        sh = model.shard
        params = [p for g in optimizer.param_groups for p in g["params"]]
        names = {id(p): n for n, p in model.named_parameters()}
        lays = model.param_layouts()
        layouts = [lays[names[id(p)]] for p in params]
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"a batch of {b} does not split into "
                             f"{microbatches} microbatches")
        size = b // microbatches
        # each microbatch is global rows [i * size, (i + 1) * size), of
        # which the model runs its own (``Transformer.batch_shard``); rows
        # that several ranks run (a batch the data axes do not divide)
        # count once over them
        rows = model.batch_shard(size)
        axes, w = rows.axes, 1.0 / rows.replicas
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss = aux = 0.0
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            h, a = model(mb["tokens"], modal_embeds=mb.get("modal_embeds"),
                         enc_embeds=mb.get("enc_embeds"), window=window)
            if n_modal:
                h = h[:, n_modal:, :]
            ce = model.lm_loss(h, mb["labels"], mb.get("mask"))
            for acc, g in zip(gsum, torch.autograd.grad(
                    w * (ce + MOE_AUX_WEIGHT * a), params)):
                acc += g.to(torch.float32)
            loss = loss + sh.batch_sum(ce.detach(), axes)
            aux = aux + a.detach()
        grads = []
        for g, p, lay in zip(gsum, params, layouts):
            if lay is None or lay.ddim is None:
                g = sh.batch_sum(g, sh.batch_axes)
            elif sh.psize > 1:
                g = sh.reduce(g, sh.pgroup)
            grads.append((g / microbatches).to(p.dtype))
        loss, aux = loss / microbatches, aux / microbatches
        grads, gnorm = clip_by_global_norm(
            grads, grad_clip, weights=[sh.replication(l) for l in layouts],
            reduce=sh.world_sum)
        lr = schedule(optimizer.step_count)
        optimizer.step(lr, grads)
        return {"loss": loss, "moe_aux": aux, "grad_norm": gnorm, "lr": lr}

    return train_step


def auto_microbatches(cfg: ArchConfig, shape: InputShape, mesh=None,
                      budget_bytes: float = 2 * 2**30) -> int:
    """Smallest power-of-two microbatch count keeping the per-rank
    residual stack the checkpointed blocks keep (n_rep x B_loc x S x d x
    2 bytes) under ``budget_bytes``, B_loc the global batch over the
    mesh's (pod, data) shards (``repro``'s rule; one shard without a
    mesh)."""
    dshard = 1 if mesh is None else \
        axis_size(mesh, "pod") * axis_size(mesh, "data")
    b = max(shape.global_batch // dshard, 1)
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


# ---------------------------------------------------------------------------
# Layouts on a mesh
# ---------------------------------------------------------------------------

def param_bytes(cfg: ArchConfig, dtype: torch.dtype) -> int:
    """Bytes of ``cfg``'s parameters in ``dtype`` (the router and the SSM
    constants in f32), from a model on the meta device."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device="meta", dtype=dtype)
    return sum(p.numel() * p.element_size() for p in model.parameters())


#: ``repro``'s inference budget, 12e9 bytes of a TPU v5e's 16 GiB, as a
#: share of the card's memory
BUDGET_SHARE = 12e9 / 16e9


def inference_layout(cfg: ArchConfig, mesh, *, dtype: torch.dtype,
                     budget: float | None = None) -> dict:
    """``repro``'s inference choice of parameter layout (``build_program``)
    for a model that prefills and decodes: model-TP alone unless the
    per-rank weights exceed ``budget``, then FSDP over ``data`` too; for
    a MoE model the experts 2-D instead (ep2d: experts over ``model``,
    d_ff over the data axes; its prefill gathers their d_ff blocks, as
    ``repro``'s FSDP prefill program does) and the rest model-TP alone.
    Returns ``Transformer``'s {"fsdp", "ep2d"}. The budget defaults to
    ``BUDGET_SHARE`` of the card's memory (none on the CPU); ``repro``'s
    is 12e9."""
    if budget is None:
        if mesh.device_type != "cuda":
            budget = math.inf
        else:
            props = torch.cuda.get_device_properties(torch.cuda.current_device())
            budget = BUDGET_SHARE * props.total_memory
    per_rank = param_bytes(cfg, dtype) / axis_size(mesh, "model")
    fsdp = per_rank > budget
    dshards = axis_size(mesh, "data") * axis_size(mesh, "pod")
    ep2d = fsdp and cfg.moe_experts > 0 and cfg.d_ff % dshards == 0
    return {"fsdp": fsdp and not ep2d, "ep2d": ep2d}
