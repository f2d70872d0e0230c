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
and ``lower_program`` lower XLA programs, which the port does not have:
:func:`plan_program` returns the decisions ``build_program`` makes (the
batch axes, the window, the microbatches, the parameter layout, the
optimizer's state, the batch and cache leaves) without building
anything, and :func:`inference_layout` is its inference choice of
layout for a model that both prefills and decodes. ``launch.dryrun``
runs a plan on one rank of the production meshes.
"""
from __future__ import annotations

import dataclasses
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
#: ``repro``'s inference budget in bytes (``build_program``'s), for
#: comparisons with ``repro``
REPRO_BUDGET = 12e9


def _inference_choice(cfg: ArchConfig, mesh, dtype: torch.dtype,
                      budget: float | None) -> tuple[bool, bool]:
    """``repro``'s (infer_fsdp, ep2d) of ``build_program``: FSDP over
    ``data`` when the per-rank weights under model-TP exceed ``budget``,
    and the experts 2-D when so and the data axes divide d_ff (a MoE
    model). The budget defaults to ``BUDGET_SHARE`` of the card's memory
    (none on the CPU); ``repro``'s is ``REPRO_BUDGET``."""
    if budget is None:
        if mesh.device_type != "cuda":
            budget = math.inf
        else:
            props = torch.cuda.get_device_properties(torch.cuda.current_device())
            budget = BUDGET_SHARE * props.total_memory
    per_rank = param_bytes(cfg, dtype) / axis_size(mesh, "model")
    fsdp = per_rank > budget
    dshards = axis_size(mesh, "data") * axis_size(mesh, "pod")
    return fsdp, fsdp and cfg.moe_experts > 0 and cfg.d_ff % dshards == 0


def inference_layout(cfg: ArchConfig, mesh, *, dtype: torch.dtype,
                     budget: float | None = None) -> dict:
    """``repro``'s inference choice of parameter layout (``build_program``)
    for a model that prefills and decodes: model-TP alone unless the
    per-rank weights exceed ``budget``, then FSDP over ``data`` too; for
    a MoE model the experts 2-D instead (ep2d: experts over ``model``,
    d_ff over the data axes; its prefill gathers their d_ff blocks, as
    ``repro``'s FSDP prefill program does) and the rest model-TP alone.
    Returns ``Transformer``'s {"fsdp", "ep2d"} (the budget as
    :func:`_inference_choice` takes it)."""
    fsdp, ep2d = _inference_choice(cfg, mesh, dtype, budget)
    return {"fsdp": fsdp and not ep2d, "ep2d": ep2d}


# ---------------------------------------------------------------------------
# Programs: what ``repro``'s build_program decides
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: InputShape,
                act_dtype: torch.dtype = torch.float32) -> dict:
    """The global batch of a train or prefill program as meta tensors
    (``repro``'s ``batch_specs``' ShapeDtypeStructs): 'tokens' (B, S_text)
    and for training 'labels' (B, S_text) in int64, the port's index
    dtype (``repro``: int32), and 'mask' f32; a vision model's
    'modal_embeds' (B, P, D) and an encoder-decoder model's 'enc_embeds'
    (B, frames, D) in ``act_dtype``."""
    b, s = shape.global_batch, text_len(cfg, shape)

    def leaf(*dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    out = {"tokens": leaf(b, s, dtype=torch.int64)}
    if shape.kind == "train":
        out["labels"] = leaf(b, s, dtype=torch.int64)
        out["mask"] = leaf(b, s, dtype=torch.float32)
    if modal_tokens(cfg):
        out["modal_embeds"] = leaf(b, modal_tokens(cfg), cfg.d_model,
                                   dtype=act_dtype)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = leaf(b, encoder_frames(cfg, shape), cfg.d_model,
                                 dtype=act_dtype)
    return out


@dataclasses.dataclass(frozen=True)
class ProgramPlan:
    """One (architecture x input shape) program on a mesh, as ``repro``'s
    ``build_program`` decides it: ``batch_axes`` (``batch_axes_for``),
    ``window``, ``microbatches`` (train; 0 otherwise), ``layout``
    (``Transformer``'s {"fsdp", "ep2d"}), the parameters' and the AdamW
    moments' dtypes (train; the step count is replicated), ``batch`` (the
    global batch leaves, meta tensors; a decode step's 'token' (B, 1)),
    ``cache`` (a decode program's leaves: (layer, name, global shape,
    dtype, ``cache_pspec``)) and ``meta``, ``repro``'s record of it."""
    name: str
    kind: str
    batch_axes: tuple | None
    window: int
    microbatches: int
    layout: dict
    param_dtype: torch.dtype
    moments_dtype: torch.dtype | None
    batch: dict
    cache: tuple
    meta: dict


def cache_leaves(cfg: ArchConfig, shape: InputShape, mesh, batch_axes,
                 dtype: torch.dtype) -> tuple:
    """A decode program's cache (``repro``'s ``cache_spec_tree`` and
    ``cache_shardings``): (layer, leaf, global shape, dtype, spec) of
    ``Transformer.init_cache``'s leaves for the global batch at the
    shape's length and window, with the encoder's memory of an
    encoder-decoder model."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device="meta", dtype=dtype)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             window=cfg.window_for(shape.name),
                             memory_len=encoder_frames(cfg, shape))
    return tuple((i, k, tuple(v.shape), v.dtype,
                  cache_pspec(k, tuple(v.shape), cfg, mesh, batch_axes))
                 for i, c in enumerate(cache) for k, v in c.items())


def plan_program(cfg: ArchConfig, shape: InputShape, mesh, *,
                 param_dtype: torch.dtype = torch.bfloat16,
                 fsdp: bool = True, microbatches: int = 0,
                 budget: float | None = None) -> ProgramPlan:
    """``repro``'s ``build_program`` decisions for ``cfg`` at ``shape`` on
    ``mesh``, nothing built. Train: FSDP over ``data`` when ``fsdp``,
    AdamW with f32 moments beside each parameter, ``microbatches`` (0:
    ``auto_microbatches``). Inference: ``_inference_choice`` at
    ``budget`` (``REPRO_BUDGET`` where the plan is held to ``repro``'s):
    a prefill FSDP'd when the weights are over it, a decode of an
    over-size MoE model with the experts 2-D (ep2d)."""
    batch = batch_axes_for(mesh, shape.global_batch)
    window = cfg.window_for(shape.name)
    meta = {"kind": shape.kind, "batch_axes": batch, "window": window}
    common = dict(name=f"{cfg.name}:{shape.name}", kind=shape.kind,
                  batch_axes=batch, window=window, param_dtype=param_dtype)
    if shape.kind == "train":
        mb = microbatches or auto_microbatches(cfg, shape, mesh)
        return ProgramPlan(**common, microbatches=mb,
                           layout={"fsdp": fsdp, "ep2d": False},
                           moments_dtype=torch.float32,
                           batch=batch_specs(cfg, shape), cache=(),
                           meta={**meta, "microbatches": mb})
    infer_fsdp, ep2d = _inference_choice(cfg, mesh, param_dtype, budget)
    if shape.kind == "prefill":
        return ProgramPlan(**common, microbatches=0,
                           layout={"fsdp": infer_fsdp, "ep2d": False},
                           moments_dtype=None, batch=batch_specs(cfg, shape),
                           cache=(), meta=meta)
    token = torch.empty((shape.global_batch, 1), dtype=torch.int64,
                        device="meta")
    return ProgramPlan(**common, microbatches=0,
                       layout={"fsdp": infer_fsdp and not ep2d,
                               "ep2d": ep2d},
                       moments_dtype=None, batch={"token": token},
                       cache=cache_leaves(cfg, shape, mesh, batch,
                                          param_dtype),
                       meta=meta)
