"""Carry ``repro``'s state into the port as plain data.

``repro`` is never imported here: its plan values arrive as the dicts of
``dataclasses.asdict`` and its arrays (LM params and caches included) as
numpy. Tests use these to feed both packages the same problem.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.comm.channel import GATHER, BudgetChannel, MACChannel
from repro_torch.core.gram import GramConfig, GramEngine
from repro_torch.core.strategy import Strategy

#: ``repro``'s Gram backend names -> the port's
_BACKENDS = {"auto": "auto", "pallas": "kernel", "xla": "torch",
             "numpy": "numpy"}
#: ``repro`` GramEngine fields that are TPU tile edges or switches with no
#: counterpart here: the port's kernels pick their own tiles
_TPU_FIELDS = ("interpret", "block_n", "block_d", "block_b")


def _channel_from_fields(fields) -> object:
    """A channel from ``asdict`` of a ``repro`` channel. ``kind`` is a
    class attribute, so ``asdict`` leaves it out: the gather channel has
    no fields, a budget channel has ``budget_bits`` (and ``machines``),
    a MAC channel ``machines`` alone."""
    fields = dict(fields or {})
    fields.pop("kind", None)
    if not fields:
        return GATHER
    if "budget_bits" in fields:
        return BudgetChannel(**fields)
    return MACChannel(**fields)


def strategy_from_fields(fields: dict) -> Strategy:
    """The port's Strategy from ``dataclasses.asdict(repro Strategy)``,
    nested channel included."""
    fields = dict(fields)
    channel = _channel_from_fields(fields.pop("channel", None))
    return Strategy(**fields, channel=channel)


def engine_from_fields(fields: dict, *, device=None):
    """The port's GramEngine (or GramConfig) from ``asdict`` of a ``repro``
    GramEngine / GramConfig. Backends map pallas -> kernel, xla -> torch;
    TPU tile edges are dropped; autotune is not ported yet."""
    fields = dict(fields)
    if fields.pop("autotune", False):
        raise NotImplementedError("the Gram autotune cache is not ported yet")
    for k in _TPU_FIELDS:
        fields.pop(k, None)
    if "backend" not in fields:
        return GramConfig(**fields)
    backend = _BACKENDS[fields.pop("backend")]
    return GramEngine(backend=backend, device=device, **fields)


def tensors_from_numpy(mapping: dict, device=None) -> dict:
    """{name: numpy array} -> {name: tensor on ``device``} with dtypes and
    layouts kept (int8 sample-major codes stay (n, d) int8, uint8
    feature-major packed bytes stay (d, nb) uint8, f32 stays f32)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in mapping.items()}



def arch_from_fields(fields: dict):
    """The port's ArchConfig from ``dataclasses.asdict`` of a ``repro``
    ArchConfig (the nested LayerSpecs arrive as dicts)."""
    from repro_torch.models.arch import ArchConfig, LayerSpec

    fields = dict(fields)
    for key in ("pattern", "encoder_pattern"):
        fields[key] = tuple(LayerSpec(**spec) for spec in fields[key])
    return ArchConfig(**fields)


def _layer_index(cfg) -> list[tuple[str, int]]:
    """(pattern key, superblock) of every layer, in stack order."""
    return [(f"l{i}", rep) for rep in range(cfg.n_rep)
            for i in range(len(cfg.pattern))]


def lm_params_from_numpy(cfg, tree: dict, *, device=None,
                         dtype: torch.dtype = torch.float32):
    """A loaded ``Transformer`` from ``repro``'s params pytree as numpy.

    ``tree`` holds ``embed`` (V, D), ``unembed`` (D, V) unless embeddings
    are tied, ``final_norm.scale`` and ``blocks.l<i>.{mixer_norm.scale,
    mixer.{wq,wk,wv,wo}, ff_norm.scale, ff.{wgate,wi,w_down}}`` with a
    leading ``n_rep`` axis, which is unstacked into the port's one module
    per layer.
    """
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device=device, dtype=dtype)
    dev = model.device

    def put(param, a):
        a = np.asarray(a)
        if tuple(param.shape) != a.shape:
            raise ValueError(f"shape {a.shape} does not fit the port's "
                             f"{tuple(param.shape)}")
        param.copy_(torch.tensor(a, device=dev, dtype=dtype))

    with torch.no_grad():
        put(model.embed, tree["embed"])
        if model.unembed is not None:
            put(model.unembed, tree["unembed"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        for blk, (key, rep) in zip(model.layers, _layer_index(cfg)):
            p = tree["blocks"][key]
            put(blk.mixer_norm.scale, p["mixer_norm"]["scale"][rep])
            put(blk.ff_norm.scale, p["ff_norm"]["scale"][rep])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(blk.mixer, name), p["mixer"][name][rep])
            for name in ("wgate", "wi", "w_down"):
                put(getattr(blk.ff, name), p["ff"][name][rep])
    return model


def kv_cache_from_numpy(cfg, tree: dict, *, device=None,
                        dtype: torch.dtype | None = None) -> list[dict]:
    """The port's per-layer cache from the one ``repro``'s ``prefill`` /
    ``init_cache`` return: {'l<i>': {'k', 'v': (n_rep, B, S, Hkv, Dh)}}."""
    dev = resolve_device(device)
    return [{n: torch.tensor(np.asarray(tree[key][n])[rep], device=dev,
                             dtype=dtype)
             for n in ("k", "v")}
            for key, rep in _layer_index(cfg)]
