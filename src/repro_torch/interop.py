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
    TPU tile edges are dropped; ``autotune`` carries across (the port keeps
    its own cache of winners)."""
    fields = dict(fields)
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


#: (port module path within a layer, ``repro`` path within a sublayer)
_LAYER_LEAVES = (("mixer_norm.scale", ("mixer_norm", "scale")),
                 ("ff_norm.scale", ("ff_norm", "scale")),
                 *((f"mixer.{n}", ("mixer", n)) for n in ("wq", "wk", "wv",
                                                          "wo")),
                 *((f"ff.{n}", ("ff", n)) for n in ("wgate", "wi",
                                                    "w_down")))


def _host_array(a) -> np.ndarray:
    """``a`` as numpy; numpy's bf16 extension type widens to f32 (exact),
    which torch can read."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _named_from_tree(cfg, tree: dict) -> dict:
    """{port parameter name: array} from a tree in ``repro``'s params
    layout (the blocks stacked over ``n_rep``)."""
    out = {"embed": _host_array(tree["embed"]),
           "final_norm.scale": _host_array(tree["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        out["unembed"] = _host_array(tree["unembed"])
    for i, (key, rep) in enumerate(_layer_index(cfg)):
        for name, (mod, leaf) in _LAYER_LEAVES:
            out[f"layers.{i}.{name}"] = _host_array(
                tree["blocks"][key][mod][leaf])[rep]
    return out


def lm_tree_from_named(cfg, named: dict) -> dict:
    """{port parameter name: tensor} (parameters, gradients or moments)
    in ``repro``'s params layout as numpy, the layers stacked over
    ``n_rep`` again; bf16 comes back as f32 (exactly)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = {"embed": host(named["embed"]),
            "final_norm": {"scale": host(named["final_norm.scale"])},
            "blocks": {}}
    if not cfg.tie_embeddings:
        tree["unembed"] = host(named["unembed"])
    for key in dict(_layer_index(cfg)):
        layers = [i for i, (k, _) in enumerate(_layer_index(cfg)) if k == key]
        blk: dict = {}
        for name, (mod, leaf) in _LAYER_LEAVES:
            blk.setdefault(mod, {})[leaf] = np.stack(
                [host(named[f"layers.{i}.{name}"]) for i in layers])
        tree["blocks"][key] = blk
    return tree


def lm_params_from_numpy(cfg, tree: dict, *, device=None,
                         dtype: torch.dtype = torch.float32):
    """A loaded ``Transformer`` from ``repro``'s params pytree as numpy.

    ``tree`` holds ``embed`` (V, D), ``unembed`` (D, V) unless embeddings
    are tied, ``final_norm.scale`` and ``blocks.l<i>.{mixer_norm.scale,
    mixer.{wq,wk,wv,wo}, ff_norm.scale, ff.{wgate,wi,w_down}}`` with a
    leading ``n_rep`` axis, which is unstacked into the port's one module
    per layer. The parameters come back frozen, as ``Transformer`` makes
    them.
    """
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device=device, dtype=dtype)
    arrays = _named_from_tree(cfg, tree)
    with torch.no_grad():
        for name, param in model.named_parameters():
            a = np.asarray(arrays[name])
            if tuple(param.shape) != a.shape:
                raise ValueError(f"{name}: shape {a.shape} does not fit the "
                                 f"port's {tuple(param.shape)}")
            param.copy_(torch.tensor(a, device=model.device, dtype=dtype))
    return model


def lm_params_to_numpy(model) -> dict:
    """``model``'s parameters in ``repro``'s params layout, as numpy."""
    return lm_tree_from_named(model.cfg, dict(model.named_parameters()))


def opt_state_from_numpy(cfg, model, optimizer, tree: dict) -> None:
    """Load ``repro``'s ``OptState`` (``opt_state._asdict()`` as numpy:
    {"step", "moments": {name: a params-layout tree}}) into the port's
    ``optimizer`` over ``model``'s parameters, in place."""
    named = list(model.named_parameters())
    optimizer.load_state_tree(named, {
        "step": tree["step"],
        "moments": {m: _named_from_tree(cfg, tree["moments"][m])
                    for m in optimizer.moment_names}})


def opt_state_to_numpy(cfg, model, optimizer) -> dict:
    """The port's optimizer state in ``repro``'s ``OptState`` layout."""
    st = optimizer.state_tree(list(model.named_parameters()))
    return {"step": np.int32(st["step"]),
            "moments": {m: lm_tree_from_named(cfg, named)
                        for m, named in st["moments"].items()}}


def kv_cache_from_numpy(cfg, tree: dict, *, device=None,
                        dtype: torch.dtype | None = None) -> list[dict]:
    """The port's per-layer cache from the one ``repro``'s ``prefill`` /
    ``init_cache`` return: {'l<i>': {'k', 'v': (n_rep, B, S, Hkv, Dh)}}."""
    dev = resolve_device(device)
    return [{n: torch.tensor(np.asarray(tree[key][n])[rep], device=dev,
                             dtype=dtype)
             for n in ("k", "v")}
            for key, rep in _layer_index(cfg)]
