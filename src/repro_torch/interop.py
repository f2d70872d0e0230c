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


def _layer_index(cfg, pattern=None, n_rep=None) -> list[tuple[str, int]]:
    """(pattern key, superblock) of every layer of a stack, in stack order
    (default: the decoder's)."""
    pattern = cfg.pattern if pattern is None else pattern
    n_rep = cfg.n_rep if n_rep is None else n_rep
    return [(f"l{i}", rep) for rep in range(n_rep)
            for i in range(len(pattern))]


def _stacks(cfg) -> list[tuple[str, str, tuple, int]]:
    """(``repro``'s params key, the port's module list, pattern, n_rep) of
    each layer stack: the decoder's, and an encoder-decoder model's
    encoder."""
    out = [("blocks", "layers", cfg.pattern, cfg.n_rep)]
    if cfg.is_encoder_decoder:
        pat = cfg.encoder_pattern
        out.append(("enc_blocks", "enc_layers", pat,
                    cfg.encoder_layers // len(pat)))
    return out


_MIXER_LEAVES = {"attn": ("wq", "wk", "wv", "wo"),
                 "mamba": ("in_proj", "conv_w", "conv_b", "a_log",
                           "dt_bias", "ssm_d", "out_proj", "norm_scale")}
_FF_LEAVES = {"mlp": ("wgate", "wi", "w_down"),
              "moe": ("router", "exp_wgate", "exp_wi", "exp_w_down"),
              "none": ()}


def _layer_leaves(cfg, spec) -> list[tuple[str, tuple[str, ...]]]:
    """(port parameter path within a layer, ``repro`` key path within a
    sublayer) of every leaf of a sublayer of kind ``spec``."""
    out = [("mixer_norm.scale", ("mixer_norm", "scale"))]
    out += [(f"mixer.{n}", ("mixer", n)) for n in _MIXER_LEAVES[spec.mixer]]
    if spec.cross_attn:
        out.append(("cross_norm.scale", ("cross_norm", "scale")))
        out += [(f"cross.{n}", ("cross", n)) for n in _MIXER_LEAVES["attn"]]
    if spec.ff != "none":
        out.append(("ff_norm.scale", ("ff_norm", "scale")))
    out += [(f"ff.{n}", ("ff", n)) for n in _FF_LEAVES[spec.ff]]
    if spec.ff == "moe" and cfg.moe_shared_ff:
        out += [(f"ff.shared.{n}", ("ff", "shared", n))
                for n in _FF_LEAVES["mlp"]]
    return out


def _get(tree: dict, path: tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _host_array(a) -> np.ndarray:
    """``a`` as numpy; numpy's bf16 extension type widens to f32 (exact),
    which torch can read."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 widens to f32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _named_from_tree(cfg, tree: dict) -> dict:
    """{port parameter name: array} from a tree in ``repro``'s params
    layout (the blocks, and an encoder's ``enc_blocks``, stacked over
    their ``n_rep``)."""
    out = {"embed": _host_array(tree["embed"]),
           "final_norm.scale": _host_array(tree["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        out["unembed"] = _host_array(tree["unembed"])
    if cfg.is_encoder_decoder:
        out["enc_norm.scale"] = _host_array(tree["enc_norm"]["scale"])
    for key_j, mods, pattern, n_rep in _stacks(cfg):
        for i, (key, rep) in enumerate(_layer_index(cfg, pattern, n_rep)):
            for name, path in _layer_leaves(cfg, pattern[int(key[1:])]):
                out[f"{mods}.{i}.{name}"] = _host_array(
                    _get(tree[key_j][key], path))[rep]
    return out


def lm_tree_from_named(cfg, named: dict) -> dict:
    """{port parameter name: tensor} (parameters, gradients or moments)
    in ``repro``'s params layout as numpy, the layers stacked over
    ``n_rep`` again; bf16 comes back as f32 (exactly)."""
    tree = {"embed": _host_numpy(named["embed"]),
            "final_norm": {"scale": _host_numpy(named["final_norm.scale"])}}
    if not cfg.tie_embeddings:
        tree["unembed"] = _host_numpy(named["unembed"])
    if cfg.is_encoder_decoder:
        tree["enc_norm"] = {"scale": _host_numpy(named["enc_norm.scale"])}
    for key_j, mods, pattern, n_rep in _stacks(cfg):
        index = _layer_index(cfg, pattern, n_rep)
        tree[key_j] = {}
        for key in dict(index):
            layers = [i for i, (k, _) in enumerate(index) if k == key]
            blk: dict = {}
            for name, path in _layer_leaves(cfg, pattern[int(key[1:])]):
                node = blk
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = np.stack(
                    [_host_numpy(named[f"{mods}.{i}.{name}"])
                     for i in layers])
            tree[key_j][key] = blk
    return tree


def lm_params_from_numpy(cfg, tree: dict, *, device=None,
                         dtype: torch.dtype = torch.float32, mesh=None,
                         fsdp: bool = False, ep2d: bool = False):
    """A loaded ``Transformer`` from ``repro``'s params pytree as numpy.

    ``tree`` holds ``embed`` (V, D), ``unembed`` (D, V) unless embeddings
    are tied, ``final_norm.scale`` and, per sublayer ``blocks.l<i>`` with
    a leading ``n_rep`` axis (unstacked into the port's one module per
    layer), ``mixer_norm.scale``, the mixer's leaves (attention
    ``{wq,wk,wv,wo}``; Mamba2 ``{in_proj, conv_w, conv_b, a_log,
    dt_bias, ssm_d, out_proj, norm_scale}``), with cross-attention
    ``cross_norm.scale`` and ``cross.{wq,wk,wv,wo}``, and unless it has no
    feed-forward ``ff_norm.scale`` and the feed-forward's (MLP
    ``{wgate,wi,w_down}``; MoE ``{router, exp_wgate, exp_wi, exp_w_down}``
    and ``shared.{wgate,wi,w_down}``). An encoder-decoder model's tree
    also holds ``enc_blocks`` (the same, stacked over the encoder's
    ``n_rep``; into ``enc_layers``) and ``enc_norm.scale``. Each leaf is copied in its
    parameter's dtype: ``dtype``, but f32 for the router, ``a_log``,
    ``dt_bias`` and ``ssm_d``. The parameters come back frozen, as
    ``Transformer`` makes them. With a ``mesh`` (and ``fsdp`` /
    ``ep2d``, as ``Transformer`` takes them) each rank keeps its slices
    of the full leaves.
    """
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device=device, dtype=dtype, mesh=mesh,
                        fsdp=fsdp, ep2d=ep2d)
    arrays = _named_from_tree(cfg, tree)
    lays = model.param_layouts()
    with torch.no_grad():
        for name, param in model.named_parameters():
            a = np.asarray(arrays[name])
            lay = lays[name]
            full = tuple(param.shape) if lay is None else lay.shape
            if full != a.shape:
                raise ValueError(f"{name}: shape {a.shape} does not fit the "
                                 f"port's {full}")
            t = torch.tensor(a).to(device=param.device, dtype=param.dtype)
            param.copy_(t if lay is None else model.shard.cut(t, lay))
    return model


def lm_params_to_numpy(model) -> dict:
    """``model``'s parameters in ``repro``'s params layout, as numpy (on a
    mesh the full leaves, gathered: every rank calls it)."""
    return lm_tree_from_named(
        model.cfg, model.full_named(dict(model.named_parameters())))


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
    ``init_cache`` return: {'l<i>': {'k', 'v': (n_rep, B, S, Hkv, Dh)}}
    for attention, {'l<i>': {'conv': (n_rep, B, W - 1, C), 'ssm':
    (n_rep, B, H, P, N)}} for Mamba2, and for a cross-attending sublayer
    'l<i>_xk' / 'l<i>_xv' (n_rep, B, Sm, Hkv, Dh), which become that
    layer's 'xk' / 'xv'. ``dtype`` (default: numpy's) is the K/V's and the
    conv tail's; the SSM state stays f32."""
    dev = resolve_device(device)

    def entry(name, a):
        a = _host_array(a)
        dt = torch.float32 if name == "ssm" else dtype
        return torch.tensor(a).to(device=dev, dtype=dt)

    cache = []
    for key, rep in _layer_index(cfg):
        c = {n: entry(n, a[rep]) for n, a in tree[key].items()}
        for n in ("xk", "xv"):
            if f"{key}_{n}" in tree:
                c[n] = entry(n, tree[f"{key}_{n}"][rep])
        cache.append(c)
    return cache


def kv_cache_to_numpy(cfg, cache: list[dict]) -> dict:
    """The port's per-layer cache in ``repro``'s layout, stacked over
    ``n_rep`` again, as numpy (bf16 comes back as f32, exactly)."""
    tree: dict = {}
    index = _layer_index(cfg)
    for key in dict(index):
        layers = [i for i, (k, _) in enumerate(index) if k == key]
        entries = {n: np.stack([_host_numpy(cache[i][n]) for i in layers])
                   for n in cache[layers[0]]}
        for n in ("xk", "xv"):
            if n in entries:
                tree[f"{key}_{n}"] = entries.pop(n)
        tree[key] = entries
    return tree
