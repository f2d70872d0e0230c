"""Checkpointing: pytree <-> .npz with a JSON sidecar.

The port of ``repro.checkpoint.ckpt``, reading and writing the same
files: ``step_<step:08d>.npz`` holds ``leaf_<i>`` arrays and a
``__meta__`` uint8 array with the JSON ``{"step", "leaves": [{"key",
"dtype"}], "treedef"}``. Leaves are flattened in ``repro``'s pytree
order — dict keys in sorted order, list and tuple items by
index, NamedTuple fields by name, ``None`` as an empty node — and each
leaf's key is its path joined with ``/``. bf16 leaves are stored as
uint16 views with dtype ``"bfloat16"``. Writes are atomic (a temporary
file, then ``os.replace``), so a save cut short never replaces the
previous snapshot.

Leaves may be numpy arrays, torch tensors or Python scalars.

On a mesh (``shardings``: a tree of the same structure whose leaves are
``models.sharding.Placement``s, or None for a leaf every rank holds
whole), a save gathers each leaf in turn to the full array ``repro``
saves, rank 0 writes and the others wait; a load places each leaf's
local slice, so a run saved on one mesh resumes on another.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(key, child) pairs of an inner node, in flatten order, or None for
    a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, path=()):
    """[(path, leaf)] in ``repro``'s pytree flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, child in kids:
        out.extend(_flatten(child, path + (k,)))
    return out


def _treedef(tree) -> str:
    """The structure as ``repro``'s pytree library prints a treedef
    (without the ``PyTreeDef(...)`` wrapper)."""
    if tree is None:
        return "None"
    kids = _children(tree)
    if kids is None:
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(c)}" for k, c in kids) + "}"
    inner = ", ".join(_treedef(c) for _, c in kids)
    if _is_namedtuple(tree):
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, list):
        return f"[{inner}]"
    return f"({inner},)" if len(kids) == 1 else f"({inner})"


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flatten order."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    rebuilt = [(k, _unflatten(c, leaves)) for k, c in kids]
    if isinstance(tree, dict):
        out = dict(rebuilt)
        return {k: out[k] for k in tree}   # the target's own key order
    vals = [v for _, v in rebuilt]
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    return type(tree)(vals)


def _leaf_key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(stored array, recorded dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _placement(shardings, path):
    """The placement ``shardings`` gives the leaf at ``path`` (None when
    it has none there)."""
    node = shardings
    for k in path:
        if node is None:
            return None
        if _is_namedtuple(node) and isinstance(k, str):
            node = getattr(node, k, None)
        elif isinstance(node, dict):
            node = node.get(k)
        else:
            node = node[k] if k < len(node) else None
    return node


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, tree, *,
                    shardings=None) -> str:
    """Serialize ``tree`` to ``directory/step_<step>.npz`` atomically.
    With ``shardings``, every rank of the mesh calls it: each placed leaf
    is gathered whole, rank 0 writes and the others wait for it."""
    import torch.distributed as dist

    arrays: dict[str, np.ndarray] = {}
    meta = {"step": step, "leaves": [],
            "treedef": f"PyTreeDef({_treedef(tree)})"}
    write = shardings is None or _writer()
    for i, (path, leaf) in enumerate(_flatten(tree)):
        place = None if shardings is None else _placement(shardings, path)
        if place is not None:
            leaf = place.gather(leaf)
        arr, dtype = _to_numpy(leaf) if write else (None, None)
        arrays[f"leaf_{i}"] = arr
        meta["leaves"].append({"key": _leaf_key(path), "dtype": dtype})
    path = os.path.join(directory, f"step_{step:08d}.npz")
    if not write:
        dist.barrier()
        return path
    os.makedirs(directory, exist_ok=True)

    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if shardings is not None and dist.is_initialized():
        dist.barrier()
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)\.npz", f))
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, target_tree, *,
                    to_numpy: bool = False, device=None, shardings=None):
    """Restore into the structure of ``target_tree``.

    Leaves are matched positionally against the target's flatten order
    and checked by key path: a structure mismatch raises ``ValueError``.

    ``to_numpy=True`` returns host numpy leaves exactly as stored (the
    serving plane's float64 accumulators and int64 cursors); numpy has no
    bfloat16, so bf16 leaves come back as CPU bf16 tensors. Otherwise
    every leaf is a tensor on ``device`` (default ``cuda``; raises
    without CUDA unless ``device="cpu"``). ``shardings`` (``repro``'s):
    a placed leaf comes back as this rank's local slice of it, on
    ``device``, cut from the full leaf one leaf at a time.
    """
    from repro_torch._device import resolve_device

    dev = None if to_numpy else resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        target = _flatten(target_tree)
        if len(meta["leaves"]) != len(target):
            raise ValueError(
                f"checkpoint has {len(meta['leaves'])} leaves, "
                f"target has {len(target)}")
        out = []
        for i, (rec, (tpath, _)) in enumerate(zip(meta["leaves"], target)):
            tkey = _leaf_key(tpath)
            if rec["key"] != tkey:
                raise ValueError(
                    f"leaf {i} key mismatch: checkpoint {rec['key']!r} vs "
                    f"target {tkey!r}")
            arr = np.array(z[f"leaf_{i}"])  # npz leaves are lazy: copy out
            place = None if shardings is None else \
                _placement(shardings, tpath)
            if rec["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            elif to_numpy and place is None:
                out.append(arr)
                continue
            else:
                t = torch.from_numpy(arr)
            if dev is not None:
                t = t.to(dev)
            out.append(t if place is None else place.cut(t))
        return _unflatten(target_tree, iter(out))
