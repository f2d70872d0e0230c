"""The port's checkpoint codec: exact round trips, atomicity, key checks,
and file compatibility with ``repro.checkpoint`` in both directions."""
import collections
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)

Pair = collections.namedtuple("Pair", "mu nu")


def _tree():
    """Nested dicts of f64/int64/bool/bf16 leaves, numpy and tensors."""
    return {
        "table": {
            "gram": np.arange(8, dtype=np.float64).reshape(2, 2, 2) + 2.0 ** 53,
            "adj": np.eye(3, dtype=bool),
        },
        "cursors": np.asarray([[2 ** 40 + 1, 3]], np.int64),
        "bf": torch.full((2, 3), 1.5, dtype=torch.bfloat16),
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "tick": np.asarray(7, np.int64),
    }


def _eq(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("to_numpy", [True, False])
def test_roundtrip_exact(tmp_path, to_numpy):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    back = load_checkpoint(str(tmp_path), 5, t, to_numpy=to_numpy,
                           device="cpu")
    assert list(back) == list(t) and list(back["table"]) == list(t["table"])
    for a, b in zip(_leaves(t), _leaves(back)):
        if to_numpy and isinstance(a, torch.Tensor) and \
                a.dtype != torch.bfloat16:
            assert isinstance(b, np.ndarray)
            a = a.numpy()
        elif not to_numpy:
            assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
            a = torch.as_tensor(a)
        assert _eq(a, b)


def test_sequences_and_namedtuples_roundtrip(tmp_path):
    t = {"opt": Pair(mu=[np.ones(2), np.zeros(3)], nu=(np.int32(4),)),
         "none": None, "step": 3}
    save_checkpoint(str(tmp_path), 1, t)
    back = load_checkpoint(str(tmp_path), 1, t, to_numpy=True)
    assert isinstance(back["opt"], Pair) and back["none"] is None
    assert isinstance(back["opt"].mu, list) and isinstance(back["opt"].nu,
                                                           tuple)
    assert _eq(back["opt"].mu[1], np.zeros(3)) and int(back["step"]) == 3


def test_latest_step_and_no_tmp(tmp_path):
    assert latest_step(str(tmp_path)) is None
    for step in (1, 30, 7):
        save_checkpoint(str(tmp_path), step, _tree())
    assert latest_step(str(tmp_path)) == 30
    assert all(not f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_interrupted_save_keeps_previous_snapshot(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    (tmp_path / "tmpabc123.tmp").write_bytes(b"\x00" * 100)  # torn write
    assert latest_step(str(tmp_path)) == 3
    back = load_checkpoint(str(tmp_path), 3, t, to_numpy=True)
    assert _eq(back["cursors"], t["cursors"])


@pytest.mark.parametrize("change", ["extra", "renamed"])
def test_structure_mismatch_raises(tmp_path, change):
    t = _tree()
    save_checkpoint(str(tmp_path), 2, t)
    wrong = dict(t)
    if change == "extra":
        wrong["extra"] = np.zeros(2)
    else:
        wrong["zick"] = wrong.pop("tick")
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), 2, wrong, to_numpy=True)


def test_tensor_leaves_default_to_cuda(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 1, _tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(str(tmp_path), 1, _tree())


def _jax_tree():
    return {
        "table": {"gram": np.arange(8, dtype=np.float64).reshape(2, 2, 2),
                  "adj": np.eye(3, dtype=bool)},
        "cursors": np.asarray([[2 ** 40 + 1, 3]], np.int64),
        "bf": jnp.ones((2, 3), jnp.bfloat16) * 1.5,
        "opt": Pair(mu=[np.ones(2)], nu=(np.int32(4), np.float32(2.5))),
        "tick": np.asarray(7, np.int64),
    }


def _meta(path):
    import json

    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def test_reads_repro_checkpoint(tmp_path):
    t = _jax_tree()
    path = j_save(str(tmp_path), 4, t)
    back = load_checkpoint(str(tmp_path), 4, t, to_numpy=True)
    flat_t = jax.tree_util.tree_leaves(t)
    flat_b = [back["bf"], back["cursors"], back["opt"].mu[0],
              *back["opt"].nu, back["table"]["adj"], back["table"]["gram"],
              back["tick"]]
    assert len(flat_b) == len(flat_t)
    for a, b in zip(flat_t, flat_b):
        if isinstance(b, torch.Tensor):           # bf16
            assert b.dtype == torch.bfloat16
            assert np.array_equal(b.float().numpy(),
                                  np.asarray(a, np.float32))
        else:
            assert _eq(np.asarray(a), b)
    # the port writes the same leaf keys, dtypes and treedef text
    mine = save_checkpoint(str(tmp_path / "port"), 4, back)
    assert _meta(mine) == _meta(path)


def test_repro_reads_port_checkpoint(tmp_path):
    t = _jax_tree()
    port_tree = dict(t, bf=torch.full((2, 3), 1.5, dtype=torch.bfloat16))
    save_checkpoint(str(tmp_path), 6, port_tree)
    back = j_load(str(tmp_path), 6, t, to_numpy=True)
    for a, b in zip(jax.tree_util.tree_leaves(t),
                    jax.tree_util.tree_leaves(back)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
