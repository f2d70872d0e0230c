"""Carry ``repro``'s state into the port as plain data.

``repro`` is never imported here: its plan values arrive as the dicts of
``dataclasses.asdict`` and its arrays as numpy. Tests use these to feed
both packages the same problem.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.comm.channel import GATHER
from repro_torch.core.gram import GramConfig, GramEngine
from repro_torch.core.strategy import Strategy

#: ``repro``'s Gram backend names -> the port's
_BACKENDS = {"auto": "auto", "pallas": "kernel", "xla": "torch",
             "numpy": "numpy"}
#: ``repro`` GramEngine fields that are TPU tile edges or switches with no
#: counterpart here: the port's kernels pick their own tiles
_TPU_FIELDS = ("interpret", "block_n", "block_d", "block_b")


def _channel_from_fields(fields) -> object:
    """A channel from ``asdict`` of a ``repro`` channel: the gather
    channel has no fields; MAC ({machines}) and budget ({budget_bits,
    machines}) channels wait for the wire plane."""
    fields = dict(fields or {})
    kind = fields.pop("kind", None)
    if not fields and kind in (None, "gather"):
        return GATHER
    name = kind or ("budget" if "budget_bits" in fields else "mac")
    raise NotImplementedError(
        f"the {name!r} channel arrives with the port's wire plane")


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

