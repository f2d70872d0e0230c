"""Faults planted in the program underneath a run, for the tests and for
the fault readings that limits are checked against (``calibrate.py
--fault``); the benchmark's own runs never plant one.

* ``halve`` — half of the batch left out, the mean taken over the rest:
  the Gram of the first half of the rows, scaled to the full count.
* ``alter`` — an answer altered where it is produced: a tree's last edge
  moved, each sweep trial's first edge moved, the sweep's edit distances
  off by one.

A traffic kind that breaks its own way names its faults in its module's
``FAULTS`` ({name: a function of no arguments giving the triples}); the
tree and sweep kinds, which have none, share the ones here.
"""
from __future__ import annotations

import importlib


def patches(name: str, cell: str) -> list[tuple[object, str, object]]:
    """(module, attribute, replacement) triples planting fault ``name``
    under cell ``cell``'s traffic kind."""
    from . import harness

    kind = harness.traffic(harness.cell(harness.benchmark(), cell)
                           ["traffic"])["kind"]
    own = getattr(importlib.import_module(f"perfbench.kinds.{kind}"),
                  "FAULTS", None)
    if own is None:
        return _graph_patches(name)
    if name not in own:
        raise ValueError(f"unknown fault {name!r} of kind {kind!r}")
    return own[name]()


def _graph_patches(name: str) -> list[tuple[object, str, object]]:
    from repro_torch.core import chow_liu, estimators, experiments

    if name == "halve":
        gram = estimators.payload_gram
        batch = estimators.strategy_weights_batch

        def half_gram(payload, strategy, **kw):
            h = payload.shape[-2] // 2
            return gram(payload[..., :h, :], strategy, **kw) * (
                payload.shape[-2] / h)

        def half_batch(x, strategy, *, n_valid=None, **kw):
            h = x.shape[-2] // 2
            return batch(x[..., :h, :], strategy,
                         n_valid=None if n_valid is None else n_valid // 2,
                         **kw)

        return [(estimators, "payload_gram", half_gram),
                (estimators, "strategy_weights_batch", half_batch)]
    if name == "alter":
        edges_of = chow_liu.adjacency_to_edges
        channels = experiments.structure_metric_channels
        mst = chow_liu.boruvka_mst_batch

        def moved(adj):
            e = edges_of(adj)
            j, k = e[-1]
            return e[:-1] + [(j, (k + 1) % adj.shape[-1] or 1)]

        def moved_batch(w, *args, **kw):
            adj = mst(w, *args, **kw)
            d = adj.shape[-1]
            for t in range(adj.shape[0]):
                j, k = (int(v) for v in adj[t].triu(1).nonzero()[0])
                k2 = (k + 1) % d or 1
                adj[t, j, k] = adj[t, k, j] = False
                adj[t, j, k2] = adj[t, k2, j] = True
            return adj

        def off_by_one(adj_est, adj_ref):
            out = channels(adj_est, adj_ref)
            out[..., 1] += 1.0
            return out

        return [(chow_liu, "adjacency_to_edges", moved),
                (chow_liu, "boruvka_mst_batch", moved_batch),
                (experiments, "boruvka_mst_batch", moved_batch),
                (experiments, "structure_metric_channels", off_by_one)]
    raise ValueError(f"unknown fault {name!r}")


def plant(name: str, cell: str) -> None:
    """Plant fault ``name`` under cell ``cell`` for the rest of the
    process."""
    for mod, attr, fn in patches(name, cell):
        setattr(mod, attr, fn)
