"""entry_mwst_ms.tree: the timed entry's weights, Boruvka MWST and edge
list (``repro_torch.weights`` + ``.mst`` + ``.edges``, the extent of
``mwst_ms.tree``), ms on their CUDA events (median over the profiled
trees)."""
from perfbench import spans


def read(ctx):
    t = spans.per_root(ctx, "tree", lambda g: spans.stage_s(
        g, "repro_torch.weights", "repro_torch.mst", "repro_torch.edges"))
    return None if t is None else 1e3 * t
