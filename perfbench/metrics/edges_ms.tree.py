"""edges_ms.tree: the host clock's ms of the timed entry's
``repro_torch.edges`` span (the adjacency's copy back, ``np.triu``,
``np.nonzero`` and the list; median over the profiled trees)."""
from perfbench import spans


def read(ctx):
    t = spans.per_root(ctx, "tree", lambda g: spans.stage_s(
        g, "repro_torch.edges", clock="host_s"))
    return None if t is None else 1e3 * t
