"""entry_mst_ms.sweep: the batched Boruvka MWST and metric sums in
the timed entry (``repro_torch.mst`` spans summed over a sweep's
points), ms on their CUDA events (median over the profiled
sweeps)."""
from perfbench import spans


def read(ctx):
    t = spans.per_root(ctx, "trial",
                       lambda g: spans.stage_s(g, "repro_torch.mst"))
    return None if t is None else 1e3 * t
