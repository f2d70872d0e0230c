"""host_reads.tree: the program's explicit device->host reads in one
timed tree (``repro_torch.trace``'s ``host_reads`` over the root span:
the adjacency, and one a Boruvka round; median over the profiled
trees)."""
from perfbench import spans


def read(ctx):
    return spans.per_root(ctx, "tree",
                          lambda g: spans.root_count(g, "host_reads"))
