"""host_reads.sweep: the program's explicit device->host reads in one
timed sweep (``repro_torch.trace``'s ``host_reads`` over the root span;
median over the profiled sweeps)."""
from perfbench import spans


def read(ctx):
    return spans.per_root(ctx, "trial",
                          lambda g: spans.root_count(g, "host_reads"))
