"""edges_idle_share.tree: the device's idle time that the trace names
after the program's ``repro_torch.edges`` span (the host's edge list),
over the traced window of whole trees, in %."""


def read(ctx):
    p = ctx.profile
    if (ctx.unit != "tree" or p is None or not p["window_s"]
            or not ctx.on_card):
        return None
    idle = [s for name, s in p["idle_gaps"] if name == "repro_torch.edges"]
    return 100.0 * sum(idle) / p["window_s"] if idle else None
