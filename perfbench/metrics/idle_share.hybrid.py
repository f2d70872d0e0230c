"""idle_share.hybrid: the share of the traced window of whole hybrid
prefills in which no operation ran on the device, in %."""


def read(ctx):
    p = ctx.profile
    if ctx.unit != "token" or p is None or not ctx.on_card \
            or not p["window_s"] or "ssd" not in ctx.counts:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
