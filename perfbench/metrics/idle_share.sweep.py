"""idle_share.sweep: the share of the traced window of whole sweeps in
which no operation ran on the device, in %."""


def read(ctx):
    p = ctx.profile
    if ctx.unit != "trial" or p is None or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
