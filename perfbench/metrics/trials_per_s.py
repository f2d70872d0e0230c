"""trials_per_s: every trial of every sweep of the window over its
seconds."""


def read(ctx):
    if ctx.unit != "trial" or not ctx.window_s or not ctx.on_card:
        return None
    return ctx.units / ctx.window_s
