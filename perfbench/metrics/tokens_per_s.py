"""tokens_per_s: the prompt tokens prefilled in the window over its
seconds."""


def read(ctx):
    if ctx.unit != "token" or not ctx.window_s or not ctx.on_card:
        return None
    return ctx.units / ctx.window_s
