"""setup_s: seconds from the process's start to the end of set-up
(imports, kernels loaded or built, inputs made, the warm calls)."""


def read(ctx):
    return ctx.setup_s if ctx.on_card else None
