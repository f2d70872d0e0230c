"""sample_ms.sweep: the sampler's ms in one staged sweep (every n of the
plan; CUDA events, median over repetitions)."""


def read(ctx):
    t = ctx.stage_s("sample")
    if t is None or ctx.unit != "trial" or not ctx.on_card:
        return None
    return 1e3 * t
