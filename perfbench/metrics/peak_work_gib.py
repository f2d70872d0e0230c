"""peak_work_gib: the window's peak of allocated device memory less the
bytes held when it opened (the inputs), in GiB. The reading is the CUDA
caching allocator's (``torch.cuda.max_memory_allocated``), which the
harness takes on the host after the window: no clock and no trace."""


def read(ctx):
    if ctx.peak_work_bytes is None:
        return None
    return ctx.peak_work_bytes / 2 ** 30
