"""``train_peak_gib``: the most device memory the program's allocator
held during the window (``torch.cuda.max_memory_allocated`` after a reset
at the window's start), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
