"""The device memory high-water mark over the window, in GB:
`torch.cuda.max_memory_allocated()` after a reset at the window's
start."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
