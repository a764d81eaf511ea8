"""``torch.cuda.max_memory_allocated()`` over the run up to the window's
close, before the reference runs (GiB)."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
