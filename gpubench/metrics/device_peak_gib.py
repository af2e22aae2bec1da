"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""


def read(run, name):
    return run.peak_bytes / 2**30 if run.device.type == "cuda" else None
