"""``torch.cuda.max_memory_allocated()`` over the window, in GiB."""


def read(run):
    if run.kind != "infer" or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
