"""Images (tiles or chips) whose outputs reached the host in the window,
over the window's seconds."""


def read(run):
    if run.kind != "infer" or not run.requests:
        return None
    return run.images / run.window_s
