"""The share of the profiled sub-window that no device kernel, copy or
set covers (the union of their intervals)."""


def read(run):
    if run.kind != "infer" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
