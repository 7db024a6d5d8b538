"""The 95th percentile over every request of the window, each from the
call into the entry until its outputs are on the host."""

from bench_h100.harness import percentile


def read(run):
    if run.kind != "infer" or not run.latencies:
        return None
    return 1e3 * percentile(run.latencies, 95)
