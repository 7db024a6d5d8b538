"""Median host time from the call into the serving entry to its return,
before the outputs are read back: what the host spends issuing a
request."""

from bench_h100.harness import percentile


def read(run):
    if run.kind != "infer" or not run.issue:
        return None
    return 1e3 * percentile(run.issue, 50)
