"""The model FLOPs of every request of the window (``counts/mask2former.py``,
from the configuration's widths and the tiles' shapes) over the window's
seconds, as a share of the card's published bf16 peak."""

from bench_h100.counts import peaks


def read(run):
    peak = peaks.flops(run.device_name)
    if run.kind != "infer" or not run.requests or peak is None:
        return None
    return 100.0 * run.flops_per_request * run.requests / run.window_s / peak
