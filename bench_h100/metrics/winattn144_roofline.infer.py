"""K2's long-window tensor-core body (``csrc/window_attn.cu``,
``window_attn_tc144_kernel``: bf16 windows of 65 to 144 tokens): the least
time of the traced requests' window-attention calls, from their shapes,
over the profiled time of that kernel. None where it did not run (every
call of the cell takes it where the program has it)."""

from bench_h100.counts import kernels
from bench_h100.harness import roofline_share

NAMES = ("window_attn_tc144_kernel",)


def read(run):
    return roofline_share(run, "window_attn_fwd", kernels.window_attn_fwd,
                          NAMES)
