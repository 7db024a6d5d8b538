"""K2 (``csrc/window_attn.cu``, the CUDA-core and tensor-core bodies):
the least time of the traced requests' window-attention calls, from their
shapes, over the profiled time of the kernels named below."""

from bench_h100.counts import kernels
from bench_h100.harness import roofline_share

NAMES = ("window_attn_kernel", "window_attn_tc_kernel")


def read(run):
    return roofline_share(run, "window_attn_fwd", kernels.window_attn_fwd, NAMES)
