"""K1 (``csrc/msda_fwd.cu``, both bodies): the least time of the traced
requests' deformable-attention calls, from their shapes, over the
profiled time of the kernels named below."""

from bench_h100.counts import kernels
from bench_h100.harness import roofline_share

NAMES = ("msda_fwd_vec_kernel", "msda_fwd_lane_kernel")


def read(run):
    return roofline_share(run, "msda_fwd", kernels.msda_fwd, NAMES)
