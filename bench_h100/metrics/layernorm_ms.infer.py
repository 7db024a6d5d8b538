"""Device ms a traced request spends in LayerNorm forward kernels: PyTorch's
(``vectorized_layer_norm_kernel``, ``LayerNormForwardCUDAKernel``) and the
port's K7 (``csrc/layer_norm.cu``, ``layer_norm_fwd_kernel``), summed over
the traced requests and divided by their count. GroupNorm's kernels and the
LayerNorm backward's are not named here."""

NAMES = ("layer_norm_kernel", "LayerNormForwardCUDAKernel",
         "layer_norm_fwd_kernel")


def read(run):
    if run.trace is None or not run.traced_requests:
        return None
    seconds = run.trace.kernel_s(NAMES)
    if seconds is None:
        return None
    return 1e3 * seconds / run.traced_requests
