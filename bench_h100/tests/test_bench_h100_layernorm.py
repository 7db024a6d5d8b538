"""``layernorm_ms.infer`` on a synthetic trace: it reads the LayerNorm
forward kernels of PyTorch and of the port (K7) by name, and nothing of
GroupNorm's or the LayerNorm backward's."""

import math
from types import SimpleNamespace

from bench_h100 import harness
from bench_h100.trace import Trace

TORCH_LN = ("void at::native::(anonymous namespace)::vectorized_layer_norm_"
            "kernel<float, float>(int, float, float const*, float const*, "
            "float const*, float*, float*, float*)")
TORCH_LN_ROWWISE = ("void at::native::(anonymous namespace)::LayerNormForward"
                    "CUDAKernel<float, float>(long, float const*, ...)")
K7 = ("void (anonymous namespace)::layer_norm_fwd_kernel<float, "
      "__nv_bfloat16, 3>(float const*, float const*, float const*, "
      "__nv_bfloat16*, long long, int, int, float)")
OTHERS = ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel"
          "<float, float>(long, float, float const*, float*, float*)",
          "void at::native::(anonymous namespace)::ComputeFusedParamsCUDA"
          "Kernel<float>(long, long, long, float const*, ...)",
          "void at::native::(anonymous namespace)::layer_norm_grad_input_"
          "kernel<float, float>(...)",
          "void window_attn_tc_kernel<32, false, __nv_bfloat16 const*>(...)")


def _run(device, traced=4):
    return SimpleNamespace(kind="infer", trace=Trace(0.0, 1.0, device, []),
                           traced_requests=traced)


def test_reads_torch_and_k7_layer_norm_per_request():
    read = harness.reader("layernorm_ms.infer")
    device = [(0.0, 0.010, TORCH_LN), (0.1, 0.102, TORCH_LN_ROWWISE),
              (0.2, 0.204, K7)] + [(0.3 + i, 0.4 + i, n)
                                   for i, n in enumerate(OTHERS)]
    assert math.isclose(read(_run(device)), 1e3 * 0.016 / 4)
    assert math.isclose(read(_run([(0.0, 0.006, K7)], 2)), 3.0)


def test_silent_without_a_trace_or_its_kernels():
    read = harness.reader("layernorm_ms.infer")
    assert read(_run([(0.3, 0.4, n) for n in OTHERS])) is None
    assert read(SimpleNamespace(kind="infer", trace=None,
                                traced_requests=0)) is None
    assert read(_run([(0.0, 0.01, K7)], traced=0)) is None
