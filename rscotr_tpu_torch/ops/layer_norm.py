"""LayerNorm forward over the last dimension (PyTorch + CUDA kernel K7).

flax ``LayerNorm(epsilon=1e-5)`` as the port's ``models.layers.common.
LayerNorm`` computes it when autograd does not record the call (serving,
evaluation, export): float32 statistics (the mean, then the mean of squared
deviations from it), float32 gamma and beta, the input read in its own
dtype (float32 or bfloat16), the output written in float32 or bfloat16
(``out_dtype``), rounded to nearest even as ``.to(torch.bfloat16)`` rounds
the float32 result. Training keeps ``F.layer_norm``, whose backward
autograd has.

The JAX package has no Pallas kernel for it: XLA fuses its LayerNorm. K7
(``csrc/layer_norm.cu``) exists because PyTorch's kernel behind a separate
cast ran at 21-35% of its bandwidth bound in the benchmark's Swin cells,
and wrote float32 that the bf16 products reading it cast back.

``layer_norm`` launches K7 for a CUDA tensor and runs the plain version
``layer_norm_torch`` for a CPU one; any other device raises. While
``torch.export`` traces, the call is the operator
``torch.ops.rscotr_torch.layer_norm_fwd`` (registered when
``rscotr_tpu_torch.ops`` is imported), so that a program holds the kernel;
in eager mode K7 launches directly, at less host cost than the operator's
dispatch. ``launches`` counts K7's launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from rscotr_tpu_torch.ops import kernel_lib

# The chunk counts a lane may hold (csrc/layer_norm.cu ``by_nv``): a chunk is
# 16 bytes of the input (4 float32 or 8 bfloat16 elements), and a row of C
# elements is C / chunk chunks, shared by the largest power of two up to 32
# lanes that divides them.
NV_SIZES = (1, 2, 3, 4, 6, 8, 12, 16)


@functools.lru_cache(maxsize=None)
def plan(C: int, dtype: torch.dtype) -> Optional[Tuple[int, int]]:
    """(lanes a row, chunks a lane) of K7 for width ``C`` of an input of
    ``dtype``, or None where the kernel does not take the width."""
    per = 16 // dtype.itemsize
    if C < 1 or C % per:
        return None
    chunks = C // per
    lanes = min(32, chunks & -chunks)
    nv = chunks // lanes
    return (lanes, nv) if nv in NV_SIZES else None


def layer_norm_torch(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K7, its arithmetic in float32: the mean,
    the mean of squared deviations from it, (x - mean) * rsqrt(var + eps)
    * weight + bias, cast to ``out_dtype``."""
    xf = x.float()
    d = xf - xf.mean(-1, keepdim=True)
    var = (d * d).mean(-1, keepdim=True)
    return (d * torch.rsqrt(var + eps) * weight + bias).to(out_dtype)


@torch.library.custom_op("rscotr_torch::layer_norm_fwd", mutates_args=(),
                         device_types="cpu")
def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, bf16_out: bool) -> torch.Tensor:
    """K7 as an operator (``torch.ops.rscotr_torch.layer_norm_fwd``), so
    that a ``torch.export`` program holds the kernel and not the plain
    version: the plain version on the CPU, K7 on CUDA, a contiguous output
    of x's shape in bfloat16 (``bf16_out``) or float32 from the fake
    implementation while tracing."""
    return layer_norm_torch(x, weight, bias, eps, _out_dtype(bf16_out))


@layer_norm_fwd.register_kernel("cuda")
def _layer_norm_fwd_cuda(x, weight, bias, eps, bf16_out):
    return _layer_norm_cuda(x, weight, bias, eps, _out_dtype(bf16_out))


@layer_norm_fwd.register_fake
def _layer_norm_fwd_fake(x, weight, bias, eps, bf16_out):
    return x.new_empty(x.shape, dtype=_out_dtype(bf16_out))


def _out_dtype(bf16_out: bool) -> torch.dtype:
    return torch.bfloat16 if bf16_out else torch.float32


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm of ``x`` over its last dimension (not differentiable).

    Args:
        x: (..., C) float32 or bfloat16; on CUDA contiguous and 16-byte
            aligned, with C a width that ``plan`` takes.
        weight, bias: (C,) float32.
        out_dtype: float32 or bfloat16.
    Returns:
        (..., C) in ``out_dtype``.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm: out_dtype {out_dtype} (float32 or "
                        "bfloat16)")
    if torch.compiler.is_exporting():
        return torch.ops.rscotr_torch.layer_norm_fwd(
            x, weight, bias, float(eps), out_dtype == torch.bfloat16)
    if x.is_cuda:
        return _layer_norm_cuda(x, weight, bias, eps, out_dtype)
    if x.is_cpu:
        return layer_norm_torch(x, weight, bias, eps, out_dtype)
    raise ValueError(f"layer_norm: no path for device {x.device}")


layer_norm.launches = 0


def _layer_norm_cuda(x, weight, bias, eps, out_dtype):
    """Kernel K7 on CUDA tensors. A module calls it some 25 times a DINO
    decoder pass, where the host paces the request, so its host work is
    kept to what the parent's ``x.float()`` and ``F.layer_norm`` cost:
    attribute checks, one ``empty_like``, the raw stream handle, and the
    device switch (where one is needed) inside the C entry."""
    C = x.shape[-1]
    code = kernel_lib.DTYPE_CODES.get(x.dtype)
    if code is None or plan(C, x.dtype) is None:
        raise ValueError(f"layer_norm: K7 takes no width {C} of {x.dtype} "
                         f"(a multiple of 16 bytes; lanes x chunks "
                         f"{NV_SIZES})")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer_norm: x must be contiguous and 16-byte "
                         "aligned")
    dev = x.get_device()
    for arg, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != C or \
                not t.is_contiguous() or t.get_device() != dev:
            raise ValueError(f"layer_norm: {arg} must be contiguous float32 "
                             f"({C},) on {x.device}")
    kernel_lib.refuse_dtensor("layer_norm", x, weight, bias)
    y = torch.empty_like(x, dtype=out_dtype)
    rows = x.numel() // C
    if rows == 0:
        return y
    err = kernel_lib.load().layer_norm_fwd(
        x.data_ptr(), code, weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        kernel_lib.DTYPE_CODES[out_dtype], rows, C, eps, dev,
        kernel_lib.raw_stream(dev))
    kernel_lib.check(err, "layer_norm_fwd")
    layer_norm.launches += 1
    return y
