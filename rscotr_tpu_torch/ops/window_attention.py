"""Swin window attention core (PyTorch + CUDA kernels K2 and K2b).

Counterpart of rscotr_tpu/ops/pallas/window_attention.py
(``window_attention_fused``) with its signature and layouts, and of the
einsum path in rscotr_tpu/models/backbones/swin.py, which is what JAX trains
through. ``window_attention`` is a ``torch.autograd.Function`` with
gradients for q, k, v and rel_bias (summed over images and windows, in
float32); the shift mask is a constant. For CUDA tensors the forward
launches the hand-written kernel ``csrc/window_attn.cu`` (K2) and the
backward ``csrc/window_attn_bwd.cu`` (K2b); for CPU tensors they are the
plain versions ``window_attention_torch`` and ``window_attention_bwd_torch``;
any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rscotr_tpu_torch.ops import kernel_lib


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_bias, shift_mask, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, rel_bias, shift_mask)
        if q.device.type == "cpu":
            return window_attention_torch(q, k, v, rel_bias, shift_mask,
                                          scale)
        return _window_attention_cuda(q, k, v, rel_bias, shift_mask, scale)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, rel_bias, shift_mask = ctx.saved_tensors
        dq, dk, dv, d_bias = window_attention_bwd(
            q, k, v, rel_bias, shift_mask, ctx.scale, d_out.contiguous())
        return dq, dk, dv, d_bias, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_bias: torch.Tensor,
                     shift_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(scale * q k^T + rel_bias[h] + shift_mask[w]) v.

    Args:
        q, k, v: (B, nW, H, n, hd) per (image, window, head) tiles; may be
            strided views (channel stride 1).
        rel_bias: (H, n, n) float32 relative-position bias.
        shift_mask: (nW, n, n) float32 additive mask or None.
    Returns:
        (B, nW, H, n, hd) contiguous, in q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: no path for device {q.device}")
    return _WindowAttention.apply(q, k, v, rel_bias, shift_mask, float(scale))


window_attention.launches = 0

# shared-memory ceiling of one block on Hopper (227 KB)
_MAX_SMEM = 232448


def _check_cuda_args(name, q, k, v, rel_bias, shift_mask, smem):
    """Validate the kernels' inputs; returns the 9 (image * window, head,
    token) element strides of q, k, v."""
    B, nW, H, n, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    if tuple(rel_bias.shape) != (H, n, n) or rel_bias.dtype != torch.float32:
        raise ValueError(f"{name}: rel_bias must be float32 (H, n, n) = "
                         f"{(H, n, n)}")
    if shift_mask is not None and (tuple(shift_mask.shape) != (nW, n, n) or
                                   shift_mask.dtype != torch.float32):
        raise ValueError(f"{name}: shift_mask must be float32 (nW, n, n) = "
                         f"{(nW, n, n)}")
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: n={n}, hd={hd} needs {smem} B of shared "
                         "memory per block")
    strides = []
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} on {t.device}")
        s = t.stride()
        if s[4] != 1 or (B > 1 and nW > 1 and s[0] != nW * s[1]):
            raise ValueError(f"{name}: {arg} strides {s} need channel "
                             "stride 1 and mergeable (B, nW) dims")
        strides += [s[1] if nW > 1 else s[0], s[2], s[3]]
    for arg, t in (("rel_bias", rel_bias), ("shift_mask", shift_mask)):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous on "
                             f"{q.device}")
    return (ctypes.c_longlong * 9)(*strides)


def _window_attention_cuda(q, k, v, rel_bias, shift_mask, scale):
    B, nW, H, n, hd = q.shape
    st = _check_cuda_args("window_attention", q, k, v, rel_bias, shift_mask,
                          4 * (3 * n * hd + n + n * n + 4 * n))
    out = torch.empty((B, nW, H, n, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = kernel_lib.load()
    with torch.cuda.device(q.device):
        err = lib.window_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kernel_lib.dtype_code(q, "q"), st, rel_bias.data_ptr(),
            shift_mask.data_ptr() if shift_mask is not None else None,
            out.data_ptr(), B * nW, H, nW, n, hd, scale,
            kernel_lib.stream_ptr(q.device))
    kernel_lib.check(err, "window_attn_fwd")
    window_attention.launches += 1
    return out


def window_attention_bwd(q, k, v, rel_bias, shift_mask, scale, d_out):
    """Gradients of ``window_attention`` -> (dq, dk, dv in q's dtype,
    d_rel_bias float32): kernel K2b on CUDA (``launches`` counts it), the
    plain version on the CPU."""
    if q.device.type == "cpu":
        return window_attention_bwd_torch(q, k, v, rel_bias, shift_mask,
                                          scale, d_out)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: no path for device "
                         f"{q.device}")
    B, nW, H, n, hd = q.shape
    st = _check_cuda_args("window_attention_bwd", q, k, v, rel_bias,
                          shift_mask,
                          4 * (2 * n * hd + 2 * n * (hd + 1) + 3 * n * n))
    if tuple(d_out.shape) != tuple(q.shape) or d_out.dtype != q.dtype or \
            d_out.device != q.device or not d_out.is_contiguous():
        raise ValueError("window_attention_bwd: d_out must be contiguous "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}")
    dq, dk, dv = (torch.empty((B, nW, H, n, hd), dtype=q.dtype,
                              device=q.device) for _ in range(3))
    d_bias = torch.zeros((H, n, n), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, dk, dv, d_bias
    lib = kernel_lib.load()
    with torch.cuda.device(q.device):
        err = lib.window_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kernel_lib.dtype_code(q, "q"), st, rel_bias.data_ptr(),
            shift_mask.data_ptr() if shift_mask is not None else None,
            d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            d_bias.data_ptr(), B * nW, H, nW, n, hd, float(scale),
            kernel_lib.stream_ptr(q.device))
    kernel_lib.check(err, "window_attn_bwd")
    window_attention_bwd.launches += 1
    return dq, dk, dv, d_bias


window_attention_bwd.launches = 0


def _probs(q, k, rel_bias, shift_mask, scale):
    s = torch.einsum("bwhqd,bwhkd->bwhqk", q.float() * scale, k.float())
    s = s + rel_bias.float()[None, None]
    if shift_mask is not None:
        s = s + shift_mask.float()[None, :, None]
    return torch.softmax(s, dim=-1)


def window_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rel_bias: torch.Tensor,
                               shift_mask: Optional[torch.Tensor],
                               scale: float, d_out: torch.Tensor):
    """Plain PyTorch version of K2b, f32 throughout: dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(dO O)), dQ = scale dS K,
    dK = scale dS^T Q, d_rel_bias = sum of dS over images and windows.
    O = P V is recomputed in f32."""
    p = _probs(q, k, rel_bias, shift_mask, scale)
    vf, do = v.float(), d_out.float()
    o = torch.einsum("bwhqk,bwhkd->bwhqd", p, vf)
    dv = torch.einsum("bwhqk,bwhqd->bwhkd", p, do)
    dp = torch.einsum("bwhqd,bwhkd->bwhqk", do, vf)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    dq = torch.einsum("bwhqk,bwhkd->bwhqd", ds, k.float()) * scale
    dk = torch.einsum("bwhqk,bwhqd->bwhkd", ds, q.float()) * scale
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype),
            ds.sum((0, 1)))


def window_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_bias: torch.Tensor,
                           shift_mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K2 (the einsum path of the JAX Swin block):
    f32 scores and softmax, output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = _probs(q, k, rel_bias, shift_mask, scale)
    return torch.einsum("bwhqk,bwhkd->bwhqd", p, v.float()).to(q.dtype)
