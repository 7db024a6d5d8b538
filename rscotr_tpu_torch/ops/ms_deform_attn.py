"""Multi-scale deformable attention sampling core (PyTorch + CUDA kernels
K1, K1b and K3').

Counterpart of rscotr_tpu/ops/ms_deform_attn.py. Sampling semantics match
``F.grid_sample(align_corners=False, padding_mode="zeros")`` on per-level
(H, W) value maps with locations normalized to [0, 1]:
``x_pix = loc_x * W - 0.5``; bilinear corners outside the map contribute
zero.

``ms_deform_attn`` is a ``torch.autograd.Function``. For CUDA tensors the
forward launches the hand-written kernel ``csrc/msda_fwd.cu`` (K1) and the
backward follows the JAX decomposition (``_quad_gather_bwd`` and
``_corner_weighted_sum_bwd`` of the JAX module): kernel K1b
(``csrc/msda_bwd.cu``, ``msda_bwd_rows``) writes the attention-weight and
location gradients and each sampling point's quad-row update ``d_g`` (its
four quad-slot weights times ``d_out``); kernel K3' (``ops/scatter_mm.py``)
scatters ``d_g`` into the quad-table gradient in float32, one launch per
backward; plain tensor ops fold that back to the value gradient (the
transpose of the quad-table build: four shifted slices added). For CPU
tensors the forward is the plain ``ms_deform_attn_torch`` and the backward
the plain decomposition ``ms_deform_attn_bwd_torch`` (``msda_bwd_rows_torch``,
``scatter_add_mm_torch``, the fold); any other device raises.

Gradient semantics are JAX autodiff's: ``floor`` has zero gradient, the
corner validity factors are constants, and the gradients come back in the
primal dtypes.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from rscotr_tpu_torch.ops import kernel_lib
from rscotr_tpu_torch.ops.scatter_mm import (scatter_add_mm,
                                             scatter_add_mm_torch)


def _shapes(spatial_shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


class _MsDeformAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, loc, attn, shapes):
        ctx.shapes = shapes
        ctx.save_for_backward(value, loc, attn)
        if value.device.type == "cpu":
            return ms_deform_attn_torch(value, shapes, loc, attn)
        return _ms_deform_attn_cuda(value, shapes, loc, attn)

    @staticmethod
    def backward(ctx, d_out):
        value, loc, attn = ctx.saved_tensors
        d_value, d_loc, d_attn = ms_deform_attn_bwd(
            value, ctx.shapes, loc, attn, d_out.contiguous())
        return d_value, d_loc, d_attn, None


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention aggregation (differentiable in
    value, sampling_locations and attention_weights).

    Args:
        value: (B, num_value, num_heads, head_dim); num_value = sum(H*W).
        spatial_shapes: ((H, W), ...) per level.
        sampling_locations: (B, num_query, num_heads, num_levels,
            num_points, 2) in [0, 1] per level, (x, y) order; float32.
        attention_weights: (B, num_query, num_heads, num_levels, num_points),
            softmax-normalized over (levels * points).
    Returns:
        (B, num_query, num_heads * head_dim) in value's dtype.
    """
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn: no path for device {value.device}")
    return _MsDeformAttn.apply(value, sampling_locations, attention_weights,
                               _shapes(spatial_shapes))


ms_deform_attn.launches = 0


def _check_cuda_args(name, value, shapes, loc, attn, *more):
    B, Nv, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    if Nv != sum(h * w for h, w in shapes) or len(shapes) != L:
        raise ValueError(f"{name}: value rows {Nv} / levels {L} do not "
                         f"match spatial_shapes {shapes}")
    if tuple(loc.shape) != (B, Q, H, L, P, 2) or \
            tuple(attn.shape) != (B, Q, H, L, P):
        raise ValueError(f"{name}: shapes value {tuple(value.shape)} loc "
                         f"{tuple(loc.shape)} attn {tuple(attn.shape)}")
    if loc.dtype != torch.float32:
        raise TypeError(f"{name}: sampling_locations must be float32")
    if not 1 <= L <= 8 or not 1 <= D <= 128:
        raise ValueError(f"{name} kernel takes 1-8 levels and head_dim <= "
                         f"128; got L={L}, D={D}")
    for arg, t in (("value", value), ("sampling_locations", loc),
                   ("attention_weights", attn)) + more:
        if t.device != value.device:
            raise ValueError(f"{name}: {arg} on {t.device}, value on "
                             f"{value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return B, Nv, H, D, Q, L, P


def _levels_arg(shapes):
    return (ctypes.c_int * (2 * len(shapes)))(*[n for s in shapes for n in s])


def _ms_deform_attn_cuda(value, shapes, loc, attn):
    B, Nv, H, D, Q, L, P = _check_cuda_args("ms_deform_attn", value, shapes,
                                            loc, attn)
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    lib = kernel_lib.load()
    with torch.cuda.device(value.device):
        err = lib.msda_fwd(
            value.data_ptr(), kernel_lib.dtype_code(value, "value"),
            loc.data_ptr(), attn.data_ptr(),
            kernel_lib.dtype_code(attn, "attention_weights"),
            out.data_ptr(), B, Nv, Q, H, D, L, P, _levels_arg(shapes),
            kernel_lib.stream_ptr(value.device))
    kernel_lib.check(err, "msda_fwd")
    ms_deform_attn.launches += 1
    return out


def ms_deform_attn_bwd(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor,
                       d_out: torch.Tensor):
    """Gradients of ``ms_deform_attn`` -> (d_value, d_loc, d_attn) in the
    primal dtypes: K1b, then K3', then the fold on CUDA; the plain
    decomposition (``ms_deform_attn_bwd_torch``) on the CPU."""
    shapes = _shapes(spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_bwd_torch(value, shapes, sampling_locations,
                                        attention_weights, d_out)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn_bwd: no path for device "
                         f"{value.device}")
    d_g, gidx, d_loc, d_attn = msda_bwd_rows(
        value, shapes, sampling_locations, attention_weights, d_out)
    B, Nv, H, D = value.shape
    d_qt = scatter_add_mm(d_g, gidx, Nv)
    del d_g
    return _fold_quad_grad(d_qt, shapes, B, H, D, value.dtype), d_loc, d_attn


def msda_bwd_rows(value, shapes, loc, attn, d_out):
    """Kernel K1b on CUDA tensors -> (d_g (B*H, Q*L*P, 4*D) in value's
    dtype, gidx (B*H, Q*L*P) int32 quad rows, d_loc, d_attn); ``launches``
    counts it."""
    shapes = _shapes(shapes)
    B, Nv, H, D, Q, L, P = _check_cuda_args(
        "msda_bwd_rows", value, shapes, loc, attn, ("d_out", d_out))
    if tuple(d_out.shape) != (B, Q, H * D) or d_out.dtype != value.dtype:
        raise ValueError(f"msda_bwd_rows: d_out must be {value.dtype} "
                         f"{(B, Q, H * D)}, got {d_out.dtype} "
                         f"{tuple(d_out.shape)}")
    dev = value.device
    d_attn = torch.empty_like(attn)
    d_loc = torch.empty_like(loc)
    d_g = torch.empty((B * H, Q * L * P, 4 * D), dtype=value.dtype,
                      device=dev)
    gidx = torch.empty((B * H, Q * L * P), dtype=torch.int32, device=dev)
    if d_g.numel() == 0:
        return d_g, gidx, d_loc.zero_(), d_attn.zero_()
    lib = kernel_lib.load()
    with torch.cuda.device(dev):
        err = lib.msda_bwd(
            value.data_ptr(), kernel_lib.dtype_code(value, "value"),
            loc.data_ptr(), attn.data_ptr(),
            kernel_lib.dtype_code(attn, "attention_weights"),
            d_out.data_ptr(), d_attn.data_ptr(), d_loc.data_ptr(),
            d_g.data_ptr(), gidx.data_ptr(), B, Nv, Q, H, D, L, P,
            _levels_arg(shapes), kernel_lib.stream_ptr(dev))
    kernel_lib.check(err, "msda_bwd")
    msda_bwd_rows.launches += 1
    return d_g, gidx, d_loc, d_attn


msda_bwd_rows.launches = 0


def _fold_quad_grad(d_qt, shapes, B, H, D, dtype):
    """Transpose of the quad-table build: the (B*H, Nv, 4*D) quad-table
    gradient, slot s = (dy, dx) of row (y, x) holding the gradient of
    value (y + dy, x + dx), folded back to d_value (B, Nv, H, D)."""
    parts = []
    start = 0
    for h, w in shapes:
        q = d_qt[:, start:start + h * w].reshape(B * H, h, w, 4, D)
        dv = q[..., 0, :].clone()
        dv[:, :, 1:] += q[:, :, :-1, 1]
        dv[:, 1:, :] += q[:, :-1, :, 2]
        dv[:, 1:, 1:] += q[:, :-1, :-1, 3]
        parts.append(dv.reshape(B * H, h * w, D))
        start += h * w
    d_value = torch.cat(parts, 1).reshape(B, H, -1, D).permute(0, 2, 1, 3)
    return d_value.to(dtype).contiguous()


def ms_deform_attn_bwd_torch(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor,
                             d_out: torch.Tensor):
    """Plain PyTorch version of the backward: ``msda_bwd_rows_torch``, then
    ``scatter_add_mm_torch``, then the fold. Returns (d_value, d_loc,
    d_attn) in the primal dtypes."""
    shapes = _shapes(spatial_shapes)
    B, Nv, H, D = value.shape
    d_g, gidx, d_loc, d_attn = msda_bwd_rows_torch(
        value, shapes, sampling_locations, attention_weights, d_out)
    d_qt = scatter_add_mm_torch(d_g, gidx, Nv)
    return _fold_quad_grad(d_qt, shapes, B, H, D, value.dtype), d_loc, d_attn


def msda_bwd_rows_torch(value, spatial_shapes, sampling_locations,
                        attention_weights, d_out):
    """Plain PyTorch version of K1b: the quad-slot weights as
    ``_ms_deform_attn_xla`` forms them, the corner dot products
    <V_c, d_out> for d_attn and d_loc, and the quad-row updates ``d_g`` in
    value's dtype with their rows ``gidx``."""
    shapes = _shapes(spatial_shapes)
    B, Nv, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    dev = value.device
    loc = sampling_locations.float()
    a = attention_weights.float()                         # (B, Q, H, L, P)
    do = d_out.float().reshape(B, Q, H, D)
    vh = value.float().permute(0, 2, 1, 3)                # (B, H, Nv, D)
    Hs = torch.tensor([h for h, _ in shapes], dtype=torch.float32,
                      device=dev)[:, None]
    Ws = torch.tensor([w for _, w in shapes], dtype=torch.float32,
                      device=dev)[:, None]
    starts = torch.tensor([sum(h * w for h, w in shapes[:i])
                           for i in range(L)], device=dev)[:, None]
    Hi, Wi = Hs.long(), Ws.long()
    x = loc[..., 0] * Ws - 0.5
    y = loc[..., 1] * Hs - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    xl = torch.minimum(x0i.clamp(min=0), Wi - 1)
    yl = torch.minimum(y0i.clamp(min=0), Hi - 1)
    sx, sy = x0i - xl, y0i - yl

    wslot = torch.zeros(B, Q, H, L, P, 4, device=dev)
    d_attn = torch.zeros_like(a)
    d_fx = torch.zeros_like(a)
    d_fy = torch.zeros_like(a)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0i + dx, y0i + dy
            valid = (xi >= 0) & (xi < Wi) & (yi >= 0) & (yi < Hi)
            wy = fy if dy else 1.0 - fy
            wx = fx if dx else 1.0 - fx
            row = torch.where(valid, starts + yi * Wi + xi, 0)
            idx = row.permute(0, 2, 1, 3, 4).reshape(B, H, Q * L * P)
            vc = vh.gather(2, idx[..., None].expand(-1, -1, -1, D))
            vc = vc.reshape(B, H, Q, L, P, D).permute(0, 2, 1, 3, 4, 5)
            dot = (vc * do[:, :, :, None, None, :]).sum(-1) * valid
            d_attn += wy * wx * dot
            d_fx += (wy if dx else -wy) * dot
            d_fy += (wx if dy else -wx) * dot
            # a valid corner's slot is in [0, 4); an invalid one adds 0
            slot = (2 * (sy + dy) + (sx + dx)).clamp(0, 3)
            wslot.scatter_add_(-1, slot[..., None],
                               (a * wy * wx * valid)[..., None])
    d_loc = torch.stack([a * d_fx * Ws, a * d_fy * Hs], -1)
    d_g = (wslot[..., None] * do[:, :, :, None, None, None, :]).to(
        value.dtype)                                      # (B,Q,H,L,P,4,D)
    d_g = d_g.permute(0, 2, 1, 3, 4, 5, 6).reshape(B * H, Q * L * P, 4 * D)
    gidx = (starts + yl * Wi + xl).permute(0, 2, 1, 3, 4).reshape(
        B * H, Q * L * P).int()
    return (d_g, gidx, d_loc.to(sampling_locations.dtype),
            d_attn.to(attention_weights.dtype))


def ms_deform_attn_torch(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``grid_sample`` per level, f32 sums,
    output in value's dtype."""
    shapes = _shapes(spatial_shapes)
    B, Nv, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    v = value.float()
    loc = sampling_locations.float()
    w = attention_weights.float()
    out = None
    start = 0
    for lvl, (h, wd) in enumerate(shapes):
        vl = v[:, start:start + h * wd].permute(0, 2, 3, 1).reshape(
            B * H, D, h, wd)
        grid = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
            B * H, Q, P, 2) * 2 - 1
        s = F.grid_sample(vl, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)            # (B*H, D, Q, P)
        wl = w[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * H, 1, Q, P)
        part = (s * wl).sum(-1)                           # (B*H, D, Q)
        out = part if out is None else out + part
        start += h * wd
    out = out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)
    return out.to(value.dtype)
