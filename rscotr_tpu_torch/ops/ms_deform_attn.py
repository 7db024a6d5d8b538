"""Multi-scale deformable attention sampling core (PyTorch + CUDA kernels
K1 and K1b; K4 / K5 and K3' on the quad-gather path).

Counterpart of rscotr_tpu/ops/ms_deform_attn.py. Sampling semantics match
``F.grid_sample(align_corners=False, padding_mode="zeros")`` on per-level
(H, W) value maps with locations normalized to [0, 1]:
``x_pix = loc_x * W - 0.5``; bilinear corners outside the map contribute
zero.

``ms_deform_attn`` is a ``torch.autograd.Function`` around the operators
``torch.ops.rscotr_torch.msda_fwd`` and ``msda_bwd`` (registered when
``rscotr_tpu_torch.ops`` is imported). For CUDA tensors the forward
launches the hand-written kernel ``csrc/msda_fwd.cu`` (K1; its body picked
by ``msda_fwd_body`` from the head width and the tensors' alignment)
and the backward is one launch of ``csrc/msda_bwd.cu`` (K1b,
``ms_deform_attn_bwd``):
it writes the attention-weight and location gradients and adds every valid
corner's term, the corner weight times ``d_out`` rounded to value's dtype,
straight into a zeroed float32 accumulator of value's layout with atomics;
one cast to value's dtype makes ``d_value``. Under
``torch.use_deterministic_algorithms(True)`` the launch takes its ordered
body instead (``msda_bwd_body`` adds ``ORDERED``): the kernel writes the
attention-weight and location gradients only, and the value gradient is
added row by row in an order that the data fixes (the corners' target rows
as keys, a stable sort, a warp per row; ``_ordered_value_grad``), so two
runs give the same bits. That is the JAX decomposition
(``_quad_gather_bwd`` and ``_corner_weighted_sum_bwd`` of the JAX module)
with its detour taken out: JAX writes each sampling point's quad-row update
``d_g``, scatters the rows into a quad-table gradient (Pallas K3) and folds
the table back to ``d_value``, and each quad slot folds onto the cell of the
one corner that feeds it. ``msda_bwd_body`` picks the kernel's body from the
head width and the tensors' alignment. For CPU tensors the forward is the
plain ``ms_deform_attn_torch`` and the backward the plain decomposition
``ms_deform_attn_bwd_torch`` (``msda_bwd_rows_torch``,
``scatter_add_mm_torch``, the fold), which is K1b's plain version; any
other device raises.

``impl="quad"`` runs the quad-gather formulation instead, the counterpart
of the JAX package's ``_ms_deform_attn_xla`` (its ``impl="xla"``): a quad
table of each level's 2x2 neighbourhoods, one row gather per sampling
point (backward K3', ``ops/scatter_mm.py``, and the fold), and the
corner-weighted sum of ``ops/msda_ws.py`` (K4 forward, K5 backward). The
model's layers call the default, as JAX's pass no ``impl``.

Gradient semantics are JAX autodiff's: ``floor`` has zero gradient, the
corner validity factors are constants, and the gradients come back in the
primal dtypes.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from rscotr_tpu_torch.ops import kernel_lib
from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE, BODY_VEC, ORDERED
from rscotr_tpu_torch.ops.msda_ws import corner_weighted_sum
from rscotr_tpu_torch.ops.scatter_mm import (scatter_add_mm,
                                             scatter_add_mm_torch)


def _shapes(spatial_shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def _flat_shapes(shapes) -> List[int]:
    return [n for s in shapes for n in s]


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat), 2))


@torch.library.custom_op("rscotr_torch::msda_fwd", mutates_args=(),
                         device_types="cpu")
def msda_fwd(value: torch.Tensor, spatial_shapes: List[int],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """K1 as an operator (``torch.ops.rscotr_torch.msda_fwd``), so that a
    ``torch.export`` program holds the kernel and not the plain version:
    the plain version on the CPU, K1 on CUDA (``_ms_deform_attn_cuda``, its
    body picked from the tensors' alignment at run time), the output's shape
    from the fake implementation while tracing. ``spatial_shapes`` is the
    flat [H0, W0, H1, W1, ...]."""
    return ms_deform_attn_torch(value, _pairs(spatial_shapes),
                                sampling_locations,
                                attention_weights).contiguous()


@msda_fwd.register_kernel("cuda")
def _msda_fwd_cuda(value, spatial_shapes, sampling_locations,
                   attention_weights):
    return _ms_deform_attn_cuda(value, _pairs(spatial_shapes),
                                sampling_locations, attention_weights)


@msda_fwd.register_fake
def _msda_fwd_fake(value, spatial_shapes, sampling_locations,
                   attention_weights):
    B, Q = sampling_locations.shape[:2]
    return value.new_empty((B, Q, value.shape[2] * value.shape[3]))


class _MsDeformAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, loc, attn, shapes):
        ctx.shapes = shapes
        ctx.save_for_backward(value, loc, attn)
        return torch.ops.rscotr_torch.msda_fwd(value, _flat_shapes(shapes),
                                               loc, attn)

    @staticmethod
    def backward(ctx, d_out):
        value, loc, attn = ctx.saved_tensors
        d_value, d_loc, d_attn = ms_deform_attn_bwd(
            value, ctx.shapes, loc, attn, d_out.contiguous())
        return d_value, d_loc, d_attn, None


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: str = "kernel") -> torch.Tensor:
    """Multi-scale deformable attention aggregation (differentiable in
    value, sampling_locations and attention_weights).

    Args:
        value: (B, num_value, num_heads, head_dim); num_value = sum(H*W).
        spatial_shapes: ((H, W), ...) per level.
        sampling_locations: (B, num_query, num_heads, num_levels,
            num_points, 2) in [0, 1] per level, (x, y) order; float32.
        attention_weights: (B, num_query, num_heads, num_levels, num_points),
            softmax-normalized over (levels * points).
        impl: ``"kernel"`` (default; the fused K1 forward and K1b
            backward: JAX ``impl="pallas"``) or ``"quad"`` (the quad-gather
            formulation, ``_ms_deform_attn_quad``: JAX ``impl="xla"``).
    Returns:
        (B, num_query, num_heads * head_dim) in value's dtype.
    """
    kernel_lib.refuse_dtensor("ms_deform_attn", value, sampling_locations,
                              attention_weights)
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn: no path for device {value.device}")
    shapes = _shapes(spatial_shapes)
    if impl == "quad":
        return _ms_deform_attn_quad(value, shapes, sampling_locations,
                                    attention_weights)
    if impl != "kernel":
        raise ValueError(f"ms_deform_attn: unknown impl {impl!r} "
                         "('kernel' or 'quad')")
    return _MsDeformAttn.apply(value, sampling_locations, attention_weights,
                               shapes)


ms_deform_attn.launches = 0
ms_deform_attn.vec_launches = 0   # those of them that took the vector body


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


# csrc/msda_fwd.cu and csrc/msda_bwd.cu: the lane-per-channel body, and the
# vector body for the head widths it is instantiated for
VEC_HEAD_DIMS = (16, 32, 64)


def _pick_body(head_dim, data_ptrs) -> int:
    if head_dim in VEC_HEAD_DIMS and not any(p % 16 for p in data_ptrs):
        return BODY_VEC
    return BODY_LANE


def msda_fwd_body(head_dim: int, data_ptrs=()) -> int:
    """Which body of K1 a CUDA launch takes: ``BODY_VEC`` (a lane owns 4
    consecutive channels: 8- or 16-byte corner-row loads and output stores,
    one sampling point per lane group) for a head width in
    ``VEC_HEAD_DIMS`` when every base address in ``data_ptrs`` (value, loc
    and the output) is 16-byte aligned, else ``BODY_LANE`` (a lane per
    channel; any head width up to 128)."""
    return _pick_body(head_dim, data_ptrs)


def _ms_deform_attn_cuda(value, shapes, loc, attn, body=None):
    """Kernel K1 on CUDA tensors -> (B, Q, H * D) in value's dtype.
    ``body``: ``BODY_LANE`` where ``msda_fwd_body`` would pick the vector
    body (for the tools that time the lane body)."""
    B, Nv, H, D, Q, L, P = _check_cuda_args("ms_deform_attn", value, shapes,
                                            loc, attn)
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    body = kernel_lib.take_body("ms_deform_attn", body, msda_fwd_body(
        D, [t.data_ptr() for t in (value, loc, out)]), f"head_dim {D}")
    lib = kernel_lib.load()
    with torch.cuda.device(value.device):
        err = lib.msda_fwd(
            value.data_ptr(), kernel_lib.dtype_code(value, "value"),
            loc.data_ptr(), attn.data_ptr(),
            kernel_lib.dtype_code(attn, "attention_weights"),
            out.data_ptr(), B, Nv, Q, H, D, L, P, _levels_arg(shapes), body,
            kernel_lib.stream_ptr(value.device))
    kernel_lib.check(err, "msda_fwd")
    ms_deform_attn.launches += 1
    ms_deform_attn.vec_launches += body == BODY_VEC
    return out


def msda_bwd_body(head_dim: int, data_ptrs=()) -> int:
    """Which body of K1b a CUDA launch takes: ``BODY_VEC`` (a lane owns 4
    consecutive channels: 8- or 16-byte corner-row loads, one 16-byte vector
    reduction per lane into the value gradient) for a head width in
    ``VEC_HEAD_DIMS`` when every base address in ``data_ptrs`` (value, loc,
    d_out, d_loc and the accumulator) is 16-byte aligned, else ``BODY_LANE``
    (a lane per channel, scalar atomics; any head width up to 128). Plus
    ``ORDERED`` where ``kernel_lib.ordered_sums()`` holds (under
    ``torch.use_deterministic_algorithms(True)``): no atomics, the value gradient from ``_ordered_value_grad``, its walk
    on the same lane or vector layout."""
    return _pick_body(head_dim, data_ptrs) | (
        ORDERED if kernel_lib.ordered_sums() else 0)


def ms_deform_attn_bwd(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor,
                       d_out: torch.Tensor):
    """Gradients of ``ms_deform_attn`` -> (d_value, d_loc, d_attn) in the
    primal dtypes, through the operator ``torch.ops.rscotr_torch.msda_bwd``:
    one launch of K1b on CUDA (``launches`` counts it); the plain
    decomposition (``ms_deform_attn_bwd_torch``) on the CPU."""
    kernel_lib.refuse_dtensor("ms_deform_attn_bwd", value,
                              sampling_locations, attention_weights, d_out)
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn_bwd: no path for device "
                         f"{value.device}")
    return torch.ops.rscotr_torch.msda_bwd(
        value, _flat_shapes(_shapes(spatial_shapes)), sampling_locations,
        attention_weights, d_out)


@torch.library.custom_op("rscotr_torch::msda_bwd", mutates_args=(),
                         device_types="cpu")
def msda_bwd(value: torch.Tensor, spatial_shapes: List[int],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor, d_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1b as an operator (``torch.ops.rscotr_torch.msda_bwd``), so that
    dispatch modes such as ``FlopCounterMode`` see it: the plain
    decomposition on the CPU, one K1b launch on CUDA (``_msda_bwd_cuda``,
    its body picked as before) and the accumulator's cast to value's dtype;
    (d_value, d_loc, d_attn) shaped and typed as value, the locations and
    the weights from the fake implementation. ``spatial_shapes`` is the
    flat [H0, W0, H1, W1, ...]."""
    return ms_deform_attn_bwd_torch(value, _pairs(spatial_shapes),
                                    sampling_locations, attention_weights,
                                    d_out)


@msda_bwd.register_kernel("cuda")
def _msda_bwd_op_cuda(value, spatial_shapes, sampling_locations,
                      attention_weights, d_out):
    acc, d_loc, d_attn = _msda_bwd_cuda(value, _pairs(spatial_shapes),
                                        sampling_locations,
                                        attention_weights, d_out)
    return acc.to(value.dtype), d_loc, d_attn


@msda_bwd.register_fake
def _msda_bwd_fake(value, spatial_shapes, sampling_locations,
                   attention_weights, d_out):
    return (value.new_empty(value.shape),
            sampling_locations.new_empty(sampling_locations.shape),
            attention_weights.new_empty(attention_weights.shape))


ms_deform_attn_bwd.launches = 0
ms_deform_attn_bwd.vec_launches = 0   # those of them that took the vector body
ms_deform_attn_bwd.ordered_launches = 0   # ... and the ordered body


def _msda_bwd_cuda(value, shapes, loc, attn, d_out, acc=None, body=None):
    """Kernel K1b on CUDA tensors -> (the float32 value-gradient accumulator
    (B, Nv, H, D), d_loc, d_attn). ``acc``: an accumulator to add into
    instead of a new zeroed one; ``body``: ``BODY_LANE`` where
    ``msda_bwd_body`` would pick the vector body (both for the tools that
    time the kernel). The vector body is never forced onto tensors that
    ``msda_bwd_body`` refuses it."""
    B, Nv, H, D, Q, L, P = _check_cuda_args(
        "ms_deform_attn_bwd", value, shapes, loc, attn, ("d_out", d_out))
    if tuple(d_out.shape) != (B, Q, H * D) or d_out.dtype != value.dtype:
        raise ValueError(f"ms_deform_attn_bwd: d_out must be {value.dtype} "
                         f"{(B, Q, H * D)}, got {d_out.dtype} "
                         f"{tuple(d_out.shape)}")
    dev = value.device
    d_attn = torch.empty_like(attn)
    d_loc = torch.empty_like(loc)
    if acc is None:
        acc = torch.zeros(value.shape, dtype=torch.float32, device=dev)
    elif acc.shape != value.shape or acc.dtype != torch.float32 or \
            acc.device != dev or not acc.is_contiguous():
        raise ValueError("ms_deform_attn_bwd: acc must be a contiguous "
                         f"float32 {tuple(value.shape)} on {dev}")
    if value.numel() == 0 or attn.numel() == 0:
        return acc, d_loc.zero_(), d_attn.zero_()
    body = kernel_lib.take_body("ms_deform_attn_bwd", body, msda_bwd_body(
        D, [t.data_ptr() for t in (value, loc, d_out, d_loc, acc)]),
        f"head_dim {D}")
    lib = kernel_lib.load()
    with torch.cuda.device(dev):
        err = lib.msda_bwd(
            value.data_ptr(), kernel_lib.dtype_code(value, "value"),
            loc.data_ptr(), attn.data_ptr(),
            kernel_lib.dtype_code(attn, "attention_weights"),
            d_out.data_ptr(), d_attn.data_ptr(), d_loc.data_ptr(),
            acc.data_ptr(), B, Nv, Q, H, D, L, P, _levels_arg(shapes), body,
            kernel_lib.stream_ptr(dev))
        kernel_lib.check(err, "msda_bwd")
        if body & ORDERED:
            _ordered_value_grad(lib, value, shapes, loc, attn, d_out, acc,
                                body)
    ms_deform_attn_bwd.launches += 1
    ms_deform_attn_bwd.vec_launches += bool(body & BODY_VEC)
    ms_deform_attn_bwd.ordered_launches += bool(body & ORDERED)
    return acc, d_loc, d_attn


def _ordered_value_grad(lib, value, shapes, loc, attn, d_out, acc, body):
    """K1b's ordered value gradient, after the body ran with its reduction
    off: ``msda_bwd_keys`` gives each corner of each sampling point its
    target row of ``acc`` (a sentinel off the map), ``torch.sort(stable=
    True)`` orders the corner indices by row (it only orders indices: a
    row's corners stay in (q, l, p, c) order), ``msda_bwd_bounds`` marks
    each row's run and ``msda_bwd_walk`` adds each row's terms, the same
    rounded terms as the atomics, into ``acc`` with one writer per row."""
    B, Nv, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    dev, stream = value.device, kernel_lib.stream_ptr(value.device)
    levels = _levels_arg(shapes)
    keys = torch.empty(B * Q * H * L * P * 4, dtype=torch.int32, device=dev)
    kernel_lib.check(lib.msda_bwd_keys(loc.data_ptr(), B, Nv, Q, H, L, P,
                                       levels, keys.data_ptr(), stream),
                     "msda_bwd_keys")
    sorted_keys, perm = torch.sort(keys, stable=True)
    del keys
    start = torch.zeros(B * Nv * H, dtype=torch.int64, device=dev)
    end = torch.zeros_like(start)
    kernel_lib.check(lib.msda_bwd_bounds(sorted_keys.data_ptr(),
                                         sorted_keys.numel(),
                                         start.data_ptr(), end.data_ptr(),
                                         stream), "msda_bwd_bounds")
    kernel_lib.check(lib.msda_bwd_walk(
        kernel_lib.dtype_code(value, "value"), loc.data_ptr(),
        attn.data_ptr(), kernel_lib.dtype_code(attn, "attention_weights"),
        d_out.data_ptr(), perm.data_ptr(), start.data_ptr(), end.data_ptr(),
        acc.data_ptr(), B, Nv, Q, H, D, L, P, levels, body, stream),
        "msda_bwd_walk")


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
    """Plain PyTorch version of the backward (K1b), as JAX decomposes it:
    ``msda_bwd_rows_torch``, then ``scatter_add_mm_torch``, then the fold.
    Returns (d_value, d_loc, d_attn) in the primal dtypes."""
    shapes = _shapes(spatial_shapes)
    B, Nv, H, D = value.shape
    d_g, gidx, d_loc, d_attn = msda_bwd_rows_torch(
        value, shapes, sampling_locations, attention_weights, d_out)
    d_qt = scatter_add_mm_torch(d_g, gidx, Nv)
    return _fold_quad_grad(d_qt, shapes, B, H, D, value.dtype), d_loc, d_attn


def msda_bwd_rows_torch(value, spatial_shapes, sampling_locations,
                        attention_weights, d_out):
    """The rows of the plain backward: the quad-slot weights as
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


def _quad_table(value, shapes):
    """(B, Nv, H, D) -> (B*H, Nv, 4*D): row (y*W + x) of each level holds
    the 2x2 neighbourhood [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)], zeros
    past the map's edge (pad + four shifted slices concatenated)."""
    B, _, H, D = value.shape
    vh = value.permute(0, 2, 1, 3)                        # (B, H, Nv, D)
    quads, off = [], 0
    for h, w in shapes:
        vp = F.pad(vh[:, :, off:off + h * w].reshape(B, H, h, w, D),
                   (0, 0, 0, 1, 0, 1))
        quads.append(torch.cat([vp[:, :, :h, :w], vp[:, :, :h, 1:],
                                vp[:, :, 1:, :w], vp[:, :, 1:, 1:]],
                               -1).reshape(B * H, h * w, 4 * D))
        off += h * w
    return torch.cat(quads, 1)


class _QuadGather(torch.autograd.Function):
    """One quad-table row per sampling point. Forward: the quad table and a
    plain row gather (JAX gathers with XLA, outside any Pallas kernel).
    Backward: K3' (``scatter_add_mm``, the counterpart of Pallas K3, which
    runs on this path only) scatters the row gradients into the quad-table
    gradient in float32, and ``_fold_quad_grad`` folds it back to d_value,
    as JAX's ``_quad_gather_bwd`` plus the transpose of the table build."""

    @staticmethod
    def forward(ctx, value, gidx, shapes):
        B, Nv, H, D = value.shape
        ctx.meta = (shapes, B, Nv, H, D, value.dtype)
        ctx.save_for_backward(gidx)
        qt = _quad_table(value, shapes).reshape(B * H * Nv, 4 * D)
        base = torch.arange(B * H, device=gidx.device)[:, None] * Nv
        return qt.index_select(0, (gidx.long() + base).reshape(-1))

    @staticmethod
    def backward(ctx, d_g):
        gidx, = ctx.saved_tensors
        shapes, B, Nv, H, D, dtype = ctx.meta
        d_qt = scatter_add_mm(d_g.reshape(B * H, -1, 4 * D).contiguous(),
                              gidx, Nv)
        return _fold_quad_grad(d_qt, shapes, B, H, D, dtype), None, None


def _ms_deform_attn_quad(value, shapes, sampling_locations,
                         attention_weights):
    """Quad-gather formulation, the counterpart of JAX's
    ``_ms_deform_attn_xla``: the clamped start row of each sampling point's
    2x2 neighbourhood, its four corner weights routed to quad slots by the
    same one-hot contraction (so autograd gives JAX's gradients: ``floor``
    has zero gradient, the validity factors are constants), ONE row gather
    per point (``_QuadGather``), then ``corner_weighted_sum`` (K4 / K5)."""
    B, Nv, Hn, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if Nv != sum(h * w for h, w in shapes) or len(shapes) != L:
        raise ValueError(f"ms_deform_attn: value rows {Nv} / levels {L} do "
                         f"not match spatial_shapes {shapes}")
    dev = value.device
    Hs = torch.tensor([h for h, _ in shapes], dtype=torch.float32,
                      device=dev)[:, None]
    Ws = torch.tensor([w for _, w in shapes], dtype=torch.float32,
                      device=dev)[:, None]
    starts = torch.tensor([sum(h * w for h, w in shapes[:i])
                           for i in range(L)], device=dev)[:, None]
    Hi, Wi = Hs.long(), Ws.long()
    x = sampling_locations[..., 0] * Ws - 0.5             # (B, Q, H, L, P)
    y = sampling_locations[..., 1] * Hs - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    xl = torch.minimum(x0i.clamp(min=0), Wi - 1)
    yl = torch.minimum(y0i.clamp(min=0), Hi - 1)
    idx = yl * Wi + xl + starts                           # level-local rows

    aw = attention_weights.float()
    vy0 = ((y0i >= 0) & (y0i < Hi)).float()
    vy1 = ((y0i + 1 >= 0) & (y0i + 1 < Hi)).float()
    vx0 = ((x0i >= 0) & (x0i < Wi)).float()
    vx1 = ((x0i + 1 >= 0) & (x0i + 1 < Wi)).float()
    wy = torch.stack([(1.0 - fy) * vy0, fy * vy1], -1)
    wx = torch.stack([(1.0 - fx) * vx0, fx * vx1], -1)
    # corner axis m = 2*dy + dx; slot of corner m = 2*(dy+sy) + (dx+sx)
    wxy = (wy[..., :, None] * wx[..., None, :]).reshape(
        aw.shape + (4,)) * aw[..., None]                  # (B,Q,H,L,P,4)
    dy_m = torch.tensor([0, 0, 1, 1], device=dev)
    dx_m = torch.tensor([0, 1, 0, 1], device=dev)
    slot = 2 * ((y0i - yl)[..., None] + dy_m) + ((x0i - xl)[..., None] + dx_m)
    # an off-map slot (outside [0, 4)) gets a zero one-hot row, as jax's.
    # The contraction is a broadcast multiply and a sum, not an einsum: on
    # the card einsum lowers it to batched 4x4 gemvs (2.2 ms at the det
    # encoder against ~0.1 ms); each corner has at most one slot, so both
    # give the same bits.
    onehot = (slot[..., None] == torch.arange(4, device=dev)).float()
    wslot = (onehot * wxy[..., None]).sum(-2)

    KP = L * P
    gidx = idx.permute(0, 2, 1, 3, 4).reshape(B * Hn, Q * KP).int()
    g = _QuadGather.apply(value, gidx.contiguous(), shapes)
    g = g.reshape(B, Hn, Q, KP, 4 * D)
    wt = wslot.reshape(B, Q, Hn, KP, 4).permute(0, 2, 1, 3, 4).to(value.dtype)
    out = corner_weighted_sum(g, wt)                      # (B, H, Q, D) f32
    return out.permute(0, 2, 1, 3).reshape(B, Q, Hn * D).to(value.dtype)


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
