"""MSDA corner-weighted sum and its gradients (PyTorch + CUDA kernels K4,
K5).

Counterpart of rscotr_tpu/ops/pallas/msda_ws.py (``ws_fwd``, ``ws_bwd``)
with the TPU kernels' signatures and layouts: ``g`` (G, Q, KP, 4D) holds
one quad-gathered row of four bilinear corners per sampling point (corner c
in columns [c*D, (c+1)*D)), and the weights travel as (G, Q, 4*KP) with the
corner axis folded c-major, ``wt[..., c*KP + k]``:

    out[g, q, d]         = sum_k sum_c g[g, q, k, c*D+d] * wt[g, q, c*KP+k]
    d_g[g, q, k, c*D+d]  = wt[g, q, c*KP+k] * d_out[g, q, d]
    d_wt[g, q, c*KP+k]   = sum_d g[g, q, k, c*D+d] * d_out[g, q, d]

products and sums in float32. For CUDA tensors ``ws_fwd`` / ``ws_bwd``
launch the hand-written kernels of ``csrc/msda_ws.cu``, each with two
bodies picked by ``ws_fwd_body`` / ``ws_bwd_body`` from the head width, KP
and the tensors' alignment: a vector body (head widths in
``WS_VEC_HEAD_DIMS``; a lane owns 4 consecutive channels, a batch's g loads
issue before the first product) and a lane-per-column body for the rest.
For CPU tensors they run the plain versions ``ws_fwd_torch`` /
``ws_bwd_torch``; any other device raises.

``corner_weighted_sum`` is the ``torch.autograd.Function`` on top, in the
layout of the JAX package's ``_corner_weighted_sum``
(rscotr_tpu/ops/ms_deform_attn.py): g (B, H, Q, KP, 4D), wt (B, H, Q, KP, 4)
-> (B, H, Q, D) float32; forward K4, backward K5, ``d_wt`` returned in wt's
dtype. It is the second half of the quad-gather MSDA
(``ms_deform_attn(..., impl="quad")``). Unlike the JAX forward, which
multiplies ``g * wt`` in g's dtype before its f32 sum, K4 multiplies in f32
(bit-for-bit equal only in float32).
"""

from __future__ import annotations

import torch

from rscotr_tpu_torch.ops import kernel_lib
from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE, BODY_VEC

# csrc/msda_ws.cu: the head widths K4's and K5's vector bodies are
# instantiated for
WS_VEC_HEAD_DIMS = (16, 32, 64)


def _check(name, g, wt, *more):
    if g.dim() != 4 or g.shape[-1] % 4:
        raise ValueError(f"{name}: g must be (G, Q, KP, 4D), got "
                         f"{tuple(g.shape)}")
    G, Q, KP, C4 = g.shape
    if tuple(wt.shape) != (G, Q, 4 * KP):
        raise ValueError(f"{name}: wt must be {(G, Q, 4 * KP)}, got "
                         f"{tuple(wt.shape)}")
    if wt.dtype != g.dtype:
        raise TypeError(f"{name}: wt must have g's dtype {g.dtype}, got "
                        f"{wt.dtype}")
    if 4 * KP > 256 or C4 > 512:
        raise ValueError(f"{name} kernel takes KP <= 64 and D <= 128; got "
                         f"KP={KP}, D={C4 // 4}")
    for arg, t in (("g", g), ("wt", wt)) + more:
        if t.device != g.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on "
                             f"{g.device}")
    return G, Q, KP, C4 // 4


def _dispatch(name, g):
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no path for device {g.device}")
    return g.device.type == "cuda"


def _ws_body(head_dim, kp, data_ptrs):
    """K4's and K5's vector bodies take the same head widths and KP, and
    need every base in ``data_ptrs`` 16-byte aligned."""
    if head_dim in WS_VEC_HEAD_DIMS and kp <= 64 and \
            not any(p % 16 for p in data_ptrs):
        return BODY_VEC
    return BODY_LANE


def ws_fwd_body(head_dim: int, kp: int, data_ptrs=()) -> int:
    """Which body of K4 a CUDA launch takes: ``BODY_VEC`` (a lane owns 4
    consecutive channels: 8- or 16-byte g loads with the streaming hint, a
    batch of them before the first product, the lanes that share channels
    folded by shuffles, one 16-byte store a lane) for a head width in
    ``WS_VEC_HEAD_DIMS`` and KP <= 64 when every base address in
    ``data_ptrs`` (g and out) is 16-byte aligned, else ``BODY_LANE`` (a lane
    per column, weights and corner sums through shared memory; any D <=
    128)."""
    return _ws_body(head_dim, kp, data_ptrs)


def ws_fwd(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Corner-weighted sum, g (G, Q, KP, 4D), wt (G, Q, 4*KP) c-major in
    g's dtype -> (G, Q, D) float32. Kernel K4 on CUDA (``launches`` counts
    it, ``vec_launches`` those that took the vector body)."""
    if not _dispatch("ws_fwd", g):
        return ws_fwd_torch(g, wt)
    return _ws_fwd_cuda(g, wt)


def _ws_fwd_cuda(g, wt, body=None):
    """Kernel K4 on CUDA tensors. ``body``: ``BODY_LANE`` where
    ``ws_fwd_body`` would pick the vector body (for the tools that time the
    lane body); the vector body is never forced where it refuses it."""
    G, Q, KP, D = _check("ws_fwd", g, wt)
    out = torch.empty((G, Q, D), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    body = kernel_lib.take_body("ws_fwd", body, ws_fwd_body(
        D, KP, [g.data_ptr(), out.data_ptr()]), f"D={D}, KP={KP}")
    lib = kernel_lib.load()
    with torch.cuda.device(g.device):
        err = lib.ws_fwd(g.data_ptr(), wt.data_ptr(),
                         kernel_lib.dtype_code(g, "g"), out.data_ptr(),
                         G * Q, KP, D, body, kernel_lib.stream_ptr(g.device))
    kernel_lib.check(err, "ws_fwd")
    ws_fwd.launches += 1
    ws_fwd.vec_launches += body == BODY_VEC
    return out


ws_fwd.launches = 0
ws_fwd.vec_launches = 0


def ws_bwd_body(head_dim: int, kp: int, data_ptrs=()) -> int:
    """Which body of K5 a CUDA launch takes: ``BODY_VEC`` (a lane owns 4
    consecutive channels: 8- or 16-byte g loads and d_g stores, d_wt by a
    reduce-scatter over each corner group) for a head width in
    ``WS_VEC_HEAD_DIMS`` and KP <= 64 when every base address in
    ``data_ptrs`` (g, d_out and d_g) is 16-byte aligned, else ``BODY_LANE``
    (a lane per column, one warp sum per corner and k; any D <= 128)."""
    return _ws_body(head_dim, kp, data_ptrs)


def ws_bwd(g: torch.Tensor, wt: torch.Tensor, d_out: torch.Tensor):
    """Gradients of ``ws_fwd`` -> (d_g (G, Q, KP, 4D) in g's dtype, d_wt
    (G, Q, 4*KP) float32, c-major); d_out (G, Q, D) is taken in float32.
    Kernel K5 on CUDA (``launches`` counts it, ``vec_launches`` those that
    took the vector body)."""
    if not _dispatch("ws_bwd", g):
        return ws_bwd_torch(g, wt, d_out)
    return _ws_bwd_cuda(g, wt, d_out)


def _ws_bwd_cuda(g, wt, d_out, body=None):
    """Kernel K5 on CUDA tensors. ``body``: ``BODY_LANE`` where
    ``ws_bwd_body`` would pick the vector body (for the tools that time the
    lane body); the vector body is never forced where it refuses it."""
    d_out = d_out.float().contiguous()
    G, Q, KP, D = _check("ws_bwd", g, wt, ("d_out", d_out))
    if tuple(d_out.shape) != (G, Q, D):
        raise ValueError(f"ws_bwd: d_out must be {(G, Q, D)}, got "
                         f"{tuple(d_out.shape)}")
    d_g = torch.empty_like(g)
    d_wt = torch.empty((G, Q, 4 * KP), dtype=torch.float32, device=g.device)
    if d_g.numel() == 0:
        return d_g, d_wt
    body = kernel_lib.take_body("ws_bwd", body, ws_bwd_body(
        D, KP, [t.data_ptr() for t in (g, d_out, d_g)]), f"D={D}, KP={KP}")
    lib = kernel_lib.load()
    with torch.cuda.device(g.device):
        err = lib.ws_bwd(g.data_ptr(), wt.data_ptr(),
                         kernel_lib.dtype_code(g, "g"), d_out.data_ptr(),
                         d_g.data_ptr(), d_wt.data_ptr(), G * Q, KP, D, body,
                         kernel_lib.stream_ptr(g.device))
    kernel_lib.check(err, "ws_bwd")
    ws_bwd.launches += 1
    ws_bwd.vec_launches += body == BODY_VEC
    return d_g, d_wt


ws_bwd.launches = 0
ws_bwd.vec_launches = 0


def _split(g, wt):
    """g as (G, Q, KP, 4, D) f32 and wt as (G, Q, KP, 4) f32."""
    G, Q, KP, C4 = g.shape
    g4 = g.float().reshape(G, Q, KP, 4, C4 // 4)
    w = wt.float().reshape(G, Q, 4, KP).transpose(-1, -2)
    return g4, w


def ws_fwd_torch(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4."""
    g4, w = _split(g, wt)
    return (g4 * w[..., None]).sum((2, 3))


def ws_bwd_torch(g: torch.Tensor, wt: torch.Tensor, d_out: torch.Tensor):
    """Plain PyTorch version of K5."""
    G, Q, KP, C4 = g.shape
    g4, w = _split(g, wt)
    do = d_out.float()[:, :, None, None, :]
    d_g = (w[..., None] * do).reshape(G, Q, KP, C4).to(g.dtype)
    d_wt = (g4 * do).sum(-1).transpose(-1, -2).reshape(G, Q, 4 * KP)
    return d_g, d_wt


class _CornerWeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, wt):
        B, H, Q, KP, C4 = g.shape
        g3 = g.reshape(B * H, Q, KP, C4).contiguous()
        wt_cm = wt.transpose(-1, -2).reshape(B * H, Q, 4 * KP).contiguous()
        ctx.save_for_backward(g3, wt_cm)
        ctx.wt_dtype = wt.dtype
        return ws_fwd(g3, wt_cm).reshape(B, H, Q, C4 // 4)

    @staticmethod
    def backward(ctx, d_out):
        g3, wt_cm = ctx.saved_tensors
        B, H, Q, D = d_out.shape
        KP = g3.shape[2]
        d_g, d_wt = ws_bwd(g3, wt_cm, d_out.reshape(B * H, Q, D))
        d_wt = d_wt.reshape(B, H, Q, 4, KP).transpose(-1, -2)
        return (d_g.reshape(B, H, Q, KP, 4 * D),
                d_wt.to(ctx.wt_dtype).contiguous())


def corner_weighted_sum(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """out[b,h,q,d] = sum_k sum_c g[b,h,q,k,c*D+d] * wt[b,h,q,k,c].

    g: (B, H, Q, KP, 4D) quad-gathered rows; wt: (B, H, Q, KP, 4) per
    corner-slot weights. Returns (B, H, Q, D) float32; differentiable in
    both (K4 forward, K5 backward on CUDA)."""
    return _CornerWeightedSum.apply(g, wt)
