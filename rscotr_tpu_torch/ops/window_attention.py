"""Swin window attention core (PyTorch + CUDA kernels K2 and K2b).

Counterpart of rscotr_tpu/ops/pallas/window_attention.py
(``window_attention_fused``) with its signature and layouts, and of the
einsum path in rscotr_tpu/models/backbones/swin.py, which is what JAX trains
through. ``window_attention`` is a ``torch.autograd.Function`` with
gradients for q, k, v and rel_bias (summed over images and windows, in
float32); the shift mask is a constant. Its forward and backward are the
operators ``torch.ops.rscotr_torch.window_attn_fwd`` and
``window_attn_bwd`` (registered when ``rscotr_tpu_torch.ops`` is
imported). For CUDA tensors the forward
launches the hand-written kernel ``csrc/window_attn.cu`` (K2) and the
backward ``csrc/window_attn_bwd.cu`` (K2b); for CPU tensors they are the
plain versions ``window_attention_torch`` and ``window_attention_bwd_torch``;
any other device raises.

Arithmetic. Scores, softmax, row sums and d_rel_bias are float32 and the
scale multiplies the float32 product q k^T. With float32 inputs everything
else is float32 too. With bfloat16 inputs the kernels put every product on
the tensor cores (bf16 operands, float32 accumulation), as the Pallas body
does, so P is rounded to bf16 before P v (and before P^T dO), and dS before
dS k and dS^T q; the plain versions round at the same places.

Each kernel has two instantiations behind its one entry point, and
``tensor_core_plan`` picks: bf16 with n <= 64, head width 32 or 64 and
16-byte aligned bases and strides takes the tensor-core kernel, in which a
block walks a run of consecutive windows of one head; float32 inputs, and
bf16 inputs outside those shapes, take the CUDA-core kernel (one block per
window and head, float32 arithmetic on operands staged as float32). K2 has
a third: bf16 with 64 < n <= 144 (windows 9 to 12) at head width 32 and the
same alignment takes the long-window tensor-core kernel, in which a block
stages one head's bias plus one window's mask once and walks a run of
images of that window. ``launches`` counts every launch, ``tc_launches``
the tensor-core ones (both kinds) and ``tc144_launches`` the long-window
ones; K2b has no long-window body.

Attention dropout (Swin's ``attn_drop_rate`` in training; JAX's unfused
path, rscotr_tpu/models/backbones/swin.py): with ``dropout_p`` > 0 the
probabilities P become P' = P keep / (1 - p) before P v, as flax's
``nn.Dropout`` scales them; p = 1 gives zeros. The keep bits are
``ops.philox.keep_mask`` of the (B, nW, H, n, n) probabilities under the
call's ``seed``: K2 and K2b regenerate them in the kernel (their DROP
instantiations, picked at launch), the plain versions with torch integer
ops, so the two keep the same elements. Rate 0 (eval mode, and every config
of configs/) launches the bodies without dropout.

K2b sums d_rel_bias over images and windows in float32 with atomics, in an
order that changes from run to run. Under
``torch.use_deterministic_algorithms(True)`` it takes its ordered body
(``bias_partials``): each block writes its partial sum to a buffer of its
own and a second launch adds the buffer in block order, so two runs give
the same bits. ``ordered_launches`` counts those launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rscotr_tpu_torch.ops import kernel_lib, philox


@torch.library.custom_op("rscotr_torch::window_attn_fwd", mutates_args=(),
                         device_types="cpu")
def window_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rel_bias: torch.Tensor, shift_mask: Optional[torch.Tensor],
                    scale: float, dropout_p: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """K2 as an operator (``torch.ops.rscotr_torch.window_attn_fwd``), so
    that a ``torch.export`` program holds the kernel and not the plain
    version: the plain version on the CPU, K2 on CUDA
    (``_window_attention_cuda``, its instantiation planned from the
    tensors' strides and alignment at run time), a contiguous (B, nW, H, n,
    hd) output in q's dtype from the fake implementation while tracing.
    ``dropout_p`` / ``seed``: the attention dropout (0: none)."""
    return window_attention_torch(q, k, v, rel_bias, shift_mask, scale,
                                  dropout_p, seed).contiguous()


@window_attn_fwd.register_kernel("cuda")
def _window_attn_fwd_cuda(q, k, v, rel_bias, shift_mask, scale,
                          dropout_p=0.0, seed=0):
    return _window_attention_cuda(q, k, v, rel_bias, shift_mask, scale,
                                  dropout_p, seed)


@window_attn_fwd.register_fake
def _window_attn_fwd_fake(q, k, v, rel_bias, shift_mask, scale,
                          dropout_p=0.0, seed=0):
    return q.new_empty(q.shape)


def _dropout_args(dropout_p: float, seed: int) -> tuple:
    """The operators' trailing arguments: none at rate 0, so that a call
    without dropout (and an exported program) is what it was."""
    return (float(dropout_p), int(seed)) if dropout_p else ()


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_bias, shift_mask, scale, dropout_p, seed):
        ctx.scale, ctx.dropout_p, ctx.seed = scale, dropout_p, seed
        ctx.save_for_backward(q, k, v, rel_bias, shift_mask)
        return torch.ops.rscotr_torch.window_attn_fwd(
            q, k, v, rel_bias, shift_mask, scale,
            *_dropout_args(dropout_p, seed))

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, rel_bias, shift_mask = ctx.saved_tensors
        dq, dk, dv, d_bias = window_attention_bwd(
            q, k, v, rel_bias, shift_mask, ctx.scale, d_out.contiguous(),
            ctx.dropout_p, ctx.seed)
        return dq, dk, dv, d_bias, None, None, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_bias: torch.Tensor,
                     shift_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None, dropout_p: float = 0.0,
                     seed: int = 0) -> torch.Tensor:
    """softmax(scale * q k^T + rel_bias[h] + shift_mask[w]) v, with the
    probabilities dropped at rate ``dropout_p`` under the key ``seed``
    (``ops.philox``) before the product with v.

    Args:
        q, k, v: (B, nW, H, n, hd) per (image, window, head) tiles; may be
            strided views (channel stride 1).
        rel_bias: (H, n, n) float32 relative-position bias.
        shift_mask: (nW, n, n) float32 additive mask or None.
        dropout_p: attention dropout rate in [0, 1] (0: none).
        seed: the Philox key of this call (``philox.draw_seed``).
    Returns:
        (B, nW, H, n, hd) contiguous, in q's dtype.
    """
    kernel_lib.refuse_dtensor("window_attention", q, k, v, rel_bias,
                              shift_mask)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: no path for device {q.device}")
    philox.keep_threshold(dropout_p)   # raises outside [0, 1]
    return _WindowAttention.apply(q, k, v, rel_bias, shift_mask, float(scale),
                                  float(dropout_p), int(seed))


window_attention.launches = 0
window_attention.tc_launches = 0
window_attention.tc144_launches = 0

# shared-memory ceiling of one block on Hopper (227 KB)
_MAX_SMEM = 232448

# the tensor-core instantiations (csrc/window_attn_tc.cuh): tiles padded to
# 64 tokens, head widths compiled, 16-byte cp.async rows
TC_MAX_TOKENS = 64
TC_HEAD_DIMS = (32, 64)
# What bounds the blocks resident on one SM: the registers (128 threads a
# block; K2 128 a thread, K2b 182, as ptxas reports for head width 32, which
# every flagship stage runs) and the shared memory of a Hopper SM (228 KB,
# 1 KB of it reserved per block). The longest run of windows a block walks.
TC_REG_BLOCKS_PER_SM = {"fwd": 4, "bwd": 2}
_SM_SMEM = 233472
TC_MAX_RUN = 32
# the SM count of an H100 SXM: what ``tensor_core_plan`` assumes when it is
# not told the device's (the wrappers read it from the device)
H100_SM_COUNT = 132
# K2's long-window instantiation (csrc/window_attn.cu): tiles padded to 144
# tokens, head width 32; its registers (the scores and the bias + mask of
# 144 keys a thread row) hold one block of 288 threads an SM, and a run of
# images is cut so that the blocks fill the SMs this many times
TC144_MAX_TOKENS = 144
TC144_HEAD_DIMS = (32,)
TC144_WAVES = 4


def tc_smem_bytes(kind: str, n: int, hd: int, masked: bool) -> int:
    """Dynamic shared memory of one tensor-core block, as ``launch_tc`` in
    csrc/window_attn.cu and csrc/window_attn_bwd.cu sizes it: two stages of
    q, k, v (and dO) tiles of 64 x (hd + 8) bf16, K2b's P and dS tiles of
    64 x 72 bf16, two stages of the f32 mask tile."""
    tiles = 2 * (3 if kind == "fwd" else 4) * 64 * (hd + 8)
    if kind == "bwd":
        tiles += 2 * 64 * 72
    stage = (n * n + 6) // 4 * 4 + 64
    return 2 * tiles + (2 * 4 * stage if masked else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tensor_core_plan(kind: str, dtype: torch.dtype, shape, strides,
                     data_ptrs, masked: bool = True,
                     sm_count: int = H100_SM_COUNT) -> int:
    """Which instantiation a CUDA launch takes, from what the kernel is
    given: 0 for the CUDA-core kernel, else the tensor-core kernel with the
    returned number of consecutive (image * window) tiles per block.

    ``kind`` "fwd" (K2) or "bwd" (K2b); ``shape`` (B, nW, H, n, hd);
    ``strides`` the (image * window, head, token) element strides of q, k,
    v in turn; ``data_ptrs`` the base addresses of q, k, v (and d_out, and
    the shift mask, where given), which the 16-byte copies need aligned;
    ``masked`` whether a shift mask is staged; ``sm_count`` the device's
    SMs. The run length spreads the B * nW * H tiles over the blocks the
    card holds at once, so that a block loads its bias fragment once (K2)
    and adds its share of d_rel_bias once (K2b): blocks per head fall from
    B * nW to ceil(B * nW / run)."""
    B, nW, H, n, hd = shape
    if dtype != torch.bfloat16 or H > 65535 or \
            any(s % 8 for s in strides) or any(p % 16 for p in data_ptrs):
        return 0
    if n > TC_MAX_TOKENS:
        return _tc144_run(kind, B, nW, H, n, hd, sm_count)
    if hd not in TC_HEAD_DIMS:
        return 0
    resident = min(TC_REG_BLOCKS_PER_SM[kind],
                   _SM_SMEM // (tc_smem_bytes(kind, n, hd, masked) + 1024))
    slots = sm_count * resident
    return max(1, min(TC_MAX_RUN, -(-B * nW * H // slots)))


def _tc144_run(kind, B, nW, H, n, hd, sm_count) -> int:
    """K2's long-window plan: 0 where it does not apply (K2b, n > 144,
    head widths other than 32), else the images a block walks for its one
    (window, head): all B where the nW * H pairs fill the SMs
    ``TC144_WAVES`` times, else B cut into as many runs as that takes."""
    if kind != "fwd" or n > TC144_MAX_TOKENS or hd not in TC144_HEAD_DIMS:
        return 0
    runs = min(B, max(1, -(-TC144_WAVES * sm_count // (nW * H))))
    return -(-B // runs)


def _check_smem(name, n, hd, smem):
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: n={n}, hd={hd} needs {smem} B of shared "
                         "memory per block")


def _check_cuda_args(name, q, k, v, rel_bias, shift_mask):
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
    return strides


def _kernel_dropout(dropout_p: float, seed: int) -> tuple:
    """(seed as 64 bits, keep threshold, 1 / (1 - p)) for the C entries;
    a threshold of 0 takes the bodies without dropout."""
    thr = philox.keep_threshold(dropout_p)
    if thr == 0:
        return 0, 0, 0.0
    return int(seed) & 0xFFFFFFFFFFFFFFFF, thr, philox.keep_scale(dropout_p)


def _window_attention_cuda(q, k, v, rel_bias, shift_mask, scale,
                           dropout_p=0.0, seed=0, run=None):
    """K2 on CUDA tensors; ``run`` 0 forces the CUDA-core instantiation
    (the kernel checks compare the bodies on the same tensors), None
    takes ``tensor_core_plan``'s."""
    B, nW, H, n, hd = q.shape
    st = _check_cuda_args("window_attention", q, k, v, rel_bias, shift_mask)
    if run is None:
        run = tensor_core_plan(
            "fwd", q.dtype, q.shape, st,
            [t.data_ptr() for t in (q, k, v, shift_mask) if t is not None],
            shift_mask is not None, _sm_count(q.device))
    if run == 0:
        _check_smem("window_attention", n, hd,
                    4 * (3 * n * hd + n + n * n + 4 * n))
    st = (ctypes.c_longlong * 9)(*st)
    out = torch.empty((B, nW, H, n, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = kernel_lib.load()
    with torch.cuda.device(q.device):
        err = lib.window_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kernel_lib.dtype_code(q, "q"), st, rel_bias.data_ptr(),
            shift_mask.data_ptr() if shift_mask is not None else None,
            out.data_ptr(), B * nW, H, nW, n, hd, scale, run,
            *_kernel_dropout(dropout_p, seed),
            kernel_lib.stream_ptr(q.device))
    kernel_lib.check(err, "window_attn_fwd")
    window_attention.launches += 1
    window_attention.tc_launches += bool(run)
    window_attention.tc144_launches += bool(run) and n > TC_MAX_TOKENS
    return out


def window_attention_bwd(q, k, v, rel_bias, shift_mask, scale, d_out,
                         dropout_p: float = 0.0, seed: int = 0):
    """Gradients of ``window_attention`` (with the forward's ``dropout_p``
    and ``seed``) -> (dq, dk, dv in q's dtype, d_rel_bias float32), through
    the operator ``torch.ops.rscotr_torch.window_attn_bwd``: kernel K2b on
    CUDA (``launches`` counts it), the plain version on the CPU."""
    kernel_lib.refuse_dtensor("window_attention_bwd", q, k, v, rel_bias,
                              shift_mask, d_out)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention_bwd: no path for device "
                         f"{q.device}")
    return torch.ops.rscotr_torch.window_attn_bwd(
        q, k, v, rel_bias, shift_mask, float(scale), d_out,
        *_dropout_args(dropout_p, seed))


@torch.library.custom_op("rscotr_torch::window_attn_bwd", mutates_args=(),
                         device_types="cpu")
def window_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rel_bias: torch.Tensor, shift_mask: Optional[torch.Tensor],
                    scale: float, d_out: torch.Tensor, dropout_p: float = 0.0,
                    seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """K2b as an operator (``torch.ops.rscotr_torch.window_attn_bwd``), so
    that dispatch modes such as ``FlopCounterMode`` see it: the plain
    version on the CPU, K2b on CUDA (``_window_attention_bwd_cuda``, its
    instantiation planned at run time as before), contiguous (dq, dk, dv)
    in q's dtype and a float32 (H, n, n) d_rel_bias from the fake
    implementation."""
    return tuple(t.contiguous() for t in window_attention_bwd_torch(
        q, k, v, rel_bias, shift_mask, scale, d_out, dropout_p, seed))


@window_attn_bwd.register_kernel("cuda")
def _window_attn_bwd_cuda(q, k, v, rel_bias, shift_mask, scale, d_out,
                          dropout_p=0.0, seed=0):
    return _window_attention_bwd_cuda(q, k, v, rel_bias, shift_mask, scale,
                                      d_out, dropout_p, seed)


@window_attn_bwd.register_fake
def _window_attn_bwd_fake(q, k, v, rel_bias, shift_mask, scale, d_out,
                          dropout_p=0.0, seed=0):
    H, n = q.shape[2], q.shape[3]
    return (q.new_empty(q.shape), q.new_empty(q.shape), q.new_empty(q.shape),
            q.new_empty((H, n, n), dtype=torch.float32))


def bias_partials(shape, run: int) -> int:
    """How K2b sums d_rel_bias: 0 for today's f32 atomics, else (the
    ordered body, where ``kernel_lib.ordered_sums()`` holds) the
    number of partial sums per head that the second launch adds in block
    order: one per block, ceil(B * nW / run) blocks per head for the
    tensor-core instantiation (``run`` from ``tensor_core_plan``) and B * nW
    for the CUDA-core one (``run`` 0)."""
    if not kernel_lib.ordered_sums():
        return 0
    B, nW = shape[:2]
    return -(-B * nW // run) if run else B * nW


def _window_attention_bwd_cuda(q, k, v, rel_bias, shift_mask, scale, d_out,
                               dropout_p=0.0, seed=0):
    """Kernel K2b on CUDA tensors."""
    B, nW, H, n, hd = q.shape
    st = _check_cuda_args("window_attention_bwd", q, k, v, rel_bias,
                          shift_mask)
    if tuple(d_out.shape) != tuple(q.shape) or d_out.dtype != q.dtype or \
            d_out.device != q.device or not d_out.is_contiguous():
        raise ValueError("window_attention_bwd: d_out must be contiguous "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}")
    run = tensor_core_plan(
        "bwd", q.dtype, q.shape, st,
        [t.data_ptr() for t in (q, k, v, d_out, shift_mask)
         if t is not None], shift_mask is not None, _sm_count(q.device))
    if run == 0:
        _check_smem("window_attention_bwd", n, hd,
                    4 * (2 * n * hd + 2 * n * (hd + 1) + 3 * n * n))
    st = (ctypes.c_longlong * 9)(*st)
    dq, dk, dv = (torch.empty((B, nW, H, n, hd), dtype=q.dtype,
                              device=q.device) for _ in range(3))
    d_bias = torch.zeros((H, n, n), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, dk, dv, d_bias
    nblk = bias_partials(q.shape, run)
    partials = torch.empty((nblk, H, n, n), dtype=torch.float32,
                           device=q.device) if nblk else None
    lib = kernel_lib.load()
    with torch.cuda.device(q.device):
        err = lib.window_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kernel_lib.dtype_code(q, "q"), st, rel_bias.data_ptr(),
            shift_mask.data_ptr() if shift_mask is not None else None,
            d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            d_bias.data_ptr(), B * nW, H, nW, n, hd, float(scale), run,
            partials.data_ptr() if nblk else None,
            *_kernel_dropout(dropout_p, seed),
            kernel_lib.stream_ptr(q.device))
    kernel_lib.check(err, "window_attn_bwd")
    window_attention_bwd.launches += 1
    window_attention_bwd.tc_launches += bool(run)
    window_attention_bwd.ordered_launches += bool(nblk)
    return dq, dk, dv, d_bias


window_attention_bwd.launches = 0
window_attention_bwd.tc_launches = 0
window_attention_bwd.ordered_launches = 0


def _probs(q, k, rel_bias, shift_mask, scale):
    s = torch.einsum("bwhqd,bwhkd->bwhqk", q.float() * scale, k.float())
    s = s + rel_bias.float()[None, None]
    if shift_mask is not None:
        s = s + shift_mask.float()[None, :, None]
    return torch.softmax(s, dim=-1)


def _dropout_factor(shape, dropout_p: float, seed: int,
                    device) -> Optional[torch.Tensor]:
    """keep / (1 - p) in float32 over the (B, nW, H, n, n) probabilities
    (the kernels' bits, ``philox.keep_mask``), None at rate 0."""
    if not dropout_p:
        return None
    keep = philox.keep_mask(shape, dropout_p, seed, device)
    return keep.float() * philox.keep_scale(dropout_p)


def _as_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (float32) as the kernels feed it to a product: rounded to
    ``dtype`` when that is bf16, untouched for float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def window_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rel_bias: torch.Tensor,
                               shift_mask: Optional[torch.Tensor],
                               scale: float, d_out: torch.Tensor,
                               dropout_p: float = 0.0, seed: int = 0):
    """Plain PyTorch version of K2b, f32 sums throughout: with P' = P M
    (M = keep / (1 - p) under dropout, else 1), dV = P'^T dO,
    dP = (dO V^T) M, dS = P (dP - rowsum(dO O)), dQ = scale dS K,
    dK = scale dS^T Q, d_rel_bias = sum of dS over images and windows.
    O = P' V is recomputed in f32. For bf16 inputs P' and dS are rounded to
    bf16 as operands of dV, dQ and dK, where the kernel rounds them."""
    p = _probs(q, k, rel_bias, shift_mask, scale)
    m = _dropout_factor(p.shape, dropout_p, seed, p.device)
    pd = p if m is None else p * m
    vf, do = v.float(), d_out.float()
    o = torch.einsum("bwhqk,bwhkd->bwhqd", pd, vf)
    dv = torch.einsum("bwhqk,bwhqd->bwhkd", _as_operand(pd, q.dtype), do)
    dp = torch.einsum("bwhqd,bwhkd->bwhqk", do, vf)
    if m is not None:
        dp = dp * m
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    ds_op = _as_operand(ds, q.dtype)
    dq = torch.einsum("bwhqk,bwhkd->bwhqd", ds_op, k.float()) * scale
    dk = torch.einsum("bwhqk,bwhqd->bwhkd", ds_op, q.float()) * scale
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype),
            ds.sum((0, 1)))


def window_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_bias: torch.Tensor,
                           shift_mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           dropout_p: float = 0.0,
                           seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K2 (the einsum path of the JAX Swin block):
    f32 scores and softmax, then P' = P keep / (1 - p) under dropout,
    output in q's dtype. For bf16 inputs P' is rounded to bf16 before
    P' v, as the kernel and the Pallas body do."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = _probs(q, k, rel_bias, shift_mask, scale)
    m = _dropout_factor(p.shape, dropout_p, seed, p.device)
    p = _as_operand(p if m is None else p * m, q.dtype)
    return torch.einsum("bwhqk,bwhkd->bwhqd", p, v.float()).to(q.dtype)
