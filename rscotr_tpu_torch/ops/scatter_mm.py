"""Grouped scatter-add with f32 accumulation (PyTorch + CUDA kernel K3').

Counterpart of rscotr_tpu/ops/pallas/scatter_mm.py (``scatter_add_mm``, the
Pallas kernel K3, both of its bodies) and of its oracle ``scatter_add_xla``:

    out[g, r, :] = sum over k with idx[g, k] == r of updates[g, k, :]

in float32 whatever the updates' float dtype; an index outside
[0, num_rows) contributes nothing (the one-hot of the Pallas kernel never
matches it; the JAX oracle ``scatter_add_xla`` drops an index >= num_rows
too, but wraps a negative one as numpy indexing does, and no caller passes
one). It is the MSDA value gradient of the quad-gather path: the scatter of
the per-sampling-point quad-row gradients into the quad-table gradient
(``_QuadGather.backward`` in rscotr_tpu_torch/ops/ms_deform_attn.py; the
default path's backward kernel adds each corner's term to the value
gradient itself). The TPU tiling arguments (``nv_block``, ``k_block``,
``gate_dma``, ``acc_dtype``) have no counterpart: the card's atomics work
per update.

``scatter_add_mm`` launches the hand-written kernel ``csrc/scatter_add.cu``
for CUDA tensors (its body picked by ``scatter_add_body`` from the width and
the tensors' alignment) and runs the plain version ``scatter_add_mm_torch``
for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from rscotr_tpu_torch.ops import kernel_lib
from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE, BODY_VEC

# csrc/scatter_add.cu: the vector body's offsets are 32-bit
SA_VEC_MAX_ELEMENTS = 1 << 30


def scatter_add_body(channels: int, data_ptrs=(), elements: int = 0) -> int:
    """Which body of K3' a CUDA launch takes: ``BODY_VEC`` (a lane owns 4
    consecutive channels: one 8- or 16-byte load and one 16-byte vector
    reduction per lane and update row) when ``channels`` % 4 == 0, the
    updates' ``elements`` (G * K * C) are fewer than ``SA_VEC_MAX_ELEMENTS``
    and every base address in ``data_ptrs`` (updates and the output) is
    16-byte aligned, else ``BODY_LANE`` (a lane per channel, scalar
    atomics)."""
    if channels % 4 == 0 and elements < SA_VEC_MAX_ELEMENTS and \
            not any(p % 16 for p in data_ptrs):
        return BODY_VEC
    return BODY_LANE


def scatter_add_mm(updates: torch.Tensor, idx: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """updates (G, K, C) float; idx (G, K) int32 row targets ->
    (G, num_rows, C) float32. Kernel K3' on CUDA (``launches`` counts it,
    ``vec_launches`` those that took the vector body)."""
    if updates.device.type == "cpu":
        return scatter_add_mm_torch(updates, idx, num_rows)
    if updates.device.type != "cuda":
        raise ValueError(f"scatter_add_mm: no path for device "
                         f"{updates.device}")
    G, K, C = updates.shape
    out = torch.zeros((G, num_rows, C), dtype=torch.float32,
                      device=updates.device)
    return _scatter_add_cuda(updates, idx, out)


def _scatter_add_cuda(updates, idx, out, body=None):
    """Kernel K3' on CUDA tensors: adds into ``out`` (G, num_rows, C)
    float32, zeroed by the caller, and returns it (the tools time the launch
    alone this way). ``body``: ``BODY_LANE`` where ``scatter_add_body``
    would pick the vector body; the vector body is never forced where it
    refuses it."""
    G, K, C = updates.shape
    num_rows = out.shape[1]
    if tuple(idx.shape) != (G, K) or idx.dtype != torch.int32:
        raise ValueError(f"scatter_add_mm: idx must be int32 {(G, K)}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if out.dim() != 3 or (out.shape[0], out.shape[2]) != (G, C) or \
            out.dtype != torch.float32:
        raise ValueError(f"scatter_add_mm: out must be float32 (G, rows, C) "
                         f"= ({G}, rows, {C}), got {out.dtype} "
                         f"{tuple(out.shape)}")
    for name, t in (("updates", updates), ("idx", idx), ("out", out)):
        if t.device != updates.device or not t.is_contiguous():
            raise ValueError(f"scatter_add_mm: {name} must be contiguous on "
                             f"{updates.device}")
    if updates.numel() == 0 or out.numel() == 0:
        return out
    body = kernel_lib.take_body("scatter_add_mm", body, scatter_add_body(
        C, [updates.data_ptr(), out.data_ptr()], updates.numel()), f"C={C}")
    kernel_lib.refuse_nondeterministic("scatter_add_mm (K3')")
    lib = kernel_lib.load()
    with torch.cuda.device(updates.device):
        err = lib.scatter_add(
            updates.data_ptr(), kernel_lib.dtype_code(updates, "updates"),
            idx.data_ptr(), out.data_ptr(), G, K, C, num_rows, body,
            kernel_lib.stream_ptr(updates.device))
    kernel_lib.check(err, "scatter_add")
    scatter_add_mm.launches += 1
    scatter_add_mm.vec_launches += body == BODY_VEC
    return out


scatter_add_mm.launches = 0
scatter_add_mm.vec_launches = 0


def scatter_add_mm_torch(updates: torch.Tensor, idx: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K3': ``scatter_add_`` in float32, out-of-
    range indices dropped."""
    G, K, C = updates.shape
    idx = idx.long()
    valid = (idx >= 0) & (idx < num_rows)
    u = updates.float() * valid[..., None]
    out = torch.zeros((G, num_rows, C), dtype=torch.float32,
                      device=updates.device)
    safe = torch.where(valid, idx, 0)[..., None].expand(G, K, C)
    return out.scatter_add_(1, safe, u)
