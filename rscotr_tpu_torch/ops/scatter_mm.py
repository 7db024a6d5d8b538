"""Grouped scatter-add with f32 accumulation (PyTorch + CUDA kernel K3').

Counterpart of rscotr_tpu/ops/pallas/scatter_mm.py (``scatter_add_mm``, the
Pallas kernel K3, both of its bodies) and of its oracle ``scatter_add_xla``:

    out[g, r, :] = sum over k with idx[g, k] == r of updates[g, k, :]

in float32 whatever the updates' float dtype; an index outside
[0, num_rows) contributes nothing (the one-hot of the Pallas kernel never
matches it, XLA's scatter drops it). It is the MSDA value gradient of the
quad-gather path: the scatter of the per-sampling-point quad-row gradients
into the quad-table gradient (``_QuadGather.backward`` in
rscotr_tpu_torch/ops/ms_deform_attn.py; the default path's backward kernel
adds each corner's term to the value gradient itself). The TPU tiling
arguments (``nv_block``, ``k_block``, ``gate_dma``, ``acc_dtype``) have no
counterpart: the card's atomics work per update.

``scatter_add_mm`` launches the hand-written kernel ``csrc/scatter_add.cu``
for CUDA tensors and runs the plain version ``scatter_add_mm_torch`` for CPU
tensors; any other device raises.
"""

from __future__ import annotations

import torch

from rscotr_tpu_torch.ops import kernel_lib


def scatter_add_mm(updates: torch.Tensor, idx: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """updates (G, K, C) float; idx (G, K) int32 row targets ->
    (G, num_rows, C) float32."""
    if updates.device.type == "cpu":
        return scatter_add_mm_torch(updates, idx, num_rows)
    if updates.device.type != "cuda":
        raise ValueError(f"scatter_add_mm: no path for device "
                         f"{updates.device}")
    G, K, C = updates.shape
    if tuple(idx.shape) != (G, K) or idx.dtype != torch.int32:
        raise ValueError(f"scatter_add_mm: idx must be int32 {(G, K)}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    for name, t in (("updates", updates), ("idx", idx)):
        if t.device != updates.device or not t.is_contiguous():
            raise ValueError(f"scatter_add_mm: {name} must be contiguous on "
                             f"{updates.device}")
    out = torch.zeros((G, num_rows, C), dtype=torch.float32,
                      device=updates.device)
    if updates.numel() == 0 or out.numel() == 0:
        return out
    lib = kernel_lib.load()
    with torch.cuda.device(updates.device):
        err = lib.scatter_add(
            updates.data_ptr(), kernel_lib.dtype_code(updates, "updates"),
            idx.data_ptr(), out.data_ptr(), G, K, C, num_rows,
            kernel_lib.stream_ptr(updates.device))
    kernel_lib.check(err, "scatter_add")
    scatter_add_mm.launches += 1
    return out


scatter_add_mm.launches = 0


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
