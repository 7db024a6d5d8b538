"""Reference point grids (PyTorch counterpart of
rscotr_tpu/ops/point_generator.py: ``single_level_grid_points`` for the
pixel decoders, ``encoder_reference_points`` for the det path)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def single_level_grid_points(h: int, w: int, stride: int,
                             offset: float = 0.5,
                             device=None) -> torch.Tensor:
    """(h*w, 2) un-normalized (x, y) points at pixel centres * stride,
    row-major."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) + offset) * \
        stride
    ys = (torch.arange(h, dtype=torch.float32, device=device) + offset) * \
        stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """
    Args:
        spatial_shapes: ((H, W), ...) per level, high->low resolution.
        valid_ratios: (B, num_levels, 2) valid fraction (w_ratio, h_ratio).
    Returns:
        (B, sum_hw, num_levels, 2) normalized (x, y) in the valid frame.
    """
    dev = valid_ratios.device
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        gy = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        gx = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([gx, gy], dim=-1))        # (B, h*w, 2)
    ref = torch.cat(refs, dim=1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]
