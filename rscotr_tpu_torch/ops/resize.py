"""Antialiased bilinear resizing as two matrix products, the port's
deterministic formulation of ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)``.

On the card ``torch.use_deterministic_algorithms(True)`` refuses the
backward of ``F.interpolate``'s antialiased bilinear mode (it adds into
the input's gradient with atomics: ``upsample_bilinear2d_aa_backward``,
torch 2.11), which the seg loss's ``engine.infer.resize_linear`` takes
where an axis shrinks. ``resize_matmul`` computes the same function as a
product with one weight matrix per axis (``linear_weights``), whose
backward is two more products: the same answer to float32 rounding, and
the same bits on every run. ``resize_linear`` takes it under the flag
(``torch.are_deterministic_algorithms_enabled()``) and ``F.interpolate``
otherwise. The plain bilinear backward (no antialiasing) is not refused,
so the other resizes keep ``F.interpolate``.
"""

from __future__ import annotations

import torch


def linear_weights(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """(out_size, in_size) float32 on ``device``: row i holds the weights
    of output pixel i over the input pixels, as ``F.interpolate``'s
    antialiased bilinear mode with ``align_corners=False`` takes them. The
    triangle kernel at half-pixel centres (output i's centre at (i + 0.5) *
    in / out), widened by in / out where the axis shrinks, normalised per
    row; the normalisation is what clamps at the edges. Built on the device
    (no copy from the host inside a step)."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    centre = (torch.arange(out_size, dtype=torch.float64, device=device)
              + 0.5) * scale
    pixel = torch.arange(in_size, dtype=torch.float64, device=device) + 0.5
    w = (1.0 - (pixel[None, :] - centre[:, None]).abs() / support).clamp(
        min=0.0)
    return (w / w.sum(1, keepdim=True)).to(torch.float32)


def resize_matmul(x: torch.Tensor, hw) -> torch.Tensor:
    """``F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
    antialias=True)`` of a float32 NCHW ``x`` as ``Wh @ x @ Ww^T``."""
    wh = linear_weights(x.shape[-2], int(hw[0]), x.device)
    ww = linear_weights(x.shape[-1], int(hw[1]), x.device)
    return torch.matmul(torch.matmul(wh, x), ww.t())
