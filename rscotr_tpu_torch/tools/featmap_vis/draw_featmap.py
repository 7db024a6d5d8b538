"""Feature-map heatmap renderer (the port's copy of the root
``tools/featmap_vis/draw_featmap.py``, pixel for pixel): blend per-channel
or channel-reduced activation heatmaps onto the source image, optionally
arranging the top-k channels into one montage. numpy and PIL only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _jet(c: np.ndarray) -> np.ndarray:
    """Simple jet-like colormap for a [0,1] map -> (H, W, 3) float."""
    r = np.clip(1.5 - np.abs(4 * c - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * c - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * c - 1), 0, 1)
    return np.stack([r, g, b], -1) * 255.0


def _blend_one(channel: np.ndarray, img: np.ndarray,
               alpha: float) -> np.ndarray:
    from PIL import Image

    c = channel - channel.min()
    c = c / max(float(c.max()), 1e-6)
    heat = _jet(c)
    heat_im = Image.fromarray(heat.astype(np.uint8)).resize(
        (img.shape[1], img.shape[0]), Image.BILINEAR)
    out = np.asarray(heat_im, np.float32) * alpha + img * (1 - alpha)
    return np.clip(out, 0, 255).astype(np.uint8)


def _montage(tiles: List[np.ndarray], arrangement=None) -> np.ndarray:
    n = len(tiles)
    if arrangement is None:
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
    else:
        rows, cols = arrangement
    h, w, _ = tiles[0].shape
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, t in enumerate(tiles):
        r, c = i // cols, i % cols
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = t
    return grid


def draw_featmap(featmap: np.ndarray,
                 overlaid_image: Optional[np.ndarray] = None,
                 channel_reduction: Optional[str] = "squeeze_mean",
                 topk: int = 20,
                 arrangement=(4, 5),
                 alpha: float = 0.5) -> np.ndarray:
    """
    Args:
        featmap: (H', W', C) activation map.
        overlaid_image: (H, W, 3) uint8-range image; zeros if None.
        channel_reduction: 'squeeze_mean' | 'select_max' | None.
            None renders the top-k channels (by spatial sum) as a montage.
        topk: channels in the montage when channel_reduction is None.
        arrangement: (rows, cols) of the montage.
    Returns:
        uint8 (H, W, 3) blended image (or montage).
    """
    if overlaid_image is None:
        overlaid_image = np.zeros(
            (featmap.shape[0] * 4, featmap.shape[1] * 4, 3), np.float32)
    img = np.asarray(overlaid_image, np.float32)
    if channel_reduction == "squeeze_mean":
        return _blend_one(featmap.mean(-1), img, alpha)
    if channel_reduction == "select_max":
        ci = int(np.argmax(featmap.max(axis=(0, 1))))
        return _blend_one(featmap[..., ci], img, alpha)
    if channel_reduction is None:
        order = np.argsort(-featmap.sum(axis=(0, 1)))[:topk]
        tiles = [_blend_one(featmap[..., ci], img, alpha) for ci in order]
        return _montage(tiles, arrangement)
    raise ValueError(f"unknown channel_reduction {channel_reduction}")
