"""Box utilities (PyTorch counterpart of rscotr_tpu/ops/box_ops.py): box
format conversions, ``inverse_sigmoid`` and IoU / GIoU overlaps."""

from __future__ import annotations

import torch


def bbox_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """logit with clamping; the reference uses eps=1e-3 everywhere in DINO."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))


def bbox_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


def bbox_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0.0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0.0)


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  mode: str = "iou", is_aligned: bool = False,
                  eps: float = 1e-6) -> torch.Tensor:
    """Pairwise (or aligned) IoU / GIoU between xyxy boxes.

    boxes1: (..., N, 4), boxes2: (..., M, 4) -> (..., N, M), or (..., N)
    when is_aligned.
    """
    if mode not in ("iou", "giou"):
        raise ValueError(f"bbox_overlaps: unknown mode {mode!r}")
    if is_aligned:
        b1, b2 = boxes1, boxes2
    else:
        b1, b2 = boxes1[..., :, None, :], boxes2[..., None, :, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (bbox_area(b1) + bbox_area(b2) - inter).clamp(min=eps)
    iou = inter / union
    if mode == "iou":
        return iou
    wh_e = (torch.maximum(b1[..., 2:], b2[..., 2:]) -
            torch.minimum(b1[..., :2], b2[..., :2])).clamp(min=0.0)
    enclose = (wh_e[..., 0] * wh_e[..., 1]).clamp(min=eps)
    return iou - (enclose - union) / enclose
