"""Loss functions (PyTorch counterpart of rscotr_tpu/ops/losses.py).

Plain tensor functions with the JAX module's semantics: mmcv
``SigmoidFocalLoss`` with mmdet ``avg_factor`` normalization, mmdet
``L1Loss`` / ``GIoULoss`` with per-element weights, mmseg
``CrossEntropyLoss`` (softmax, ``ignore_index``), mmcls ``LabelSmoothLoss``
and the Mask2Former dice loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rscotr_tpu_torch.ops.box_ops import bbox_overlaps


def _reduce(loss: torch.Tensor, weight: Optional[torch.Tensor],
            avg_factor, eps: float = 1e-12) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    total = loss.sum()
    if avg_factor is None:
        return total
    return total / torch.clamp(torch.as_tensor(avg_factor, dtype=total.dtype,
                                               device=total.device), min=eps)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       alpha: float = 0.25, gamma: float = 2.0,
                       avg_factor=None,
                       num_classes: Optional[int] = None) -> torch.Tensor:
    """Multi-class sigmoid focal loss. logits (N, C); labels (N,) int in
    [0, C], C = background (all-zero one-hot); weight (N,)."""
    C = num_classes or logits.shape[-1]
    # one_hot of the background label C has no column: drop it
    target = F.one_hot(labels.long(), C + 1)[..., :C].to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) * \
        pt.pow(gamma)
    bce = torch.maximum(logits, torch.zeros_like(logits)) - \
        logits * target + torch.log1p(torch.exp(-logits.abs()))
    loss = (bce * focal_weight).sum(-1)
    return _reduce(loss, weight, avg_factor)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            weight: Optional[torch.Tensor] = None,
            avg_factor=None) -> torch.Tensor:
    return _reduce((pred - target).abs(), weight, avg_factor)


def giou_loss(pred: torch.Tensor, target: torch.Tensor,
              weight: Optional[torch.Tensor] = None, avg_factor=None,
              eps: float = 1e-6) -> torch.Tensor:
    """pred / target (N, 4) xyxy; a (N, 4) weight is reduced to its mean
    over the last axis (the weights are 0/1 row-constant)."""
    if weight is not None and weight.dim() > 1:
        weight = weight.mean(-1)
    giou = bbox_overlaps(pred, target, mode="giou", is_aligned=True, eps=eps)
    return _reduce(1.0 - giou, weight, avg_factor)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = 255,
                          class_weight: Optional[torch.Tensor] = None,
                          avg_non_ignore: bool = True,
                          avg_factor: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Softmax CE over (..., C) logits; labels equal to ``ignore_index`` or
    outside [0, C) are ignored (``counted_labels``). ``avg_factor``: the
    denominator of the mean (the global batch's count under data
    parallelism); this batch's when None."""
    C = logits.shape[-1]
    labels = labels.long()
    valid = counted_labels(labels, C, ignore_index)
    safe = torch.where(valid, labels, 0)
    nll = -torch.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
    w = valid.to(logits.dtype)
    if class_weight is not None:
        w = w * class_weight[safe]
    if avg_factor is not None:
        denom = avg_factor
    elif avg_non_ignore:
        denom = w.sum()
    else:
        denom = torch.tensor(float(labels.numel()), dtype=logits.dtype,
                             device=logits.device)
    return (nll * w).sum() / denom.clamp(min=1e-12)


def counted_labels(labels: torch.Tensor, num_classes: int,
                   ignore_index: int = 255) -> torch.Tensor:
    """The labels ``softmax_cross_entropy`` counts: not ``ignore_index``,
    in [0, num_classes)."""
    return (labels != ignore_index) & (labels >= 0) & (labels < num_classes)


def label_smooth_loss(logits: torch.Tensor, target: torch.Tensor,
                      label_smooth_val: float = 0.1,
                      mode: str = "original") -> torch.Tensor:
    """mmcls LabelSmoothLoss. target: (N,) int labels or (N, C) soft
    targets (mixup / cutmix)."""
    C = logits.shape[-1]
    if target.dim() == 1:
        target = F.one_hot(target.long(), C).to(logits.dtype)
    if mode == "original":
        target = target * (1.0 - label_smooth_val) + label_smooth_val / C
    elif mode == "classy_vision":
        target = (target + label_smooth_val / C) / (1.0 + label_smooth_val)
    else:
        raise ValueError(f"unknown mode {mode}")
    return (-(target * torch.log_softmax(logits, -1)).sum(-1)).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             topk: int = 1) -> torch.Tensor:
    idx = logits.topk(topk, dim=-1).indices
    correct = (idx == labels[..., None]).any(-1)
    return correct.float().mean() * 100.0


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              weight: Optional[torch.Tensor] = None, avg_factor=None,
              eps: float = 1e-3) -> torch.Tensor:
    """Dice loss on sigmoid mask logits (N, ...)."""
    p = torch.sigmoid(pred).reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1).to(p.dtype)
    num = 2.0 * (p * t).sum(1)
    den = p.sum(1) + t.sum(1)
    return _reduce(1.0 - (num + eps) / (den + eps), weight, avg_factor)
