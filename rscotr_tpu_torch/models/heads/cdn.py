"""Contrastive denoising (CDN) queries, static shapes (PyTorch counterpart
of rscotr_tpu/models/heads/cdn.py).

GTs arrive padded to ``max_gt`` with a validity mask. ``single_pad`` (the
static ``dn_max_gt``, or ``max_gt``) is the DN group width, ``num_groups =
max(num_dn_queries // single_pad, 1)`` and ``pad_size = 2 * single_pad *
num_groups``. Group g occupies slots [g*2*S, (g+1)*2*S), positives in the
first S and negatives in the second; GT i sits at offset i of each block.
Only the first ``single_pad`` GT slots (valid GTs are front-packed) get DN
queries. This mirrors the JAX module, including its fixed group count where
the reference sizes groups from the batch's GT count (ROADMAP C1).

Label noise flips a label to a uniform random class with probability
0.5 * label_noise_scale; box noise jitters corners by up to the half extents
(negatives pushed by an extra unit) and clamps to [0, 1]. ``noise`` may carry
pre-drawn values (``p`` / ``new_label`` (B, blocks, S), ``sign`` / ``part``
(B, blocks, S, 4)) so a test drives this and the JAX module with identical
draws; otherwise they come from ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rscotr_tpu_torch.ops.box_ops import (bbox_cxcywh_to_xyxy,
                                          bbox_xyxy_to_cxcywh,
                                          inverse_sigmoid)


@dataclasses.dataclass(frozen=True)
class CdnConfig:
    num_classes: int
    num_queries: int          # matching queries (600)
    max_gt: int               # static per-image GT cap (loss padding)
    num_dn_queries: int = 100
    label_noise_scale: float = 0.5
    box_noise_scale: float = 1.0
    dn_max_gt: Optional[int] = None   # None = max_gt

    @property
    def single_pad(self) -> int:
        return self.dn_max_gt or self.max_gt

    @property
    def num_groups(self) -> int:
        return max(self.num_dn_queries // self.single_pad, 1)

    @property
    def pad_size(self) -> int:
        return 2 * self.single_pad * self.num_groups


def _to_dn_slots(x: torch.Tensor, S: int) -> torch.Tensor:
    """(B, max_gt, ...) -> (B, S, ...): slice, or zero-pad when S > max_gt."""
    G = x.shape[1]
    if S <= G:
        return x[:, :S]
    pad = x.new_zeros((x.shape[0], S - G) + tuple(x.shape[2:]))
    return torch.cat([x, pad], 1)


def cdn_self_attn_mask(cfg: CdnConfig) -> np.ndarray:
    """Static (tgt, tgt) bool mask; True = attention NOT allowed."""
    S2 = 2 * cfg.single_pad
    pad = cfg.pad_size
    tgt = pad + cfg.num_queries
    m = np.zeros((tgt, tgt), dtype=bool)
    m[pad:, :pad] = True                       # matching can't see DN
    for g in range(cfg.num_groups):
        lo, hi = g * S2, (g + 1) * S2
        m[lo:hi, :lo] = True                   # can't see earlier groups
        m[lo:hi, hi:pad] = True                # can't see later groups
    return m


def draw_cdn_noise(generator: torch.Generator, B: int,
                   cfg: CdnConfig) -> Dict[str, torch.Tensor]:
    """The random draws of ``generate_cdn_queries``, on the generator's
    device."""
    shape = (B, 2 * cfg.num_groups, cfg.single_pad)
    dev = generator.device
    return {
        "p": torch.rand(shape, generator=generator, device=dev),
        "new_label": torch.randint(0, cfg.num_classes, shape,
                                   generator=generator, device=dev),
        "sign": torch.randint(0, 2, shape + (4,), generator=generator,
                              device=dev).float() * 2.0 - 1.0,
        "part": torch.rand(shape + (4,), generator=generator, device=dev),
    }


def generate_cdn_queries(gt_bboxes_cxcywh_norm: torch.Tensor,
                         gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                         label_embedding: torch.Tensor, cfg: CdnConfig,
                         noise: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Noised DN label / box queries.

    gt_bboxes_cxcywh_norm (B, max_gt, 4); gt_labels (B, max_gt) int;
    gt_valid (B, max_gt) bool; label_embedding (num_classes, C); ``noise``
    from ``draw_cdn_noise`` or a test. Returns dn_label_query
    (B, pad_size, C) and dn_bbox_query (B, pad_size, 4) unsigmoided, zero at
    invalid slots.
    """
    B = gt_bboxes_cxcywh_norm.shape[0]
    S = cfg.single_pad
    blocks = 2 * cfg.num_groups
    dev = gt_bboxes_cxcywh_norm.device
    noise = {k: torch.as_tensor(v).to(dev) for k, v in noise.items()}
    boxes = _to_dn_slots(gt_bboxes_cxcywh_norm, S)[:, None].expand(
        B, blocks, S, 4)
    labels = _to_dn_slots(gt_labels, S)[:, None].expand(B, blocks, S)
    valid = _to_dn_slots(gt_valid, S)[:, None].expand(B, blocks, S)

    if cfg.label_noise_scale > 0:
        labels = torch.where(noise["p"] < cfg.label_noise_scale * 0.5,
                             noise["new_label"].to(labels.dtype), labels)
    if cfg.box_noise_scale > 0:
        corners = bbox_cxcywh_to_xyxy(boxes)
        half = boxes[..., 2:] * 0.5
        diff = torch.cat([half, half], -1)
        # negative blocks (odd block index) get the extra push
        is_neg = (torch.arange(blocks, device=dev) % 2 == 1).float()
        part = noise["part"] + is_neg[None, :, None, None]
        corners = corners + part * noise["sign"] * diff * cfg.box_noise_scale
        boxes = bbox_xyxy_to_cxcywh(corners.clamp(0.0, 1.0))

    safe = labels.long().clamp(0, cfg.num_classes - 1)
    label_q = F.embedding(safe, label_embedding)
    bbox_q = inverse_sigmoid(boxes, eps=1e-3)
    vmask = valid[..., None]
    label_q = torch.where(vmask, label_q, 0.0)
    bbox_q = torch.where(vmask, bbox_q, 0.0)
    C = label_embedding.shape[-1]
    return (label_q.reshape(B, cfg.pad_size, C),
            bbox_q.reshape(B, cfg.pad_size, 4))


def cdn_targets(gt_bboxes_cxcywh_norm: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, cfg: CdnConfig):
    """DN loss targets over the pad_size slots: labels (B, P),
    label_weights (B, P), bbox_targets (B, P, 4), bbox_weights (B, P, 4),
    num_pos (scalar)."""
    B = gt_bboxes_cxcywh_norm.shape[0]
    S = cfg.single_pad
    blocks = 2 * cfg.num_groups
    dev = gt_bboxes_cxcywh_norm.device
    gt_boxes = _to_dn_slots(gt_bboxes_cxcywh_norm, S)
    gt_labels = _to_dn_slots(gt_labels, S)
    gt_valid = _to_dn_slots(gt_valid, S)
    # slot (block j, offset i): positive iff j even and gt i valid
    is_pos_block = torch.arange(blocks, device=dev) % 2 == 0
    pos = gt_valid[:, None, :] & is_pos_block[None, :, None]
    labels = torch.where(pos, gt_labels[:, None, :].long(), cfg.num_classes)
    boxes = gt_boxes[:, None].expand(B, blocks, S, 4)
    P = cfg.pad_size
    return dict(
        labels=labels.reshape(B, P),
        label_weights=torch.ones((B, P), device=dev),
        bbox_targets=torch.where(pos[..., None], boxes, 0.0).reshape(B, P, 4),
        bbox_weights=pos[..., None].float().expand(B, blocks, S, 4).reshape(
            B, P, 4),
        num_pos=gt_valid.float().sum() * cfg.num_groups)
