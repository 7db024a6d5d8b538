"""DINO losses and post-processing (PyTorch counterpart of
rscotr_tpu/models/heads/dino_loss.py).

Static-shape scheme, as in the JAX module: GTs per image are padded to
``max_gt`` with a ``gt_valid`` mask, padded cost rows are a constant and the
matcher skips them, and the avg factors are taken over the whole batch
(``avg_factors``; under data parallelism the train step sums them over the
ranks and passes the global batch's, mmdet's ``reduce_mean`` as a sum).
Loss-dict names are the reference's: ``interm_loss_*``, ``d{i}.loss_*``,
``d{i}.dn_loss_*``, ``loss_*``, ``dn_loss_*``.

Matching: ``dino_loss`` stacks the match costs of the encoder top-k and of
every decoder layer for every image on the device (detached), copies them to
the host in one device-to-host copy per step, solves them with the host
``hungarian`` (ops/matcher.py) and sends the assignments back in one copy.
The JAX ``_targets_single`` scatters a padded GT row's col4row of -1 as
index -1, which JAX wraps to the last query (its background label and zero
box weight land there, after the real rows, and the later write wins);
the port keeps that behaviour so the losses stay equal (ROADMAP C3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from rscotr_tpu_torch.models.heads.cdn import CdnConfig, cdn_targets
from rscotr_tpu_torch.ops.box_ops import (bbox_cxcywh_to_xyxy,
                                          bbox_xyxy_to_cxcywh)
from rscotr_tpu_torch.ops.losses import giou_loss, l1_loss, sigmoid_focal_loss
from rscotr_tpu_torch.ops.matcher import (bbox_l1_cost, focal_loss_cost,
                                          hungarian_batched, iou_cost)

PAD_COST = 1e6


@dataclasses.dataclass(frozen=True)
class DetLossConfig:
    num_classes: int = 20
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 5.0
    loss_iou_weight: float = 2.0
    cost_cls_weight: float = 2.0
    cost_bbox_weight: float = 5.0
    cost_iou_weight: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    bg_cls_weight: float = 0.0


def _factor(img_hw: torch.Tensor) -> torch.Tensor:
    """(B, 2) (h, w) -> (B, 1, 4) (w, h, w, h) float32."""
    h = img_hw[:, 0].float()
    w = img_hw[:, 1].float()
    return torch.stack([w, h, w, h], -1)[:, None, :]


def _match_cost(cls_logits, bbox_pred, gt_bboxes_xyxy, gt_labels, gt_valid,
                img_hw, cfg: DetLossConfig):
    """The matching cost (..., G, Nq) of ``_match_single`` with padded rows
    set to PAD_COST; leading axes (layers, images) broadcast with img_hw's
    (B, 2)."""
    factor = _factor(img_hw)
    gt_norm = bbox_xyxy_to_cxcywh(gt_bboxes_xyxy / factor)
    safe = gt_labels.long().clamp(0, cfg.num_classes - 1)
    cost = focal_loss_cost(cls_logits, safe, alpha=cfg.focal_alpha,
                           gamma=cfg.focal_gamma, weight=cfg.cost_cls_weight)
    cost = cost + bbox_l1_cost(bbox_pred, gt_norm,
                               weight=cfg.cost_bbox_weight)
    pred_xyxy = bbox_cxcywh_to_xyxy(bbox_pred) * factor
    cost = cost + iou_cost(pred_xyxy, gt_bboxes_xyxy,
                           weight=cfg.cost_iou_weight)
    return torch.where(gt_valid[..., None], cost, PAD_COST)


def _match_single(cls_logits, bbox_pred, gt_bboxes_xyxy, gt_labels, gt_valid,
                  img_hw, cfg: DetLossConfig) -> np.ndarray:
    """Hungarian assignment for one image: cls_logits (Nq, K), bbox_pred
    (Nq, 4) normalized cxcywh, gt (G, 4) absolute xyxy, img_hw (2,) ->
    col4row (G,) on the host."""
    cost = _match_cost(cls_logits[None], bbox_pred[None],
                       gt_bboxes_xyxy[None], gt_labels[None],
                       gt_valid[None], img_hw[None], cfg)
    return hungarian_batched(cost.detach().cpu().numpy(),
                             gt_valid[None].cpu().numpy())[0]


def _target_columns(col4row: np.ndarray, num_query: int) -> np.ndarray:
    """Where each GT row's target lands: col4row with -1 wrapped to the last
    query (JAX index normalization), and num_query (a dump column) for a row
    whose column a later row writes again (the later write wins)."""
    cols = np.where(col4row < 0, col4row + num_query, col4row)
    out = np.full_like(cols, num_query)
    flat_cols = cols.reshape(-1, cols.shape[-1])
    flat_out = out.reshape(-1, cols.shape[-1])
    for cr, orow in zip(flat_cols, flat_out):
        seen = set()
        for r in range(len(cr) - 1, -1, -1):
            if cr[r] not in seen:
                seen.add(cr[r])
                orow[r] = cr[r]
    return out


def _targets(cols: torch.Tensor, gt_bboxes_xyxy, gt_labels, gt_valid,
             img_hw, num_query: int, cfg: DetLossConfig):
    """Scatter matched GTs onto the query axis: cols (B, G) from
    ``_target_columns`` -> labels (B, Nq), bbox_t, bbox_w (B, Nq, 4)."""
    B, G = gt_valid.shape
    dev = gt_valid.device
    gt_norm = bbox_xyxy_to_cxcywh(gt_bboxes_xyxy / _factor(img_hw))
    safe = gt_labels.long().clamp(0, cfg.num_classes - 1)
    cols = cols.long()
    labels = torch.full((B, num_query + 1), cfg.num_classes, dtype=torch.long,
                        device=dev)
    labels.scatter_(1, cols, torch.where(gt_valid, safe, cfg.num_classes))
    idx4 = cols[..., None].expand(B, G, 4)
    bbox_t = torch.zeros((B, num_query + 1, 4), device=dev).scatter_(
        1, idx4, torch.where(gt_valid[..., None], gt_norm, 0.0))
    bbox_w = torch.zeros((B, num_query + 1, 4), device=dev).scatter_(
        1, idx4, gt_valid[..., None].float().expand(B, G, 4))
    return (labels[:, :num_query], bbox_t[:, :num_query],
            bbox_w[:, :num_query])


def loss_single_layer(cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_valid,
                      img_hw, cfg: DetLossConfig, cols=None, num_pos=None):
    """Matching loss for one decoder layer (or the encoder top-k).

    cls_scores (B, Nq, K); bbox_preds (B, Nq, 4) normalized cxcywh;
    gt_bboxes (B, G, 4) absolute xyxy; img_hw (B, 2). ``cols`` (B, G) are the
    target columns of ``_target_columns``; when None this layer is matched
    on its own. ``num_pos``: the avg factor (the batch's valid GT count
    when None; ``dino_loss`` passes the global batch's).
    """
    B, Nq, K = cls_scores.shape
    if cols is None:
        col4row = np.stack([
            _match_single(cls_scores[b].detach(), bbox_preds[b].detach(),
                          gt_bboxes[b], gt_labels[b], gt_valid[b], img_hw[b],
                          cfg) for b in range(B)])
        cols = torch.as_tensor(_target_columns(col4row, Nq),
                               device=cls_scores.device)
    labels, bbox_t, bbox_w = _targets(cols, gt_bboxes, gt_labels, gt_valid,
                                      img_hw, Nq, cfg)
    if num_pos is None:
        num_pos = gt_valid.float().sum()
    loss_cls = sigmoid_focal_loss(
        cls_scores.reshape(-1, K), labels.reshape(-1),
        alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
        avg_factor=torch.clamp(num_pos, min=1.0)) * cfg.loss_cls_weight
    num_pos = torch.clamp(num_pos, min=1.0)
    factor = _factor(img_hw)
    pred_xyxy = bbox_cxcywh_to_xyxy(bbox_preds) * factor
    tgt_xyxy = bbox_cxcywh_to_xyxy(bbox_t) * factor
    loss_iou = giou_loss(pred_xyxy.reshape(-1, 4), tgt_xyxy.reshape(-1, 4),
                         weight=bbox_w.reshape(-1, 4),
                         avg_factor=num_pos) * cfg.loss_iou_weight
    loss_bbox = l1_loss(bbox_preds.reshape(-1, 4), bbox_t.reshape(-1, 4),
                        weight=bbox_w.reshape(-1, 4),
                        avg_factor=num_pos) * cfg.loss_bbox_weight
    return loss_cls, loss_bbox, loss_iou


def avg_factors(gt_bboxes, gt_labels, gt_valid, img_hw,
                cdn_cfg: CdnConfig, cfg: DetLossConfig) -> torch.Tensor:
    """The batch's avg factors as one f32 (3,) tensor, before their clamps:
    the valid GT count (the matching losses' ``num_pos``), the DN cls avg
    factor and the DN positive count."""
    B, P = gt_valid.shape[0], cdn_cfg.pad_size
    dn_pos = cdn_targets(bbox_xyxy_to_cxcywh(gt_bboxes / _factor(img_hw)),
                         gt_labels, gt_valid, cdn_cfg)["num_pos"]
    cls_avg = dn_pos * 1.0 + (B * P - dn_pos) * cfg.bg_cls_weight
    return torch.stack([gt_valid.float().sum(), cls_avg, dn_pos]).float()


def loss_dn_single_layer(dn_cls, dn_bbox, gt_bboxes, gt_labels, gt_valid,
                         img_hw, cdn_cfg: CdnConfig, cfg: DetLossConfig,
                         cls_avg, dn_pos):
    """Denoising loss for one decoder layer (fixed positive mapping);
    ``cls_avg`` and ``dn_pos`` are ``avg_factors``'s."""
    K = dn_cls.shape[-1]
    factor = _factor(img_hw)
    t = cdn_targets(bbox_xyxy_to_cxcywh(gt_bboxes / factor), gt_labels,
                    gt_valid, cdn_cfg)
    loss_cls = sigmoid_focal_loss(
        dn_cls.reshape(-1, K), t["labels"].reshape(-1),
        weight=t["label_weights"].reshape(-1), alpha=cfg.focal_alpha,
        gamma=cfg.focal_gamma,
        avg_factor=torch.clamp(cls_avg, min=1.0)) * cfg.loss_cls_weight
    num_pos = torch.clamp(dn_pos, min=1.0)
    pred_xyxy = bbox_cxcywh_to_xyxy(dn_bbox) * factor
    tgt_xyxy = bbox_cxcywh_to_xyxy(t["bbox_targets"]) * factor
    loss_iou = giou_loss(pred_xyxy.reshape(-1, 4), tgt_xyxy.reshape(-1, 4),
                         weight=t["bbox_weights"].reshape(-1, 4),
                         avg_factor=num_pos) * cfg.loss_iou_weight
    loss_bbox = l1_loss(dn_bbox.reshape(-1, 4),
                        t["bbox_targets"].reshape(-1, 4),
                        weight=t["bbox_weights"].reshape(-1, 4),
                        avg_factor=num_pos) * cfg.loss_bbox_weight
    return loss_cls, loss_bbox, loss_iou


def dino_loss(all_cls, all_coords, topk_score, topk_anchor, gt_bboxes,
              gt_labels, gt_valid, img_hw, cdn_cfg: CdnConfig,
              cfg: DetLossConfig, factors: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """Full DINO loss dict. all_cls (L, B, P + Nq, K) and all_coords
    (L, B, P + Nq, 4) hold the DN slots first; topk_score (B, Nq', K) and
    topk_anchor (B, Nq', 4) are the encoder proposals. ``factors``: the
    avg factors (``avg_factors``'s, of the global batch under data
    parallelism); this batch's when None."""
    P = cdn_cfg.pad_size
    dn_cls, dn_coords = all_cls[:, :, :P], all_coords[:, :, :P]
    m_cls, m_coords = all_cls[:, :, P:], all_coords[:, :, P:]
    L, B, Nq = m_cls.shape[:3]
    with_interm = topk_score.shape == m_cls[0].shape
    if with_interm:
        stack_cls = torch.cat([topk_score[None], m_cls], 0)
        stack_box = torch.cat([topk_anchor[None], m_coords], 0)
    else:  # differing proposal count: match the decoder layers only
        stack_cls, stack_box = m_cls, m_coords
    S = stack_cls.shape[0]

    # every (layer, image) cost in one device-to-host copy, with gt_valid
    cost = _match_cost(stack_cls.detach(), stack_box.detach(), gt_bboxes,
                       gt_labels, gt_valid, img_hw, cfg)   # (S, B, G, Nq)
    G = cost.shape[2]
    host = torch.cat([cost.reshape(-1),
                      gt_valid.reshape(-1).to(cost.dtype)]).cpu().numpy()
    cost_np = host[:cost.numel()].reshape(S * B, G, Nq)
    valid_np = host[cost.numel():].reshape(B, G) > 0
    col4row = hungarian_batched(cost_np, np.tile(valid_np, (S, 1)))
    cols = torch.as_tensor(_target_columns(col4row.reshape(S, B, G), Nq),
                           device=all_cls.device)
    if with_interm:
        interm_cols, layer_cols = cols[0], cols[1:]
    else:
        interm_cols, layer_cols = None, cols

    if factors is None:
        factors = avg_factors(gt_bboxes, gt_labels, gt_valid, img_hw,
                              cdn_cfg, cfg)
    num_pos, dn_cls_avg, dn_pos = factors.unbind(0)
    out: Dict[str, torch.Tensor] = {}
    e_cls, e_bbox, e_iou = loss_single_layer(
        topk_score, topk_anchor, gt_bboxes, gt_labels, gt_valid, img_hw, cfg,
        cols=interm_cols, num_pos=num_pos)
    out["interm_loss_cls"] = e_cls
    out["interm_loss_bbox"] = e_bbox
    out["interm_loss_iou"] = e_iou
    for lyr in range(L):
        c, b, i = loss_single_layer(m_cls[lyr], m_coords[lyr], gt_bboxes,
                                    gt_labels, gt_valid, img_hw, cfg,
                                    cols=layer_cols[lyr], num_pos=num_pos)
        dc, db, di = loss_dn_single_layer(dn_cls[lyr], dn_coords[lyr],
                                          gt_bboxes, gt_labels, gt_valid,
                                          img_hw, cdn_cfg, cfg, dn_cls_avg,
                                          dn_pos)
        pre = "" if lyr == L - 1 else f"d{lyr}."
        out[f"{pre}loss_cls"], out[f"{pre}loss_bbox"], \
            out[f"{pre}loss_iou"] = c, b, i
        out[f"{pre}dn_loss_cls"], out[f"{pre}dn_loss_bbox"], \
            out[f"{pre}dn_loss_iou"] = dc, db, di
    return out


def dino_get_bboxes(cls_scores, bbox_preds, img_hw, scale_factor=None,
                    max_per_img: int = 300, rescale: bool = False):
    """Top-k post-processing, no NMS.

    cls_scores: (B, Nq, K) last-layer logits; bbox_preds: (B, Nq, 4)
    normalized cxcywh; img_hw: (B, 2) = (h, w); scale_factor: (B, 4) or None.
    Returns (det_bboxes (B, max_per_img, 5) xyxy + score, det_labels).
    """
    B, Nq, K = cls_scores.shape
    scores = cls_scores.sigmoid().reshape(B, Nq * K)
    top_scores, top_idx = scores.topk(max_per_img, dim=1)
    q_idx = torch.div(top_idx, K, rounding_mode="floor")
    labels = top_idx % K
    boxes = bbox_cxcywh_to_xyxy(
        bbox_preds.gather(1, q_idx[..., None].expand(-1, -1, 4)))
    factor = _factor(img_hw)
    boxes = torch.minimum((boxes * factor).clamp(min=0), factor)
    if rescale and scale_factor is not None:
        boxes = boxes / scale_factor[:, None, :]
    return torch.cat([boxes, top_scores[..., None]], -1), labels
