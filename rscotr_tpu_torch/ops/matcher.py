"""Hungarian matching on the host + DETR match costs on the device (PyTorch
counterpart of rscotr_tpu/ops/matcher.py).

The costs (mmdet ``FocalLossCost`` / ``BBoxL1Cost`` / ``IoUCost``) are tensor
functions that run where their inputs are. ``hungarian`` is the JAX
module's shortest-augmenting-path LAP with dual potentials, transliterated to
numpy in float32: the same arithmetic, the same first-index ``argmin`` and
the same skipping of invalid (padded) rows, so its assignments equal JAX's,
ties included. It runs on the host by design, as the reference's matcher did
(scipy inside mmdet's ``HungarianAssigner``): a LAP over at most 100 x 600 is
a sequential loop that a device loop driven from Python would turn into
thousands of launches. ``scipy.optimize.linear_sum_assignment`` finds the
same optimum but may break ties differently, so it is not used.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rscotr_tpu_torch.ops.box_ops import bbox_overlaps

INF = np.float32(1e30)


def hungarian(cost: np.ndarray,
              row_valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Min-cost assignment of rows (GTs) to columns (queries), nr <= nc.

    Returns col4row (nr,) int32; a row with ``row_valid`` False is skipped
    and keeps -1.
    """
    cost = np.asarray(cost, dtype=np.float32)
    nr, nc = cost.shape
    if nr > nc:
        raise ValueError(f"hungarian: rows {nr} exceed columns {nc}")
    if row_valid is None:
        row_valid = np.ones(nr, bool)
    u = np.zeros(nr, np.float32)
    v = np.zeros(nc, np.float32)
    col4row = np.full(nr, -1, np.int32)
    row4col = np.full(nc, -1, np.int32)
    rows = np.arange(nr)
    for cur_row in range(nr):
        if not row_valid[cur_row]:
            continue
        # Dijkstra over columns for an augmenting path
        i = cur_row
        minval = np.float32(0.0)
        spc = np.full(nc, INF, np.float32)
        path = np.zeros(nc, np.int32)
        sc = np.zeros(nc, bool)
        sr = np.zeros(nr, bool)
        sink = -1
        while sink < 0:
            sr[i] = True
            r = minval + cost[i] - u[i] - v
            upd = (r < spc) & ~sc
            path[upd] = i
            spc = np.where(upd, r, spc)
            masked = np.where(sc, INF, spc)
            j = int(np.argmin(masked))
            minval = masked[j]
            sc[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
        # dual updates (scipy rectangular-lsap rule)
        u[cur_row] += minval
        safe_c4r = np.clip(col4row, 0, nc - 1)
        u = u + np.where(sr & (rows != cur_row), minval - spc[safe_c4r],
                         np.float32(0.0))
        v = v - np.where(sc, minval - spc, np.float32(0.0))
        # augment along the path
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            nxt = int(col4row[i])
            col4row[i] = j
            j = nxt
            if i == cur_row:
                break
    return col4row


def hungarian_batched(cost: np.ndarray,
                      row_valid: Optional[np.ndarray] = None) -> np.ndarray:
    """``hungarian`` over a leading batch axis: cost (N, nr, nc), row_valid
    (N, nr) -> (N, nr) int32."""
    if row_valid is None:
        row_valid = np.ones(cost.shape[:2], bool)
    return np.stack([hungarian(c, m) for c, m in zip(cost, row_valid)]) \
        if len(cost) else np.zeros(cost.shape[:2], np.int32)


# ---------------------------------------------------------------------------
# DETR match costs; leading batch axes broadcast
# ---------------------------------------------------------------------------

def focal_loss_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0,
                    weight: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """cls_logits (..., num_query, C); gt_labels (..., num_gt) ->
    (..., num_gt, num_query)."""
    p = torch.sigmoid(cls_logits)
    neg = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p.pow(gamma)
    pos = -torch.log(p + eps) * alpha * (1.0 - p).pow(gamma)
    idx = gt_labels.long()[..., None, :].expand(
        *cls_logits.shape[:-1], gt_labels.shape[-1])
    cost = pos.gather(-1, idx) - neg.gather(-1, idx)   # (..., nq, ng)
    return cost.transpose(-1, -2) * weight


def bbox_l1_cost(bbox_pred: torch.Tensor, gt_bboxes_norm: torch.Tensor,
                 weight: float = 5.0) -> torch.Tensor:
    """bbox_pred (..., num_query, 4) and gt (..., num_gt, 4), normalized
    cxcywh -> (..., num_gt, num_query)."""
    cost = (bbox_pred[..., None, :, :] -
            gt_bboxes_norm[..., :, None, :]).abs().sum(-1)
    return cost * weight


def iou_cost(bboxes_xyxy: torch.Tensor, gt_bboxes_xyxy: torch.Tensor,
             mode: str = "giou", weight: float = 2.0) -> torch.Tensor:
    """Both in absolute xyxy -> (..., num_gt, num_query)."""
    return -bbox_overlaps(gt_bboxes_xyxy, bboxes_xyxy, mode=mode) * weight
