"""COCO-style mAP (counterpart of the numpy path of
rscotr_tpu/evaluation/coco_map.py; the JAX package's native C++ AP,
``csrc/coco_eval.cpp``, is not ported: ROADMAP M10).

mmdet ``CocoDataset.evaluate(metric="bbox", iou_thrs=[0.5])`` semantics on
crowd-free data: per class, detections in descending score order (a stable
sort, so ties keep image order), each matched greedily to the unmatched GT
of highest IoU at each threshold, 101-point interpolated AP, at most
``max_dets`` detections per image and class.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def bbox_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy boxes -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * \
        np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * \
        np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def _ap_101(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point interpolated AP."""
    if len(recall) == 0:
        return 0.0
    prec = precision.copy()
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    rec_thrs = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rec_thrs, side="left")
    q = np.zeros(101)
    valid = idx < len(prec)
    q[valid] = prec[idx[valid]]
    return float(q.mean())


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[Dict[str, np.ndarray]],
             num_classes: int,
             iou_thrs: Sequence[float] = (0.5,),
             max_dets: int = 100,
             class_names: Optional[Sequence[str]] = None
             ) -> Dict[str, float]:
    """det_results: per image, per class, (n, 5) [x1, y1, x2, y2, score];
    annotations: per image ``bboxes`` (m, 4) xyxy and ``labels`` (m,).
    Returns ``bbox_mAP`` (over thresholds and classes with a GT),
    ``bbox_mAP_{100 * thr}`` per threshold and, given ``class_names``,
    ``bbox_AP_{name}``, each rounded to 4 places."""
    num_imgs = len(det_results)
    aps = np.zeros((len(iou_thrs), num_classes))
    for c in range(num_classes):
        img_dets, img_gts = [], []
        for i in range(num_imgs):
            d = det_results[i][c] if c < len(det_results[i]) else \
                np.zeros((0, 5))
            if len(d) > max_dets:
                d = d[np.argsort(-d[:, 4])[:max_dets]]
            img_dets.append(d)
            ann = annotations[i]
            img_gts.append(ann["bboxes"][ann["labels"] == c])
        num_gt = sum(len(g) for g in img_gts)

        all_scores = np.concatenate(
            [d[:, 4] for d in img_dets]) if img_dets else np.zeros(0)
        all_img = np.concatenate(
            [np.full(len(d), i) for i, d in enumerate(img_dets)]) \
            if img_dets else np.zeros(0, int)
        all_boxes = np.concatenate(
            [d[:, :4] for d in img_dets]) if img_dets else np.zeros((0, 4))
        order = np.argsort(-all_scores, kind="mergesort")

        for ti, thr in enumerate(iou_thrs):
            matched = [np.zeros(len(g), bool) for g in img_gts]
            tp = np.zeros(len(order))
            fp = np.zeros(len(order))
            for rank, di in enumerate(order):
                i = all_img[di]
                gts = img_gts[i]
                if len(gts) == 0:
                    fp[rank] = 1
                    continue
                ious = bbox_iou_xyxy(all_boxes[di:di + 1], gts)[0]
                ious = np.where(matched[i], -1.0, ious)
                j = int(np.argmax(ious))
                if ious[j] >= thr:
                    matched[i][j] = True
                    tp[rank] = 1
                else:
                    fp[rank] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / max(num_gt, 1e-12)
            precision = ctp / np.maximum(ctp + cfp, 1e-12)
            aps[ti, c] = _ap_101(recall, precision) if num_gt > 0 else \
                np.nan

    out: Dict[str, float] = {}
    out["bbox_mAP"] = round(float(np.nanmean(aps)), 4)
    for ti, thr in enumerate(iou_thrs):
        out[f"bbox_mAP_{int(thr * 100)}"] = round(
            float(np.nanmean(aps[ti])), 4)
    if class_names is not None:
        for c, name in enumerate(class_names):
            out[f"bbox_AP_{name}"] = round(float(np.nanmean(aps[:, c])), 4)
    return out
