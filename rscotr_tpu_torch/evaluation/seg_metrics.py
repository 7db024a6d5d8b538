"""Segmentation metrics (mmseg ``pre_eval`` semantics; counterpart of
rscotr_tpu/evaluation/seg_metrics.py). Predictions outside
``[0, num_classes)`` fall outside the histogram, as under mmseg's
``torch.histc``: scheme 2's labels in [5, 100) (ROADMAP C4) count in no
class's prediction area."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def intersect_and_union(pred: np.ndarray, label: np.ndarray,
                        num_classes: int, ignore_index: int
                        ) -> Tuple[np.ndarray, ...]:
    """Per-class (intersection, union, prediction, label) areas of one
    image, pixels labelled ``ignore_index`` left out."""
    mask = label != ignore_index
    pred = pred[mask]
    label = label[mask]
    inter = pred[pred == label]

    def hist(x):
        x = x[(x >= 0) & (x < num_classes)]
        return np.bincount(x.astype(np.int64), minlength=num_classes)

    area_inter = hist(inter)
    area_pred = hist(pred)
    area_label = hist(label)
    return area_inter, area_pred + area_label - area_inter, area_pred, \
        area_label


def total_metrics(pre_eval_results: Sequence[Tuple[np.ndarray, ...]],
                  metrics=("mIoU",), beta: float = 1.0,
                  nan_to_num=None) -> Dict[str, np.ndarray]:
    """Aggregate per-image (inter, union, pred, label) tuples into
    per-class IoU / Acc / Dice / Fscore / Precision / Recall and aAcc."""
    inter = sum(r[0] for r in pre_eval_results).astype(np.float64)
    union = sum(r[1] for r in pre_eval_results).astype(np.float64)
    pred = sum(r[2] for r in pre_eval_results).astype(np.float64)
    label = sum(r[3] for r in pre_eval_results).astype(np.float64)

    out: Dict[str, np.ndarray] = {
        "aAcc": np.array(inter.sum() / max(label.sum(), 1e-12))}
    with np.errstate(divide="ignore", invalid="ignore"):
        if "mIoU" in metrics:
            out["IoU"] = inter / union
            out["Acc"] = inter / label
        if "mDice" in metrics:
            out["Dice"] = 2 * inter / (pred + label)
            out["Acc"] = inter / label
        if "mFscore" in metrics:
            precision = inter / pred
            recall = inter / label
            out["Fscore"] = (1 + beta ** 2) * precision * recall / \
                ((beta ** 2 * precision) + recall)
            out["Precision"] = precision
            out["Recall"] = recall
    if nan_to_num is not None:
        out = {k: np.nan_to_num(v, nan=nan_to_num) for k, v in out.items()}
    return out


def evaluate_seg(pre_eval_results, metrics=("mIoU",), class_names=None,
                 beta=1.0) -> Dict[str, float]:
    """The mmseg summary in percents: aAcc, the class means (``mIoU``,
    ``mAcc``, ``mFscore``, ...) and, given ``class_names``, the per-class
    values (``IoU.{name}``, ...)."""
    raw = total_metrics(pre_eval_results, metrics, beta)
    summary: Dict[str, float] = {"aAcc": float(raw.pop("aAcc") * 100)}
    for key, vals in raw.items():
        summary[f"m{key}"] = float(np.nanmean(vals) * 100)
        if class_names is not None:
            for i, name in enumerate(class_names):
                summary[f"{key}.{name}"] = float(vals[i] * 100)
    return summary
