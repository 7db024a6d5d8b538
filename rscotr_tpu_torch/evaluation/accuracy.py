"""Classification metrics (mmcls ``accuracy`` semantics; counterpart of
rscotr_tpu/evaluation/accuracy.py)."""

from __future__ import annotations

import numpy as np


def top_k_accuracy(scores: np.ndarray, labels: np.ndarray,
                   topk=(1,)) -> dict:
    """scores: (N, C) probabilities or logits; labels: (N,). Percents,
    keyed ``accuracy_top-{k}``."""
    out = {}
    order = np.argsort(scores, axis=1)[:, ::-1]
    for k in topk:
        correct = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"accuracy_top-{k}"] = float(correct.mean() * 100.0)
    return out


def confusion_matrix(scores: np.ndarray, labels: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts, rows the labels, columns the
    argmax predictions."""
    pred = scores.argmax(1)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels, pred), 1)
    return cm
