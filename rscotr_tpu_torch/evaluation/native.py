"""ctypes bindings of the native eval core (counterpart of
rscotr_tpu/evaluation/native.py; its C++ is the port's own copy,
``csrc/host/coco_eval.cpp``).

The library is built at first use by ``ops/host_lib.py``. Every entry point
returns None when it is unavailable, and its caller takes the numpy path
(``eval_map(use_native=True)`` does); ``available()`` says which it is, and
why.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from rscotr_tpu_torch.ops.host_lib import HostLibrary, Status


def _bind(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.coco_eval_class_ap.restype = ctypes.c_double
    lib.coco_eval_class_ap.argtypes = [
        f32p, f32p, i32p, ctypes.c_int64, f32p, i64p, ctypes.c_int64,
        ctypes.c_double]
    lib.seg_confusion.restype = None
    lib.seg_confusion.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p,
        i64p, i64p]


LIBRARY = HostLibrary("coco_eval.cpp", (), _bind)


def available() -> Status:
    """Whether the eval core built here (truthy), else why not."""
    return LIBRARY.status()


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def class_ap_native(det_boxes: np.ndarray, det_scores: np.ndarray,
                    det_img: np.ndarray, gt_boxes: np.ndarray,
                    gt_start: np.ndarray, n_img: int,
                    iou_thr: float) -> Optional[float]:
    """One class's 101-point AP at ``iou_thr`` (NaN without GT), or None
    when the library is unavailable. ``gt_start`` (n_img + 1,) offsets each
    image's rows of ``gt_boxes``; ``det_img`` is each detection's image."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    det_boxes = np.ascontiguousarray(det_boxes, np.float32)
    det_scores = np.ascontiguousarray(det_scores, np.float32)
    det_img = np.ascontiguousarray(det_img, np.int32)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float32)
    gt_start = np.ascontiguousarray(gt_start, np.int64)
    if len(det_boxes) != len(det_scores) or len(det_img) != len(det_scores) \
            or len(gt_start) != n_img + 1 or \
            int(gt_start[-1]) != len(gt_boxes):
        raise ValueError("class_ap_native: inconsistent detection / GT sizes")
    ap = lib.coco_eval_class_ap(
        _ptr(det_boxes, ctypes.c_float), _ptr(det_scores, ctypes.c_float),
        _ptr(det_img, ctypes.c_int32), len(det_scores),
        _ptr(gt_boxes, ctypes.c_float), _ptr(gt_start, ctypes.c_int64),
        n_img, iou_thr)
    return float("nan") if ap < 0 else float(ap)


def seg_confusion_native(pred: np.ndarray, label: np.ndarray,
                         num_classes: int, ignore_index: int):
    """(intersect, union, pred area, label area) per class, as
    ``intersect_and_union`` gives them, or None when the library is
    unavailable."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    pred = np.ascontiguousarray(pred.reshape(-1), np.int32)
    label = np.ascontiguousarray(label.reshape(-1), np.int32)
    if len(pred) != len(label):
        raise ValueError("seg_confusion_native: pred and label sizes differ")
    inter = np.zeros(num_classes, np.int64)
    area_pred = np.zeros(num_classes, np.int64)
    area_label = np.zeros(num_classes, np.int64)
    lib.seg_confusion(_ptr(pred, ctypes.c_int32),
                      _ptr(label, ctypes.c_int32), len(pred),
                      num_classes, ignore_index,
                      _ptr(inter, ctypes.c_int64),
                      _ptr(area_pred, ctypes.c_int64),
                      _ptr(area_label, ctypes.c_int64))
    union = area_pred + area_label - inter
    return inter, union, area_pred, area_label
