"""The port's eval metrics (rscotr_tpu_torch/evaluation/) against the JAX
package's on the same numpy inputs, exactly: every key, every value (NaN
where JAX has NaN). ``eval_map`` is held against JAX's numpy path
(``use_native=False``) and against JAX's default, which takes the native
C++ AP where its library builds.
"""

import os
import sys

import numpy as np
import pytest

from rscotr_tpu import evaluation as J
from rscotr_tpu_torch import evaluation as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.eval_parity import same_metrics  # noqa: E402


@pytest.mark.parametrize("seed,n,c,ties", [(0, 40, 45, False),
                                           (1, 7, 5, True),
                                           (2, 64, 10, True)])
def test_top_k_accuracy_and_confusion_matrix(seed, n, c, ties):
    rng = np.random.default_rng(seed)
    scores = (rng.integers(0, 4, (n, c)).astype(np.float32) if ties
              else rng.random((n, c)).astype(np.float32))
    labels = rng.integers(0, c, n)
    for topk in ((1,), (1, 5), (1, 3, min(5, c))):
        got = P.top_k_accuracy(scores, labels, topk)
        assert got == J.top_k_accuracy(scores, labels, topk)
        assert sorted(got) == sorted(f"accuracy_top-{k}" for k in set(topk))
    np.testing.assert_array_equal(P.confusion_matrix(scores, labels, c),
                                  J.confusion_matrix(scores, labels, c))


def _det_case(seed, n_img=6, n_cls=4, max_dets=8, tie=True):
    """Per image and class, (n, 5) detections around some GT boxes, a few
    empty classes and images, more detections than ``max_dets`` in some
    cells, and equal scores across images when ``tie``."""
    rng = np.random.default_rng(seed)
    dets, anns = [], []
    for i in range(n_img):
        m = int(rng.integers(0, 6))
        xy = rng.uniform(0, 200, (m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 60, (m, 2))], 1)
        glab = rng.integers(0, n_cls - 1, m)   # the last class has no GT
        anns.append({"bboxes": gt.astype(np.float32),
                     "labels": glab.astype(np.int32)})
        per = []
        for c in range(n_cls):
            k = int(rng.integers(0, 12))
            src = gt[glab == c] if (glab == c).any() else gt
            if len(src):
                base = src[rng.integers(0, len(src), k)]
            else:
                base = np.tile([[20.0, 20.0, 60.0, 60.0]], (k, 1))
            box = base + rng.normal(0, 6, (k, 4))
            score = rng.random(k)
            if tie and k:
                score[0] = 0.5
            per.append(np.concatenate([box, score[:, None]], 1).astype(
                np.float32))
        dets.append(per)
    return dets, anns, max_dets


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thrs", [(0.5,), (0.5, 0.75)])
def test_eval_map_matches_jax(seed, thrs):
    dets, anns, max_dets = _det_case(seed)
    names = tuple(f"c{c}" for c in range(4))
    for class_names in (None, names):
        got = P.eval_map(dets, anns, 4, iou_thrs=thrs, max_dets=max_dets,
                         class_names=class_names)
        same_metrics(got, J.eval_map(dets, anns, 4, iou_thrs=thrs,
                                     max_dets=max_dets,
                                     class_names=class_names,
                                     use_native=False))
        same_metrics(got, J.eval_map(dets, anns, 4, iou_thrs=thrs,
                                     max_dets=max_dets,
                                     class_names=class_names))
    assert np.isnan(got["bbox_AP_c3"])          # no GT of the last class


def test_bbox_iou_and_ap_101_match_jax():
    from rscotr_tpu.evaluation import coco_map as JC
    from rscotr_tpu_torch.evaluation import coco_map as PC
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 50, (7, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 50, (5, 4))
    b[:, 2:] += b[:, :2]
    b[0, 2:] = b[0, :2]                          # a zero-area box
    np.testing.assert_array_equal(PC.bbox_iou_xyxy(a, b),
                                  JC.bbox_iou_xyxy(a, b))
    assert PC.bbox_iou_xyxy(a[:0], b).shape == (0, 5)
    rec = np.sort(rng.random(9))
    prec = rng.random(9)
    assert PC._ap_101(rec, prec) == JC._ap_101(rec, prec)
    assert PC._ap_101(rec[:0], prec[:0]) == JC._ap_101(rec[:0], prec[:0])


def _seg_case(seed, C=5, hw=(33, 47)):
    """Predictions in [0, 100) (scheme 2's labels, ROADMAP C4) and labels
    in [0, C] with the ignore index C and some 255."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, C, hw)
    pred[rng.random(hw) < 0.2] = rng.integers(C, 100)
    label = rng.integers(0, C + 1, hw)
    label[:3] = 255
    return pred.astype(np.int64), label.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ignore", [5, 255])
def test_intersect_and_union_drops_out_of_range_predictions(seed, ignore):
    pred, label = _seg_case(seed)
    got = P.intersect_and_union(pred, label, 5, ignore)
    want = J.intersect_and_union(pred, label, 5, ignore)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].sum() < (label != ignore).sum()   # labels >= 5 dropped


@pytest.mark.parametrize("metrics", [("mIoU",), ("mFscore", "mIoU"),
                                     ("mDice",), ("mIoU", "mDice",
                                                  "mFscore")])
def test_evaluate_seg_and_total_metrics_match_jax(metrics):
    pre = [P.intersect_and_union(*_seg_case(s), 5, 5) for s in range(4)]
    # a class no label or prediction takes: its IoU is 0 / 0
    pre.append(tuple(np.zeros(5, np.int64) for _ in range(4)))
    names = [f"class_{i}" for i in range(5)]
    for class_names in (None, names):
        same_metrics(P.evaluate_seg(pre, metrics, class_names),
                     J.evaluate_seg(pre, metrics, class_names))
    got = P.total_metrics(pre, metrics, nan_to_num=-1)
    want = J.total_metrics(pre, metrics, nan_to_num=-1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
