"""Shared checks of the port's evaluation against the JAX package's.

Raw results are held within the slice tolerances of
tests/test_torch_port_slice.py (cls probabilities, det scores and boxes)
and tests/test_torch_port_seg.py (seg logits). A metric is a function of
decisions (a top-k membership, a score order, an IoU against its threshold,
an argmax), and two result sets within tolerance can still take one of
them differently where its margin is below the tolerance. So the metrics of
the two packages are asserted equal only over what every such margin, read
from JAX's results, decides by more than 10x its tolerance: the images, the
classes, the pixels that ``*_clear*`` pick.
"""

from __future__ import annotations

import math

import numpy as np

CLS_TOL, SCORE_TOL, BOX_TOL = 1e-5, 1e-5, 1e-3
SEG_TOL = 1e-4
# an IoU moves by about BOX_TOL * perimeter / area <= 3e-4 for the
# synthetic sets' smallest boxes (13 px a side at 256^2); 10x that
IOU_MARGIN = 3e-3


def same_metrics(got: dict, want: dict) -> None:
    """Equal keys, and every value equal (NaN equal to NaN)."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        g, w = got[k], want[k]
        assert g == w or (math.isnan(g) and math.isnan(w)), (k, g, w)


def cls_clear_mask(want, k: int) -> np.ndarray:
    """The images whose top-k membership JAX's probabilities decide by more
    than 10x CLS_TOL."""
    s = -np.sort(-np.stack(want), axis=1)
    return s[:, k - 1] - s[:, k] > 10 * CLS_TOL


def check_cls(got, want) -> None:
    assert len(got) == len(want)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=CLS_TOL)


def det_rows(per_class):
    """One image's per-class (n, 5) arrays -> (labels, rows) by descending
    score (stable)."""
    labels = np.concatenate([np.full(len(a), c)
                             for c, a in enumerate(per_class)])
    rows = np.concatenate([np.asarray(a, np.float64).reshape(-1, 5)
                           for a in per_class])
    order = np.argsort(-rows[:, 4], kind="mergesort")
    return labels[order], rows[order]


def check_det(got, want_more) -> set:
    """``got``: the port's det results at ``max_per_img`` k; ``want_more``:
    JAX's at k + 1, so the score of the first detection cut is known.
    Per image the sorted scores agree within SCORE_TOL; every detection
    whose score lies more than 10x SCORE_TOL from both neighbours (the cut
    one included) has the same label and its box within BOX_TOL. Returns
    the classes of the last kept and the first cut detection of each image
    whose cut is not that clear (the two packages may keep either)."""
    assert len(got) == len(want_more)
    unclear = set()
    for g, w in zip(got, want_more):
        gl, gr = det_rows(g)
        wl, wr = det_rows(w)
        k = len(gr)
        assert len(wr) == k + 1, (len(wr), k)
        np.testing.assert_allclose(gr[:, 4], wr[:k, 4], rtol=0,
                                   atol=SCORE_TOL)
        gaps = wr[:-1, 4] - wr[1:, 4]            # k gaps, the cut's last
        sep = gaps > 10 * SCORE_TOL
        sep[1:] &= gaps[:-1] > 10 * SCORE_TOL
        np.testing.assert_array_equal(gl[sep], wl[:k][sep])
        np.testing.assert_allclose(gr[sep, :4], wr[:k][sep, :4], rtol=0,
                                   atol=BOX_TOL)
        if gaps[-1] <= 10 * SCORE_TOL:
            unclear |= {int(wl[k - 1]), int(wl[k])}
    return unclear


def det_class_clear(want, annotations, iou_thrs=(0.5,)) -> np.ndarray:
    """Per class, whether JAX's det results (cut to k) take every decision
    of ``eval_map`` by a clear margin: no detection's IoU with a GT of its
    class within IOU_MARGIN of a threshold, and no two scores of which one
    can match a GT within 10x SCORE_TOL."""
    K = len(want[0])
    clear = np.ones(K, bool)
    for c in range(K):
        scores, hit = [], []
        for per_class, ann in zip(want, annotations):
            d = np.asarray(per_class[c], np.float64).reshape(-1, 5)
            gts = np.asarray(ann["bboxes"], np.float64)[
                np.asarray(ann["labels"]) == c]
            iou = _iou(d[:, :4], gts)
            for t in iou_thrs:
                clear[c] &= not (np.abs(iou - t) <= IOU_MARGIN).any()
            scores.append(d[:, 4])
            hit.append((iou >= min(iou_thrs) - IOU_MARGIN).any(1)
                       if gts.size else np.zeros(len(d), bool))
        s, h = np.concatenate(scores), np.concatenate(hit)
        order = np.argsort(-s, kind="mergesort")
        s, h = s[order], h[order]
        near = (s[:-1] - s[1:]) <= 10 * SCORE_TOL
        clear[c] &= not (near & (h[:-1] | h[1:])).any()
    return clear


def _iou(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-12)


def seg_clear_mask(logits: np.ndarray) -> np.ndarray:
    """Where JAX's top two logits (the last axis) are more than 10x
    SEG_TOL apart."""
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > 10 * SEG_TOL


def check_seg(got, want, want_logits) -> list:
    """Label maps equal wherever JAX's margin is clear (and JAX's its
    logits' argmax); returns the clear masks."""
    masks = []
    for g, w, lg in zip(got, want, want_logits):
        assert g.shape == w.shape == lg.shape[:2]
        m = seg_clear_mask(lg)
        np.testing.assert_array_equal(g[m], w[m])
        np.testing.assert_array_equal(w, lg.argmax(-1))
        masks.append(m)
    return masks


def metrics_match_where_clear(ds, jds, res, jres, jres_more, seg_logits,
                              min_clear=0.5) -> dict:
    """Each package's metrics from its own results (``res`` the port's,
    ``jres`` JAX's, ``jres_more`` JAX's det at ``max_per_img + 1``,
    ``seg_logits`` JAX's per-image logits at each original size), equal
    over what every decision margin makes clear: the cls images whose
    top-k membership is clear, the det classes whose every AP decision and
    cut is, the seg pixels whose argmax is (the rest set to the ignore
    index); a dataset's whole metrics where all of it is clear. At least
    ``min_clear`` of the cls images and det classes, and 99% of the seg
    pixels, must be clear. Returns what was cleared, per dataset."""
    from rscotr_tpu import evaluation as J
    from rscotr_tpu_torch import evaluation as P
    cleared = {}
    for name, d in ds.items():
        jd = jds[name]
        if d.task == "cls":
            labels = np.array([jd[i]["gt_label"] for i in range(
                len(res[name]))])
            for k in (1, 5):
                m = cls_clear_mask(jres[name], k)
                cleared[f"{name} top-{k} images"] = f"{m.sum()}/{m.size}"
                assert m.mean() >= min_clear, cleared
                same_metrics(
                    P.top_k_accuracy(np.stack(res[name])[m], labels[m], (k,)),
                    J.top_k_accuracy(np.stack(jres[name])[m], labels[m],
                                     (k,)))
        elif d.task == "det":
            names = d.CLASSES
            clear = det_class_clear(jres[name],
                                    jd.get_annotations()[:len(jres[name])])
            for c in check_det(res[name], jres_more[name]):
                clear[c] = False
            cleared[f"{name} classes"] = f"{clear.sum()}/{clear.size}"
            assert clear.mean() >= min_clear, cleared
            got = d.evaluate(res[name], classwise=True)
            want = jd.evaluate(jres[name], classwise=True)
            same_metrics({n: got[f"bbox_AP_{n}"]
                          for c, n in enumerate(names) if clear[c]},
                         {n: want[f"bbox_AP_{n}"]
                          for c, n in enumerate(names) if clear[c]})
            if clear.all():
                same_metrics(got, want)
        else:
            masks = check_seg(res[name], jres[name], seg_logits[name])
            frac = float(np.mean([m.mean() for m in masks]))
            cleared[f"{name} pixels"] = f"{frac:.4f}"
            assert frac > 0.99, cleared

            def pre(results, package):
                return [package.intersect_and_union(
                    r, np.where(m, d.get_gt_seg_map(i), d.ignore_index),
                    len(d.CLASSES), d.ignore_index)
                    for i, (r, m) in enumerate(zip(results, masks))]
            kw = dict(metric=["mIoU", "mFscore"], classwise=True)
            same_metrics(d.evaluate(pre(res[name], P), **kw),
                         jd.evaluate(pre(jres[name], J), **kw))
            if all(m.all() for m in masks):
                same_metrics(d.evaluate(res[name], **kw),
                             jd.evaluate(jres[name], **kw))
    return cleared
