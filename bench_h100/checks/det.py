"""Detection over tiles: boxes, scores and labels of every tile.

The two-stage head keeps the ``num_query`` proposals with the largest
class logit, in that order, and slot ``i`` of the decoder adds the
learned query ``i`` to proposal ``i``. Proposal logits lie within
thousandths of each other, so a rounding of the program's bfloat16
reorders them, and a reordered slot decodes to another box: served
answers cannot be compared with a reference that makes its own choice.
The reference therefore follows the program's two discrete choices,
which it reads from the head's outputs (a forward hook on the head keeps
them for the sampled requests): which proposal sits in which slot, and
which slot and class each served detection is. Each choice is checked by
itself against the reference's own scores, and every value the reference
compares it computes again in float32 from the pixels and the weights.

Numbers, each the widest over the request's tiles:

* ``enc_gap``: a selected proposal's class logits and box (sigmoid)
  against the reference proposal nearest to it, L-infinity;
* ``cut_gap``: how far the reference's largest logit of the weakest
  selected proposal lies below the reference's own ``num_query``-th;
* ``box_gap``: the last decoder layer's boxes (normalised cxcywh), slot
  by slot, against the reference decoding the same proposals in the same
  slots;
* ``det_gap``: each served detection against the reference's candidate
  of its slot and class: the larger of the score difference and the box
  difference over the tile's side; a served detection that is no slot's
  output, or one served twice, reads infinity;
* ``topk_gap``: an exact check of which detections are served and in what
  order, against the program's own last-layer logits: how far the best
  (slot, class) pair left out scores above the weakest one served, and
  how far a served score rises above the one served before it. Both are 0
  when the served set is the top ``max_per_img`` of the sigmoid scores
  (ties either way) in descending order; the limit is 0.

The widest gap of the last layer's class logits and the served set's
distance below the reference's own top ``max_per_img`` were read too, and
are not compared: float8 read less than three times what the program's
bfloat16 does on them (PERF.md), so no limit separates the two.

The module also holds what the serve driver needs of the det entry: its
call on one request (``prepare``, which also hooks the head), its outputs
on the host (``to_host``) and the FLOPs and kernel calls of a request
(``count``).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.counts import mtl as mtl_counts
from bench_h100.reference import mtl as ref

BLOCK = 4
NUMBERS = ("enc_gap", "cut_gap", "box_gap", "det_gap", "topk_gap")


def prepare(model, fn, traffic, keep):
    """-> call(pixels): the det entry on one request. While ``keep["on"]``,
    a forward hook on the head keeps its outputs in ``keep["out"]``."""
    hw = np.array([traffic["image_hw"]] * int(traffic["batch"]),
                  dtype=np.int64)

    def hook(_m, _i, out):
        if keep["on"]:
            keep["out"] = {"topk_score": out[2], "topk_anchor": out[3],
                           "last_cls": out[0][-1], "last_box": out[1][-1]}
    model.bbox_head.register_forward_hook(hook)
    return lambda x: fn(x, hw)


def to_host(out):
    return {"bboxes": out[0].cpu(), "labels": out[1].cpu()}


def count(mcfg, traffic):
    """FLOPs and kernel calls of one request."""
    return mtl_counts.det(mcfg, int(traffic["batch"]), *traffic["image_hw"])


def reference(imgs, P, mcfg, mode, traffic):
    """The reference's own serving forward, in the program's output
    format (the control, with ``mode="fp8"``)."""
    pr = ref.Precision(mode)
    parts = [ref.det_serve(imgs[i:i + BLOCK], P, mcfg, pr,
                           traffic["max_per_img"])
             for i in range(0, imgs.shape[0], BLOCK)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _served_slots(out, H, W):
    """The slot of each served detection: the slot whose output under the
    served class gives the served score and box (to rounding); -1 where
    none does."""
    side = float(max(H, W))
    score = out["last_cls"].float().sigmoid()            # (b, Nq, K)
    lab = out["labels"].long()
    got = out["bboxes"].float()
    nq = score.shape[1]
    cand = score.gather(2, lab[:, None, :].expand(-1, nq, -1))  # (b, Nq, M)
    px = ref.to_pixels(out["last_box"].float(), H, W)    # (b, Nq, 4)
    d = torch.maximum((cand - got[:, None, :, 4]).abs(),
                      (px[:, :, None, :] - got[:, None, :, :4]).abs()
                      .amax(-1) / side)
    near, slot = d.min(1)                                 # (b, M)
    slot = torch.where(near <= 1e-3, slot, torch.full_like(slot, -1))
    return slot


def _gaps(img, out, P, mcfg):
    f32 = ref.Precision("f32")
    enc = ref.det_encode_images(img, P, mcfg, f32)
    nq = mcfg["bbox_head"]["num_query"]
    r_cls, r_box = enc["enc_cls"], enc["enc_coord"].sigmoid()
    u = torch.cat([out["topk_score"].float(), out["topk_anchor"].float()], -1)
    r = torch.cat([r_cls, r_box], -1)
    near, match = torch.cdist(u, r, p=float("inf")).min(-1)
    top = r_cls.max(-1).values
    cut = top.topk(nq, dim=1).values[:, -1]
    cut_gap = (cut - top.gather(1, match).min(1).values).clamp(min=0)
    cls, boxes = ref.det_decode(enc, match, P, mcfg, f32)
    box_gap = (out["last_box"].float() - boxes).abs()
    side = float(max(img.shape[1], img.shape[2]))
    slot = _served_slots(out, img.shape[1], img.shape[2])
    lab = out["labels"].long()
    got = out["bboxes"].float()
    M = got.shape[1]
    scores = cls.sigmoid()
    px = ref.to_pixels(boxes, img.shape[1], img.shape[2])
    s_ = slot.clamp(min=0)
    want_s = scores[torch.arange(len(s_))[:, None], s_, lab]      # (b, M)
    want_b = px.gather(1, s_[..., None].expand(-1, -1, 4))        # (b, M, 4)
    det_gap = torch.maximum((want_s - got[..., 4]).abs(),
                            (want_b - got[..., :4]).abs().amax(-1) / side)
    key = slot * scores.shape[-1] + lab
    twice = torch.tensor([len(set(k.tolist())) != M for k in key])
    det_gap = torch.where((slot < 0) | twice[:, None].to(slot.device),
                          torch.full_like(det_gap, float("inf")), det_gap)
    return {"enc_gap": float(near.max()), "cut_gap": float(cut_gap.max()),
            "box_gap": float(box_gap.max()), "det_gap": float(det_gap.max()),
            "topk_gap": _topk_gap(out, slot)}


def _topk_gap(out, slot):
    """How far the served set and order depart from the top ``M`` of the
    program's own sigmoid scores (0 when they do not); infinity where a
    served detection is no slot's output or is served twice."""
    score = out["last_cls"].float().sigmoid()
    b, _, K = score.shape
    score = score.reshape(b, -1)
    key = slot * K + out["labels"].long()
    M = key.shape[1]
    if bool((slot < 0).any()) or any(len(set(k.tolist())) != M for k in key):
        return float("inf")
    served = torch.zeros_like(score, dtype=torch.bool).scatter_(1, key, True)
    weakest = score.gather(1, key).amin(1)
    left_out = score.masked_fill(served, float("-inf")).amax(1)
    s = out["bboxes"][..., 4].float()
    rise = (s[:, 1:] - s[:, :-1]).amax(1) if M > 1 else torch.zeros(b)
    return float(torch.maximum((left_out - weakest).clamp(min=0),
                               rise.clamp(min=0)).max())


def compare(imgs, outs, P, mcfg, traffic):
    dev = imgs.device
    B, M = imgs.shape[0], traffic["max_per_img"]
    h = mcfg["bbox_head"]
    nq, K = h["num_query"], h["num_classes"]
    want = {"bboxes": (B, M, 5), "labels": (B, M),
            "topk_score": (B, nq, K), "topk_anchor": (B, nq, 4),
            "last_cls": (B, nq, K), "last_box": (B, nq, 4)}
    if any(k not in outs or tuple(outs[k].shape) != s
           for k, s in want.items()):
        return {k: float("inf") for k in NUMBERS}
    res = {}
    for i in range(0, B, BLOCK):
        sl = {k: v[i:i + BLOCK].to(dev) for k, v in outs.items()}
        g = _gaps(imgs[i:i + BLOCK], sl, P, mcfg)
        res = {k: max(res.get(k, 0.0), v) for k, v in g.items()}
    return res
