"""Semantic segmentation over tiles: the label map of every tile, served by
the seg entry of a Mask2Former head (scheme 3).

Before each decoder layer the program thresholds the previous layer's
resized mask logits at sigmoid 0.5 to get the layer's attention mask. A
rounding of the program's bfloat16 moves logits near the threshold to the
other side, and a flipped bit changes what the next layer attends to:
served answers cannot be compared with a reference that makes its own
masks. The reference therefore follows the program's discrete choices,
which forward hooks keep for the sampled requests: each decoder layer's
attention mask (a pre-hook on the layer), the head's class and mask logits
(a hook on the head) and the semantic scores (a hook on the head's
``semantic`` module). Every value compared is computed again in float32
from the pixels and the weights, each layer attending under the program's
mask.

Numbers, over the request's tiles (the widest gap; the share of all
bits):

* ``mask_gap``: the last layer's mask logits (B, Q, H/4, W/4), L-infinity;
* ``cls_gap``: the class probabilities (softmax of the last layer's class
  logits, no-object included), L-infinity;
* ``sem_gap``: the semantic scores (B, H, W, K) at the tile size, at every
  ``STEP``-th row and column (a step of 5 meets every phase of the 4x
  upsampling), L-infinity;
* ``flip_share``: the share of all layers' attention-mask bits where the
  reference's own threshold, on its own logits under the program's earlier
  masks, disagrees with the program's mask;
* ``label_gap``: an exact check that the served label map is the argmax of
  the program's own scores: over every pixel, 0 where the served label is
  the largest score, the lead of the largest over the second where it is
  the second (0 on a tie), infinity where it is neither. The limit is 0.

The module also holds what the serve driver needs of the seg entry
(``prepare``, ``to_host``, ``count``).
"""

from __future__ import annotations

import torch

from bench_h100.counts import mask2former as m2f_counts
from bench_h100.reference import mask2former as ref

BLOCK = 4
STEP = 5
NUMBERS = ("mask_gap", "cls_gap", "sem_gap", "flip_share", "label_gap")


def _head_cfg(mcfg):
    return mcfg.get("decode_head") or mcfg["seg_head"]


def prepare(model, fn, traffic, keep):
    """-> call(pixels): the seg entry on one request. While ``keep["on"]``
    the hooks keep the head's outputs, every decoder layer's attention
    mask (one head's copy: the heads share it) and the scores' samples in
    ``keep["out"]``."""
    head = model.seg_head
    masks = []

    def clear(_m, _i):
        masks.clear()

    def layer_mask(_m, _a, kw):
        if keep["on"]:
            am = kw["cross_attn_mask"]
            B = am.shape[0] // head.num_heads
            masks.append(am.reshape(B, head.num_heads, *am.shape[1:])[:, 0])

    def outputs(_m, _i, out):
        if keep["on"]:
            keep["out"] = {"cls_logits": out[0], "mask_logits": out[1]}
            keep["out"].update({f"attn_mask.{i}": m
                                for i, m in enumerate(masks)})

    def scores(_m, _i, s):
        if keep["on"]:
            top = s.topk(2, dim=-1)
            keep["out"].update(sem_sub=s[:, ::STEP, ::STEP].contiguous(),
                               top_val=top.values,
                               top_idx=top.indices.to(torch.int16))

    head.register_forward_pre_hook(clear)
    for layer in head.transformer_decoder.layers:
        layer.register_forward_pre_hook(layer_mask, with_kwargs=True)
    head.register_forward_hook(outputs)
    head.semantic.register_forward_hook(scores)
    return fn


def to_host(out):
    return {"labels": out.cpu()}


def count(mcfg, traffic):
    """FLOPs and kernel calls of one request."""
    return m2f_counts.seg(mcfg, int(traffic["batch"]), *traffic["image_hw"])


def reference(imgs, P, mcfg, mode, traffic):
    """The reference's own serving forward, in the program's output
    format (the control, with ``mode="fp8"``)."""
    pr = ref.Precision(mode)
    parts = [ref.serve(imgs[i:i + BLOCK], P, mcfg, pr, STEP)
             for i in range(0, imgs.shape[0], BLOCK)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _shapes(mcfg, B, H, W):
    h = _head_cfg(mcfg)
    Q, K = h["num_queries"], h["num_classes"]
    L = h["num_transformer_feat_level"]
    # the encoder's levels, low -> high resolution: strides 32, 16, 8
    side = [(-(-H // s), -(-W // s)) for s in (4, 8, 16, 32)]
    hw = [a * b for a, b in reversed(side[-L:])]
    want = {"labels": (B, H, W), "cls_logits": (B, Q, K + 1),
            "mask_logits": (B, Q) + side[0],
            "sem_sub": (B, -(-H // STEP), -(-W // STEP), K),
            "top_val": (B, H, W, 2), "top_idx": (B, H, W, 2)}
    for i in range(h["transformer_decoder"]["num_layers"]):
        want[f"attn_mask.{i}"] = (B, Q, hw[i % L])
    return want


def label_gap(labels, top_val, top_idx) -> float:
    """0 where each served label is the largest score (ties either way);
    see the module's docstring."""
    lab = labels.long()
    first = lab == top_idx[..., 0].long()
    second = lab == top_idx[..., 1].long()
    lead = (top_val[..., 0] - top_val[..., 1]).float()
    gap = torch.where(first, torch.zeros_like(lead),
                      torch.where(second, lead,
                                  torch.full_like(lead, float("inf"))))
    return float(gap.max())


def _gaps(img, out, P, mcfg):
    f32 = ref.Precision("f32")
    layers = _head_cfg(mcfg)["transformer_decoder"]["num_layers"]
    masks = [out[f"attn_mask.{i}"].bool() for i in range(layers)]
    r = ref.forward(img, P, mcfg, f32, masks)
    scores = ref.semantic(r["cls_logits"], r["mask_logits"], img.shape[1:3],
                          f32)[:, ::STEP, ::STEP]
    flips = sum(int((m != o).sum()) for m, o in zip(masks, r["own_masks"]))
    bits = sum(m.numel() for m in masks)
    probs = out["cls_logits"].float().softmax(-1)
    return {
        "mask_gap": float((out["mask_logits"].float() -
                           r["mask_logits"]).abs().max()),
        "cls_gap": float((probs - r["cls_logits"].softmax(-1)).abs().max()),
        "sem_gap": float((out["sem_sub"].float() - scores).abs().max()),
        "flip_share": flips / bits,
        "label_gap": label_gap(out["labels"], out["top_val"],
                               out["top_idx"])}


def compare(imgs, outs, P, mcfg, traffic):
    dev = imgs.device
    B, H, W = imgs.shape[:3]
    want = _shapes(mcfg, B, H, W)
    if any(k not in outs or tuple(outs[k].shape) != s
           for k, s in want.items()):
        return {k: float("inf") for k in NUMBERS}
    res, flips, bits = {}, 0.0, 0
    for i in range(0, B, BLOCK):
        sl = {k: v[i:i + BLOCK].to(dev) for k, v in outs.items()}
        g = _gaps(imgs[i:i + BLOCK], sl, P, mcfg)
        n = sl["labels"].shape[0]
        flips += g.pop("flip_share") * n
        bits += n
        res = {k: max(res.get(k, 0.0), v) for k, v in g.items()}
    res["flip_share"] = flips / bits
    return res
