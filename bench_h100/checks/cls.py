"""Scene classification: the class probabilities of every chip, and what
the serve driver needs of the cls entry (``prepare``, ``to_host``,
``count``)."""

from __future__ import annotations

import torch

from bench_h100.counts import mtl as mtl_counts
from bench_h100.reference import mtl as ref

BLOCK = 64


def prepare(model, fn, traffic, keep):
    """-> call(pixels): the cls entry on one request (nothing to hook)."""
    return fn


def to_host(out):
    return {"probs": out.cpu()}


def count(mcfg, traffic):
    """FLOPs and kernel calls of one request."""
    return mtl_counts.cls(mcfg, int(traffic["batch"]), *traffic["image_hw"])


def reference(imgs, P, mcfg, mode, traffic):
    pr = ref.Precision(mode)
    return {"probs": torch.cat([ref.cls_probs(imgs[i:i + BLOCK], P, mcfg, pr)
                                for i in range(0, imgs.shape[0], BLOCK)])}


def compare(imgs, outs, P, mcfg, traffic):
    """``prob_gap``: the largest difference of a class probability from
    the float32 reference's, over every chip and class."""
    want = reference(imgs, P, mcfg, "f32", traffic)["probs"]
    got = outs["probs"].to(want.device).float()
    if got.shape != want.shape:
        return {"prob_gap": float("inf")}
    return {"prob_gap": float((got - want).abs().max())}
