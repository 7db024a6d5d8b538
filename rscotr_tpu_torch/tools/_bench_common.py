"""Synthetic batches of the port's benchmark (PyTorch counterpart of the
root ``tools/_bench_common.py``, which imports jax).

``derive_shapes`` reads each task's batch shape from the config's loader
entries (``samples_per_gpu``, ``cls_size``, ``det_bucket_hw``, ``max_gt``,
``seg_size``), CLI flags winning. ``make_batch_fns`` draws numpy arrays from
the caller's ``np.random.Generator`` in the root tool's order, draw for
draw, and hands them over as torch tensors on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch


def derive_shapes(cfg: dict, overrides=None):
    """Per-task batch shapes from the config's loader entries; ``overrides``
    is an optional {task: {"bs"/"size": int}} (CLI flags win)."""
    shapes = {"cls": dict(bs=16, size=224),
              "det": dict(bs=1, size=800, max_gt=100),
              "seg": dict(bs=2, size=512)}
    for entry in cfg["data"].values():
        t = entry.get("task")
        if t not in shapes:
            continue
        opts = dict(entry.get("loader", {}) or {})
        shapes[t]["bs"] = int(entry.get("data", {}).get(
            "samples_per_gpu", shapes[t]["bs"]))
        if t == "cls" and "cls_size" in opts:
            shapes[t]["size"] = int(opts["cls_size"])
        if t == "det":
            if "det_bucket_hw" in opts:
                shapes[t]["size"] = int(opts["det_bucket_hw"][0])
            shapes[t]["max_gt"] = int(opts.get("max_gt", 100))
        if t == "seg" and "seg_size" in opts:
            shapes[t]["size"] = int(opts["seg_size"])
    for t, ov in (overrides or {}).items():
        for k, v in ov.items():
            if v:
                shapes[t][k] = v
    return shapes


def make_batch_fns(shapes, rng: np.random.Generator, num_classes=None,
                   device="cpu"):
    """{task: fn(i) -> batch dict of tensors on ``device``} at the derived
    shapes. ``num_classes``: optional {"cls"/"det"/"seg": int} label
    ranges."""
    nc = {"cls": 2, "det": 2, "seg": 3}
    nc.update(num_classes or {})

    def on(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    def cls_batch(i):
        bs, S = shapes["cls"]["bs"], shapes["cls"]["size"]
        return {"img": on(rng.normal(size=(bs, S, S, 3)).astype(np.float32)),
                "gt_label": on(rng.integers(0, nc["cls"], size=(bs,))
                               .astype(np.int32))}

    def det_batch(i):
        bs, S, G = (shapes["det"]["bs"], shapes["det"]["size"],
                    shapes["det"]["max_gt"])
        cx = rng.uniform(0.2, 0.8, size=(bs, G))
        cy = rng.uniform(0.2, 0.8, size=(bs, G))
        wh = rng.uniform(0.05, 0.2, size=(bs, G, 2))
        boxes = np.stack([(cx - wh[..., 0] / 2) * S,
                          (cy - wh[..., 1] / 2) * S,
                          (cx + wh[..., 0] / 2) * S,
                          (cy + wh[..., 1] / 2) * S], -1).astype(np.float32)
        return {"img": on(rng.normal(size=(bs, S, S, 3)).astype(np.float32)),
                "img_hw": on(np.asarray([[S, S]] * bs, np.int32)),
                "scale_factor": on(np.ones((bs, 4), np.float32)),
                "gt_bboxes": on(boxes),
                "gt_labels": on(rng.integers(0, nc["det"], size=(bs, G))
                                .astype(np.int32)),
                "gt_valid": on((np.arange(G)[None] < min(10, G))
                               .repeat(bs, 0))}

    def seg_batch(i):
        bs, S = shapes["seg"]["bs"], shapes["seg"]["size"]
        return {"img": on(rng.normal(size=(bs, S, S, 3)).astype(np.float32)),
                "img_hw": on(np.asarray([[S, S]] * bs, np.int32)),
                "gt_semantic_seg": on(rng.integers(0, nc["seg"],
                                                   size=(bs, S, S))
                                      .astype(np.int32))}

    return {"cls": cls_batch, "det": det_batch, "seg": seg_batch}
