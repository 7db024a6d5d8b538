"""Config-level entry points of the port (PyTorch counterpart of
``make_step_config``, ``derive_img_norm`` and the cls size of
``derive_shapes`` in rscotr_tpu/apis.py, written out again here because
that module imports jax).

``make_step_config(cfg)`` derives the ``TrainStepConfig`` from a composed
config (``utils.config.load_cfg``): task weights, the CDN setup with the
static DN group width ``dn_max_gt = min(20, max_gt)`` (5 groups, pad 200 for
the flagship), the DINO loss and matcher weights, the cls label smoothing
and batch augments, and the device-side normalization stats.
"""

from __future__ import annotations

from typing import Optional, Tuple

from rscotr_tpu_torch.engine.train_step import TrainStepConfig
from rscotr_tpu_torch.models.heads.cdn import CdnConfig
from rscotr_tpu_torch.models.heads.dino_loss import DetLossConfig

_IMAGENET = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
_DEVICE_AUG = ("cls_device_augment", "seg_device_augment",
               "det_device_augment")


def derive_img_norm(cfg: dict) -> Optional[Tuple[tuple, tuple]]:
    """(mean, std) for device-side preprocessing, from the Normalize op of
    any dataset whose loader sets device_preprocess; ImageNet stats when
    such a loader's pipelines carry none; None when no loader asks."""
    found, asked = None, False
    for entry in cfg.get("data", {}).values():
        opts = dict(entry.get("loader", {}))
        if not opts.get("device_preprocess"):
            continue
        asked = True
        for split in ("train", "val", "test"):
            dcfg = entry["data"].get(split) or {}
            for op in dcfg.get("pipeline", []) or []:
                if op.get("type") == "Normalize":
                    norm = (tuple(op.get("mean")), tuple(op.get("std")))
                    if found is not None and found != norm:
                        raise ValueError(
                            "device_preprocess with mixed img_norm stats "
                            f"is unsupported: {found} vs {norm}")
                    found = norm
    return found if found is not None or not asked else _IMAGENET


def derive_cls_hw(cfg: dict) -> Optional[Tuple[int, int]]:
    """The cls input size of a composed config, as ``derive_shapes`` takes
    it: the last cls dataset's ``loader.cls_size`` (224 when the loader
    sets none); None when the config has no cls dataset. ``build_model``
    takes it as ``cls_hw`` to size an ``MlvlClsHead`` of scheme 5, 6 or
    7."""
    hw = None
    for entry in cfg.get("data", {}).values():
        if entry["task"] == "cls":
            s = dict(entry.get("loader", {})).get("cls_size", 224)
            hw = (s, s)
    return hw


def make_step_config(cfg: dict) -> TrainStepConfig:
    model_cfg = cfg["model"]
    for entry in cfg.get("data", {}).values():
        opts = dict(entry.get("loader", {}))
        wanted = [k for k in _DEVICE_AUG if opts.get(k)]
        if wanted:
            raise NotImplementedError(
                f"loader options {wanted}: on-device augmentation is not "
                "ported to rscotr_tpu_torch yet (ROADMAP M6)")
    tw = dict(model_cfg.get("task_weight", {"cls": 1, "det": 1, "seg": 1}))
    cdn_cfg = det_cfg = None
    if model_cfg.get("bbox_head"):
        bh = model_cfg["bbox_head"]
        dn = bh.get("dn_cfg", {}) or {}
        gc = dn.get("group_cfg", {}) or {}
        ns = dn.get("noise_scale", {}) or {}
        max_gt = 100
        for entry in cfg.get("data", {}).values():
            if entry["task"] == "det":
                max_gt = dict(entry.get("loader", {})).get("max_gt", 100)
        cdn_cfg = CdnConfig(
            num_classes=bh.get("num_classes", 20),
            num_queries=bh.get("num_query", 600),
            max_gt=max_gt,
            num_dn_queries=gc.get("num_dn_queries", 100) or 100,
            label_noise_scale=ns.get("label", 0.5),
            box_noise_scale=ns.get("box", 1.0),
            dn_max_gt=min(gc.get("dn_max_gt", 20), max_gt))
        lc = bh.get("loss_cls", {}) or {}
        lb = bh.get("loss_bbox", {}) or {}
        li = bh.get("loss_iou", {}) or {}
        tc = (model_cfg.get("train_cfg", {}) or {}).get("det", {}) or {}
        asn = tc.get("assigner", {}) or {}
        det_cfg = DetLossConfig(
            num_classes=bh.get("num_classes", 20),
            loss_cls_weight=lc.get("loss_weight", 1.0),
            loss_bbox_weight=lb.get("loss_weight", 5.0),
            loss_iou_weight=li.get("loss_weight", 2.0),
            cost_cls_weight=(asn.get("cls_cost", {}) or {}).get(
                "weight", 2.0),
            cost_bbox_weight=(asn.get("reg_cost", {}) or {}).get(
                "weight", 5.0),
            cost_iou_weight=(asn.get("iou_cost", {}) or {}).get(
                "weight", 2.0),
            focal_alpha=lc.get("alpha", 0.25),
            focal_gamma=lc.get("gamma", 2.0))

    cls_cfg = model_cfg.get("cls_head") or {}
    loss_cfg = cls_cfg.get("loss", {}) or {}
    train_cls = (model_cfg.get("train_cfg", {}) or {}).get("cls", {}) or {}
    return TrainStepConfig(
        task_weight=tw,
        cls_num_classes=cls_cfg.get("num_classes", 45),
        cls_label_smooth=loss_cfg.get("label_smooth_val", 0.1),
        cls_use_augments=bool(train_cls.get("augments")),
        seg_ignore_index=255,
        cdn=cdn_cfg, det=det_cfg,
        img_norm=derive_img_norm(cfg))
