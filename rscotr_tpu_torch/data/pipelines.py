"""Host-side test-time transforms (numpy / PIL; counterpart of the test
subset of rscotr_tpu/data/pipelines.py).

Each transform is ``__call__(results: dict, rng: np.random.Generator)``.
``results`` carries ``img`` (H, W, 3 float32 RGB), optional ``gt_label`` /
``gt_bboxes`` (N, 4 xyxy) / ``gt_labels`` / ``gt_semantic_seg``, and the
meta keys ``ori_shape``, ``img_shape``, ``scale_factor``, ``flip``.

Ported: ``LoadImageFromFile`` (PIL decode; the JAX package's native decoder,
``csrc/image_core.cpp``, is not ported), ``Resize``, ``RandomFlip``,
``Pad``, ``Normalize``, which is every op of the configs' val / test
pipelines. The training transforms wait for ROADMAP M8 and the
device-augment planners for ROADMAP M6: ``build_pipeline`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image

from rscotr_tpu_torch.utils.registry import PIPELINES

DEFAULT_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
DEFAULT_STD = np.array([58.395, 57.12, 57.375], np.float32)

# the JAX package's training transforms (ROADMAP M8) and device-augment
# planners (ROADMAP M6), not ported yet
TRAIN_ONLY = ("RandomResizedCrop", "RandomCrop", "PhotoMetricDistortion",
              "RandomErasing", "RandAugment", "AutoAugment")
PLANNERS = ("DeviceAugmentPlanner", "SegDeviceAugmentPlanner",
            "DetDeviceAugmentPlanner")
# torch-format bundling steps: the loaders batch numpy directly
_SKIP = ("LoadAnnotations", "DefaultFormatBundle", "ImageToTensor",
         "ToTensor", "Collect", "MultiScaleFlipAug")


def _resize_img(img, hw, interpolation="bilinear"):
    order = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
             "nearest": Image.NEAREST}[interpolation]
    im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    return np.asarray(im.resize((hw[1], hw[0]), order), np.float32)


def _resize_seg(seg, hw):
    im = Image.fromarray(seg.astype(np.uint8)).resize(
        (hw[1], hw[0]), Image.NEAREST)
    return np.asarray(im, seg.dtype)


@PIPELINES.register_module(name="Normalize")
class Normalize:
    def __init__(self, mean=DEFAULT_MEAN, std=DEFAULT_STD, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        # to_rgb: images are decoded as RGB already (mmcv decodes BGR)

    def __call__(self, results, rng=None):
        results["img"] = (results["img"] - self.mean) / self.std
        return results


@PIPELINES.register_module(name="Resize")
class Resize:
    """mmdet / mmseg resize. ``keep_ratio``: scale so the long side is at
    most ``max(img_scale)`` and the short side at most ``min(img_scale)``;
    ``ratio_range`` draws a multiplier of the scale first; a list of
    scales picks one; ``size`` without ``keep_ratio`` is the exact size."""

    def __init__(self, img_scale=None, size=None, keep_ratio=True,
                 ratio_range=None, multiscale_mode="range",
                 override=False, interpolation="bilinear", backend=None):
        self.img_scale = img_scale or size
        self.keep_ratio = keep_ratio
        self.ratio_range = ratio_range
        self.interpolation = interpolation

    def draw_new_hw(self, h, w, rng):
        scale = self.img_scale
        if (isinstance(scale, (list, tuple)) and len(scale) and
                isinstance(scale[0], (list, tuple))):
            i = int(rng.integers(0, len(scale))) if rng is not None else 0
            scale = tuple(scale[i])
        if self.ratio_range is not None:
            lo, hi = self.ratio_range
            r = rng.uniform(lo, hi) if rng is not None else 1.0
            scale = (int(scale[0] * r), int(scale[1] * r))
        if self.keep_ratio:
            long_side, short_side = max(scale), min(scale)
            f = min(long_side / max(h, w), short_side / min(h, w))
            return (int(h * f + 0.5), int(w * f + 0.5))
        return (scale[0], scale[1]) if isinstance(scale, (tuple, list)) \
            else (scale, scale)

    def __call__(self, results, rng=None):
        img = results["img"]
        h, w = img.shape[:2]
        new_hw = self.draw_new_hw(h, w, rng)
        wf = new_hw[1] / w
        hf = new_hw[0] / h
        results["img"] = _resize_img(img, new_hw, self.interpolation)
        results["img_shape"] = results["img"].shape
        sf = np.array([wf, hf, wf, hf], np.float32)
        # cumulative across repeated resizes
        results["scale_factor"] = np.asarray(
            sf * results.get("scale_factor", 1.0), np.float32)
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            results["gt_bboxes"] = results["gt_bboxes"] * sf
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = _resize_seg(
                results["gt_semantic_seg"], new_hw)
        return results


@PIPELINES.register_module(name="RandomFlip")
class RandomFlip:
    def __init__(self, prob=0.5, flip_prob=None, flip_ratio=None,
                 direction="horizontal"):
        self.prob = flip_prob if flip_prob is not None else \
            (flip_ratio if flip_ratio is not None else prob)
        self.direction = direction

    def __call__(self, results, rng=None):
        do = rng.uniform() < self.prob if (rng is not None and
                                           self.prob) else False
        results["flip"] = bool(do)
        results["flip_direction"] = self.direction
        if not do:
            return results
        img = results["img"]
        if self.direction == "horizontal":
            results["img"] = img[:, ::-1].copy()
            if "gt_bboxes" in results and len(results["gt_bboxes"]):
                w = img.shape[1]
                b = results["gt_bboxes"].copy()
                b[:, [0, 2]] = w - results["gt_bboxes"][:, [2, 0]]
                results["gt_bboxes"] = b
            if "gt_semantic_seg" in results:
                results["gt_semantic_seg"] = \
                    results["gt_semantic_seg"][:, ::-1].copy()
        else:
            results["img"] = img[::-1].copy()
            if "gt_semantic_seg" in results:
                results["gt_semantic_seg"] = \
                    results["gt_semantic_seg"][::-1].copy()
        return results


@PIPELINES.register_module(name="Pad")
class Pad:
    def __init__(self, size=None, size_divisor=None, pad_val=0,
                 seg_pad_val=255):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def __call__(self, results, rng=None):
        img = results["img"]
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
        pad_h, pad_w = max(th - h, 0), max(tw - w, 0)
        results["img"] = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)),
                                constant_values=self.pad_val)
        results["pad_shape"] = results["img"].shape
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = np.pad(
                results["gt_semantic_seg"], ((0, pad_h), (0, pad_w)),
                constant_values=self.seg_pad_val)
        return results


@PIPELINES.register_module(name="LoadImageFromFile")
class LoadImageFromFile:
    """Decodes ``img_path`` with PIL to float32 RGB. Passes a sample through
    when it carries a decoded ``img`` and no ``img_path``."""

    def __call__(self, results, rng=None):
        path = results.get("img_path")
        if path is None:
            if "img" not in results:
                raise KeyError("LoadImageFromFile: sample has neither "
                               "'img_path' nor a decoded 'img'")
            return results
        with Image.open(path) as im:
            results["img"] = np.asarray(im.convert("RGB"), np.float32)
        results["ori_shape"] = results["img"].shape
        results["img_shape"] = results["img"].shape
        return results


def split_normalize_cfg(cfgs: Sequence[dict]):
    """(the pipeline config without its Normalize op, that op's
    ``{"mean", "std"}`` or None): device-side preprocessing ships uint8
    images and normalizes on the card."""
    out, norm = [], None
    for c in cfgs:
        if c.get("type") == "Normalize":
            norm = {"mean": list(c.get("mean", DEFAULT_MEAN)),
                    "std": list(c.get("std", DEFAULT_STD))}
        else:
            out.append(c)
    return out, norm


def build_pipeline(cfgs: Sequence[dict]) -> List:
    """The transforms of a reference-shaped pipeline config: bundling steps
    skipped, ``MultiScaleFlipAug``'s transforms inlined."""
    out = []
    for c in cfgs:
        c = dict(c)
        t = c.pop("type")
        if t in _SKIP:
            if t == "MultiScaleFlipAug":
                out.extend(build_pipeline(c.get("transforms", [])))
            continue
        if t in TRAIN_ONLY:
            raise NotImplementedError(
                f"pipeline op {t!r}: the training transforms are not ported "
                "to rscotr_tpu_torch yet (ROADMAP M8)")
        if t in PLANNERS:
            raise NotImplementedError(
                f"pipeline op {t!r}: on-device augmentation is not ported "
                "to rscotr_tpu_torch yet (ROADMAP M6)")
        out.append(PIPELINES.build({"type": t, **c}))
    return out


def run_pipeline(transforms, results, rng):
    for t in transforms:
        results = t(results, rng)
    return results
