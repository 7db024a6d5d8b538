"""Host-side data transforms (numpy / PIL; counterpart of
rscotr_tpu/data/pipelines.py).

Each transform is ``__call__(results: dict, rng: np.random.Generator)``.
``results`` carries ``img`` (H, W, 3 float32 RGB), optional ``gt_label`` /
``gt_bboxes`` (N, 4 xyxy) / ``gt_labels`` / ``gt_semantic_seg``, and the
meta keys ``ori_shape``, ``img_shape``, ``scale_factor``, ``flip``.

Every transform of the JAX module is here: the test-time ones
(``LoadImageFromFile`` by PIL, since the JAX package's native decoder
``csrc/image_core.cpp`` waits for ROADMAP M10; ``Resize``, ``RandomFlip``,
``Pad``, ``Normalize``), the training ones (``RandomResizedCrop``,
``RandomCrop``, ``PhotoMetricDistortion``, ``RandomErasing``,
``RandAugment`` with its 15 ops, ``AutoAugment``) and the device-augment
planners
(``DeviceAugmentPlanner``, ``SegDeviceAugmentPlanner``,
``DetDeviceAugmentPlanner``) with the splitters that put them into a
pipeline. A planner draws the parameters of the host transforms it stands
for through their own ``draw_*`` methods and ships the raw uint8 image with
``aug_*`` records; ``ops/device_augment.py`` does the pixel work inside the
train step. Every draw comes from the sample's generator in the JAX
module's order, so the two packages draw the same values from the same
seed, and make the same host pixels.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

from rscotr_tpu_torch.ops.device_augment import RAND_AUG_OP_NAMES
from rscotr_tpu_torch.utils.registry import PIPELINES

DEFAULT_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
DEFAULT_STD = np.array([58.395, 57.12, 57.375], np.float32)
# torch-format bundling steps: the loaders batch numpy directly
_SKIP = ("LoadAnnotations", "DefaultFormatBundle", "ImageToTensor",
         "ToTensor", "Collect", "MultiScaleFlipAug")
# the fill (RGB) of RandAugment's geometric ops
_RA_FILL = (124, 116, 104)


def _to_pil(img: np.ndarray) -> Image.Image:
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def _from_pil(im: Image.Image) -> np.ndarray:
    return np.asarray(im, np.float32)


def _resize_img(img, hw, interpolation="bilinear"):
    order = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
             "nearest": Image.NEAREST}[interpolation]
    return _from_pil(_to_pil(img).resize((hw[1], hw[0]), order))


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
        """(new_h, new_w): the scale draw and the keep-ratio arithmetic,
        shared with the device-augment planners (the same draws)."""
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


@PIPELINES.register_module(name="RandomResizedCrop")
class RandomResizedCrop:
    def __init__(self, size=224, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bicubic", backend=None):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def draw_box(self, h, w, rng):
        """(y, x, ch, cw): the crop distribution, shared with
        ``DeviceAugmentPlanner``; ten tries, then the centre square."""
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            ar = np.exp(rng.uniform(np.log(self.ratio[0]),
                                    np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                y = int(rng.integers(0, h - ch + 1))
                x = int(rng.integers(0, w - cw + 1))
                return y, x, ch, cw
        s = min(h, w)
        return (h - s) // 2, (w - s) // 2, s, s

    def __call__(self, results, rng):
        img = results["img"]
        y, x, ch, cw = self.draw_box(*img.shape[:2], rng)
        results["img"] = _resize_img(img[y:y + ch, x:x + cw], self.size,
                                     self.interpolation)
        results["img_shape"] = results["img"].shape
        return results


@PIPELINES.register_module(name="RandomCrop")
class RandomCrop:
    """A random crop with mmseg's semantics (a fixed ``crop_size``, redrawn
    while one class covers ``cat_max_ratio`` of it) and mmdet's
    (``crop_type='absolute_range'`` draws the size; boxes are shifted,
    clipped and the empty ones dropped)."""

    def __init__(self, crop_size=(512, 512), cat_max_ratio=1.0,
                 ignore_index=255, crop_type="absolute",
                 allow_negative_crop=False):
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop

    def _crop_box(self, shape, rng):
        h, w = shape[:2]
        if self.crop_type == "absolute_range":
            lo, hi = self.crop_size
            ch = min(int(rng.integers(lo, hi + 1)), h)
            cw = min(int(rng.integers(lo, hi + 1)), w)
        else:
            ch = min(self.crop_size[0], h)
            cw = min(self.crop_size[1], w)
        y = int(rng.integers(0, h - ch + 1))
        x = int(rng.integers(0, w - cw + 1))
        return y, x, ch, cw

    def select_seg_box(self, shape, seg, rng, box):
        """mmseg's redraw loop, shared with ``SegDeviceAugmentPlanner``: up
        to 10 redraws until no class but ``ignore_index`` covers
        ``cat_max_ratio`` of the crop."""
        for _ in range(10):
            y, x, ch, cw = box
            labels, cnt = np.unique(seg[y:y + ch, x:x + cw],
                                    return_counts=True)
            cnt = cnt[labels != self.ignore_index]
            if len(cnt) > 1 and cnt.max() / cnt.sum() < self.cat_max_ratio:
                break
            box = self._crop_box(shape, rng)
        return box

    def _crop_bboxes(self, results, box):
        y, x, ch, cw = box
        bboxes = results.get("gt_bboxes")
        if bboxes is None or not len(bboxes):
            return True
        b = bboxes - np.array([x, y, x, y], np.float32)
        b[:, 0::2] = np.clip(b[:, 0::2], 0, cw)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, ch)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        if not keep.any() and not self.allow_negative_crop:
            return False
        results["gt_bboxes"] = b[keep]
        if "gt_labels" in results:
            results["gt_labels"] = np.asarray(results["gt_labels"])[keep]
        return True

    def __call__(self, results, rng):
        img = results["img"]
        box = self._crop_box(img.shape, rng)
        if "gt_bboxes" in results:
            for _ in range(10):
                if self._crop_bboxes(results, box):
                    break
                box = self._crop_box(img.shape, rng)
            else:
                return results      # mmdet: no valid crop, left uncropped
        if self.cat_max_ratio < 1.0 and "gt_semantic_seg" in results:
            box = self.select_seg_box(img.shape, results["gt_semantic_seg"],
                                      rng, box)
        y, x, ch, cw = box
        results["img"] = img[y:y + ch, x:x + cw]
        results["img_shape"] = results["img"].shape
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = \
                results["gt_semantic_seg"][y:y + ch, x:x + cw]
        return results


@PIPELINES.register_module(name="PhotoMetricDistortion")
class PhotoMetricDistortion:
    """mmseg's photometric distortion: brightness, contrast, saturation,
    hue."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def draw_params(self, rng):
        """The draws as a record with neutral values where a coin landed
        off (shared with ``SegDeviceAugmentPlanner``; the HSV gate's ``or``
        short-circuits, as mmseg's does): ``bright`` (add), ``c_pre`` /
        ``c_post`` (multipliers), ``hsv_on`` (the lossy uint8 HSV round
        trip happens), ``sat`` (multiplier), ``hue`` (add)."""
        p = dict(bright=0.0, c_pre=1.0, hsv_on=False, sat=1.0, hue=0.0,
                 c_post=1.0)
        if rng.integers(2):
            p["bright"] = float(rng.uniform(-self.brightness_delta,
                                            self.brightness_delta))
        contrast_last = bool(rng.integers(2))
        if not contrast_last and rng.integers(2):
            p["c_pre"] = float(rng.uniform(*self.contrast_range))
        if rng.integers(2) or rng.integers(2):
            p["hsv_on"] = True
            if rng.integers(2):
                p["sat"] = float(rng.uniform(*self.saturation_range))
            if rng.integers(2):
                p["hue"] = float(rng.uniform(-self.hue_delta,
                                             self.hue_delta))
        if contrast_last and rng.integers(2):
            p["c_post"] = float(rng.uniform(*self.contrast_range))
        return p

    @staticmethod
    def apply_params(img, p):
        """A ``draw_params`` record applied to host pixels (PIL's HSV)."""
        img = img.astype(np.float32) + p["bright"]
        img = img * p["c_pre"]
        if p["hsv_on"]:
            img_c = np.clip(img, 0, 255).astype(np.uint8)
            hsv = np.asarray(Image.fromarray(img_c).convert("HSV"),
                             np.float32)
            hsv[..., 1] = np.clip(hsv[..., 1] * p["sat"], 0, 255)
            hsv[..., 0] = (hsv[..., 0] + p["hue"]) % 256
            img = np.asarray(Image.fromarray(
                hsv.astype(np.uint8), "HSV").convert("RGB"), np.float32)
        img = img * p["c_post"]
        return np.clip(img, 0, 255)

    def __call__(self, results, rng):
        results["img"] = self.apply_params(results["img"],
                                           self.draw_params(rng))
        return results


@PIPELINES.register_module(name="RandomErasing")
class RandomErasing:
    def __init__(self, erase_prob=0.25, mode="rand", min_area_ratio=0.02,
                 max_area_ratio=1 / 3, aspect_range=(0.3, 3.33),
                 fill_color=(128, 128, 128), fill_std=(0, 0, 0)):
        self.erase_prob = erase_prob
        self.min_area_ratio = min_area_ratio
        self.max_area_ratio = max_area_ratio
        self.aspect_range = aspect_range
        self.mode = mode
        self.fill_color = np.asarray(fill_color, np.float32)
        self.fill_std = np.asarray(fill_std, np.float32)

    def draw_box(self, h, w, rng):
        """(on, y, x, eh, ew), shared with ``DeviceAugmentPlanner``."""
        if rng.uniform() > self.erase_prob:
            return False, 0, 0, 0, 0
        area = h * w * rng.uniform(self.min_area_ratio, self.max_area_ratio)
        ar = np.exp(rng.uniform(np.log(self.aspect_range[0]),
                                np.log(self.aspect_range[1])))
        eh = min(int(round(np.sqrt(area / ar))), h)
        ew = min(int(round(np.sqrt(area * ar))), w)
        y = int(rng.integers(0, h - eh + 1))
        x = int(rng.integers(0, w - ew + 1))
        return True, y, x, eh, ew

    def __call__(self, results, rng):
        img = results["img"]
        on, y, x, eh, ew = self.draw_box(*img.shape[:2], rng)
        if not on:
            return results
        if self.mode == "rand":
            patch = rng.normal(size=(eh, ew, 3)) * self.fill_std + \
                self.fill_color
        else:
            patch = np.broadcast_to(self.fill_color, (eh, ew, 3))
        img[y:y + eh, x:x + ew] = np.clip(patch, 0, 255)
        results["img"] = img
        return results


# ---------------------------------------------------------------------------
# RandAugment: mmcls rand_increasing_policies on PIL
# ---------------------------------------------------------------------------

def _ra_affine(img, coeffs):
    im = _to_pil(img)
    return _from_pil(im.transform(im.size, Image.AFFINE, coeffs,
                                  Image.BICUBIC, fillcolor=_RA_FILL))


def _ra_autocontrast(img, _):
    return _from_pil(ImageOps.autocontrast(_to_pil(img)))


def _ra_equalize(img, _):
    return _from_pil(ImageOps.equalize(_to_pil(img)))


def _ra_invert(img, _):
    return 255.0 - img


def _ra_rotate(img, m):
    return _from_pil(_to_pil(img).rotate(m * 30, Image.BICUBIC,
                                         fillcolor=_RA_FILL))


def _ra_posterize(img, m):
    bits = max(1, int(round(8 - m * 4)))
    return _from_pil(ImageOps.posterize(_to_pil(img), bits))


def _ra_solarize(img, m):
    return _from_pil(ImageOps.solarize(_to_pil(img), int(256 - m * 256)))


def _ra_solarize_add(img, m):
    out = img.copy()
    mask = out < 128
    out[mask] = np.clip(out[mask] + int(m * 110), 0, 255)
    return out


def _ra_color(img, m):
    return _from_pil(ImageEnhance.Color(_to_pil(img)).enhance(1 + m))


def _ra_contrast(img, m):
    return _from_pil(ImageEnhance.Contrast(_to_pil(img)).enhance(1 + m))


def _ra_brightness(img, m):
    return _from_pil(ImageEnhance.Brightness(_to_pil(img)).enhance(1 + m))


def _ra_sharpness(img, m):
    return _from_pil(ImageEnhance.Sharpness(_to_pil(img)).enhance(1 + m))


def _ra_shear_x(img, m):
    return _ra_affine(img, (1, m * 0.3, 0, 0, 1, 0))


def _ra_shear_y(img, m):
    return _ra_affine(img, (1, 0, 0, m * 0.3, 1, 0))


def _ra_translate_x(img, m):
    return _ra_affine(img, (1, 0, m * 0.45 * img.shape[1], 0, 1, 0))


def _ra_translate_y(img, m):
    return _ra_affine(img, (1, 0, 0, 0, 1, m * 0.45 * img.shape[0]))


# (name, op, signed magnitude), in RAND_AUG_OP_NAMES' order
RAND_AUG_OPS = [
    ("AutoContrast", _ra_autocontrast, False),
    ("Equalize", _ra_equalize, False),
    ("Invert", _ra_invert, False),
    ("Rotate", _ra_rotate, True),
    ("Posterize", _ra_posterize, False),
    ("Solarize", _ra_solarize, False),
    ("SolarizeAdd", _ra_solarize_add, False),
    ("ColorTransform", _ra_color, True),
    ("Contrast", _ra_contrast, True),
    ("Brightness", _ra_brightness, True),
    ("Sharpness", _ra_sharpness, True),
    ("Shear", _ra_shear_x, True),
    ("ShearY", _ra_shear_y, True),
    ("Translate", _ra_translate_x, True),
    ("TranslateY", _ra_translate_y, True),
]


@PIPELINES.register_module(name="RandAugment")
class RandAugment:
    """``num_policies`` random ops at ``magnitude_level / total_level``
    (with Gaussian noise of ``magnitude_std``). ``policies``: the
    reference's explicit list (dicts with ``type`` and, for Shear and
    Translate, ``direction``) filters and orders the op pool; None keeps
    the whole table. ``magnitude_key`` / ``magnitude_range`` are accepted:
    the ops carry the same increasing ranges."""

    _DIRECTED = {("Shear", "horizontal"): "Shear",
                 ("Shear", "vertical"): "ShearY",
                 ("Translate", "horizontal"): "Translate",
                 ("Translate", "vertical"): "TranslateY"}

    def __init__(self, policies=None, num_policies=2, total_level=10,
                 magnitude_level=9, magnitude_std=0.5, hparams=None):
        self.num_policies = num_policies
        self.total_level = total_level
        self.magnitude_level = magnitude_level
        self.magnitude_std = magnitude_std
        self.ops = RAND_AUG_OPS
        if policies is not None:
            table = {name: (name, fn, signed)
                     for name, fn, signed in RAND_AUG_OPS}
            self.ops = []
            for p in policies:
                t = p["type"] if isinstance(p, dict) else str(p)
                d = p.get("direction") if isinstance(p, dict) else None
                name = self._DIRECTED.get((t, d), t)
                if name not in table:
                    raise KeyError(f"unknown RandAugment policy {t!r}")
                self.ops.append(table[name])

    def draw_ops(self, rng):
        """[(index into self.ops, signed magnitude)] * num_policies, shared
        with ``DeviceAugmentPlanner``."""
        out = []
        for _ in range(self.num_policies):
            i = int(rng.integers(0, len(self.ops)))
            mag = self.magnitude_level
            if self.magnitude_std > 0:
                mag = rng.normal(mag, self.magnitude_std)
            m = float(np.clip(mag, 0, self.total_level)) / self.total_level
            if self.ops[i][2] and rng.integers(2):
                m = -m
            out.append((i, m))
        return out

    def __call__(self, results, rng):
        img = results["img"]
        for i, m in self.draw_ops(rng):
            img = self.ops[i][1](img, m)
        results["img"] = img
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


@PIPELINES.register_module(name="AutoAugment")
class AutoAugment:
    """mmdet's AutoAugment: one policy branch drawn uniformly, its
    transforms run in order."""

    def __init__(self, policies):
        self.policies = [build_pipeline(p) for p in policies]

    def __call__(self, results, rng):
        i = int(rng.integers(0, len(self.policies))) if rng is not None \
            else 0
        return run_pipeline(self.policies[i], results, rng)


# ---------------------------------------------------------------------------
# device-augment planners: the parameters on the host, the pixels on the card
# ---------------------------------------------------------------------------

def _src_u8(img, size, interpolation):
    """The image as uint8 at the planner's static source size (the
    datasets' own size, so the resize is a safety net)."""
    if img.shape[:2] != (size, size):
        img = _resize_img(img, (size, size), interpolation)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _flip_prob(cfg: dict, *keys) -> float:
    if cfg.get("direction", "horizontal") != "horizontal":
        raise ValueError("device augmentation flips horizontally only, not "
                         f"{cfg['direction']!r}")
    return next((cfg[k] for k in keys if k in cfg), 0.5)


@PIPELINES.register_module(name="DeviceAugmentPlanner")
class DeviceAugmentPlanner:
    """The cls train tail [RandomResizedCrop, RandomFlip, RandAugment,
    RandomErasing] as parameters only (``loader.cls_device_augment``): the
    same draws as those transforms, by their ``draw_box`` / ``draw_ops``,
    and the raw uint8 image; ``ops.device_augment.cls_device_augment`` does
    the pixel work in the cls step."""

    def __init__(self, rrc=None, flip=None, rand_aug=None, erase=None,
                 src_size=256):
        self.src_size = src_size
        self.rrc = RandomResizedCrop(**(rrc or {}))
        self.flip_prob = _flip_prob(dict(flip or {}), "flip_prob", "prob")
        self.rand_aug = RandAugment(**(rand_aug or {}))
        # the (policy-filtered, reordered) pool -> canonical device op ids
        self.op_canon = np.asarray(
            [RAND_AUG_OP_NAMES.index(name)
             for name, _, _ in self.rand_aug.ops], np.int32)
        self.erase = RandomErasing(**(erase or {}))
        if self.erase.mode not in ("rand", "const"):
            raise ValueError(f"RandomErasing mode {self.erase.mode!r}")

    def __call__(self, results, rng):
        h = w = self.src_size
        results["img"] = _src_u8(results["img"], h, "bicubic")
        y, x, ch, cw = self.rrc.draw_box(h, w, rng)
        results["aug_crop_y"] = np.int32(y)
        results["aug_crop_x"] = np.int32(x)
        results["aug_crop_h"] = np.int32(ch)
        results["aug_crop_w"] = np.int32(cw)
        results["aug_flip"] = bool(
            rng.uniform() < self.flip_prob if self.flip_prob else False)
        ops = self.rand_aug.draw_ops(rng)
        results["aug_op_id"] = np.asarray(
            [self.op_canon[i] for i, _ in ops], np.int32)
        results["aug_op_m"] = np.asarray([m for _, m in ops], np.float32)
        on, ey, ex, eh, ew = self.erase.draw_box(*self.rrc.size, rng)
        results["aug_erase_on"] = bool(on)
        results["aug_erase_y"] = np.int32(ey)
        results["aug_erase_x"] = np.int32(ex)
        results["aug_erase_h"] = np.int32(eh)
        results["aug_erase_w"] = np.int32(ew)
        return results


@PIPELINES.register_module(name="SegDeviceAugmentPlanner")
class SegDeviceAugmentPlanner:
    """The seg train tail [Resize(ratio_range), RandomCrop, RandomFlip,
    PhotoMetricDistortion, Normalize, Pad] as parameters
    (``loader.seg_device_augment``): the same draws (``draw_new_hw``,
    ``_crop_box``, ``select_seg_box``, ``draw_params``); the LABEL is
    resized, cropped, flipped and padded here (index work, and the
    cat_max_ratio redraws need it), the image ships as raw uint8 and
    ``ops.device_augment.seg_device_augment`` does its pixel work."""

    def __init__(self, resize=None, crop=None, flip=None,
                 photometric=None, pad=None, src_size=512):
        self.src_size = src_size
        self.resize = Resize(**(resize or {}))
        self.crop = RandomCrop(**(crop or {}))
        self.flip_prob = _flip_prob(dict(flip or {}), "prob", "flip_prob",
                                    "flip_ratio")
        self.pm = PhotoMetricDistortion(**(photometric or {}))
        pd = dict(pad or {})
        self.pad_size = tuple(pd.get("size", (src_size, src_size)))
        self.seg_pad_val = pd.get("seg_pad_val", 255)
        if self.pad_size != tuple(self.crop.crop_size):
            raise ValueError(
                f"seg_device_augment needs Pad size {self.pad_size} == "
                f"crop_size {tuple(self.crop.crop_size)} (a static output)")

    def __call__(self, results, rng):
        h = w = self.src_size
        if results["img"].shape[:2] != (h, w) and \
                "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = _resize_seg(
                results["gt_semantic_seg"], (h, w))
        results["img"] = _src_u8(results["img"], h, "bilinear")
        seg = results.get("gt_semantic_seg")

        new_hw = self.resize.draw_new_hw(h, w, rng)
        seg_r = _resize_seg(seg, new_hw) if seg is not None else None
        sf = np.array([new_hw[1] / w, new_hw[0] / h,
                       new_hw[1] / w, new_hw[0] / h], np.float32)
        results["scale_factor"] = np.asarray(
            sf * results.get("scale_factor", 1.0), np.float32)

        box = self.crop._crop_box((new_hw[0], new_hw[1], 3), rng)
        if self.crop.cat_max_ratio < 1.0 and seg_r is not None:
            box = self.crop.select_seg_box((new_hw[0], new_hw[1], 3),
                                           seg_r, rng, box)
        y, x, ch, cw = box
        seg_c = seg_r[y:y + ch, x:x + cw] if seg_r is not None else None
        do_flip = bool(rng.uniform() < self.flip_prob) \
            if self.flip_prob else False
        if do_flip and seg_c is not None:
            seg_c = seg_c[:, ::-1]
        p = self.pm.draw_params(rng)

        ph, pw = self.pad_size
        if seg_c is not None:
            out = np.full((ph, pw), self.seg_pad_val, seg.dtype)
            out[:ch, :cw] = seg_c
            results["gt_semantic_seg"] = out
        results["img_shape"] = (ch, cw, 3)
        results["pad_shape"] = (ph, pw, 3)
        results["aug_resize_h"] = np.int32(new_hw[0])
        results["aug_resize_w"] = np.int32(new_hw[1])
        results["aug_crop_y"] = np.int32(y)
        results["aug_crop_x"] = np.int32(x)
        results["aug_crop_h"] = np.int32(ch)
        results["aug_crop_w"] = np.int32(cw)
        results["aug_flip"] = do_flip
        for k in ("bright", "c_pre", "sat", "hue", "c_post"):
            results[f"aug_pm_{k}"] = np.float32(p[k])
        results["aug_pm_hsv_on"] = bool(p["hsv_on"])
        return results


@PIPELINES.register_module(name="DetDeviceAugmentPlanner")
class DetDeviceAugmentPlanner:
    """The det train tail's geometric ops as parameters
    (``loader.det_device_augment``): [Resize, RandomFlip] in the MTL det
    pipeline, [RandomFlip, AutoAugment{[Resize] | [Resize, RandomCrop,
    Resize]}] in the standalone DINO's. The ops are walked in order with
    the same draws (``draw_new_hw``, ``_crop_box``, ``_crop_bboxes``) and
    all box and meta arithmetic; the image ships as raw uint8 in the static
    source bucket with a two-stage program, resize -> crop -> resize
    (identity where a stage is missing), that
    ``ops.device_augment.det_device_augment`` runs. A flip before the first
    resize becomes a source mirror of stage 1, one after the last resize an
    output mirror of stage 2; one between two resizes is refused."""

    def __init__(self, ops, src_hw=(800, 800)):
        self.src_hw = tuple(src_hw)
        self.ops = []
        for c in ops:
            c = dict(c)
            t = c.pop("type")
            if t == "Resize":
                self.ops.append(Resize(**c))
            elif t == "RandomFlip":
                self.ops.append(RandomFlip(**c))
            elif t == "AutoAugment":
                branches = []
                for pol in c["policies"]:
                    branch = []
                    for sub in pol:
                        sub = dict(sub)
                        st = sub.pop("type")
                        if st not in ("Resize", "RandomCrop"):
                            raise ValueError("det_device_augment: "
                                             f"unsupported AutoAugment op "
                                             f"{st!r}")
                        branch.append(Resize(**sub) if st == "Resize"
                                      else RandomCrop(**sub))
                    branches.append(branch)
                self.ops.append(("autoaug", branches))
            else:
                raise ValueError(f"det_device_augment: unsupported op {t!r}")

    @staticmethod
    def _flip_boxes(results, w):
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            b = results["gt_bboxes"].copy()
            b[:, [0, 2]] = w - results["gt_bboxes"][:, [2, 0]]
            results["gt_bboxes"] = b

    @staticmethod
    def _scale_boxes(results, sf):
        results["scale_factor"] = np.asarray(
            sf * results.get("scale_factor", 1.0), np.float32)
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            results["gt_bboxes"] = results["gt_bboxes"] * sf

    def _walk(self, ops, results, rng, hw, prog):
        """The host ops' draws and box arithmetic in order, recording the
        geometric program; returns the current (h, w)."""
        h, w = hw
        for op in ops:
            if isinstance(op, RandomFlip):
                do = bool(rng.uniform() < op.prob) if op.prob else False
                if op.direction != "horizontal":
                    raise ValueError("det_device_augment flips "
                                     "horizontally only")
                results["flip"] = do
                if do:
                    self._flip_boxes(results, w)
                    if not prog["stages"]:
                        prog["flip_src"] = not prog["flip_src"]
                    elif prog["n_resize"] != len(prog["stages"]):
                        raise ValueError("det_device_augment: a flip "
                                         "between resizes is unsupported")
                    else:
                        prog["flip_out"] = not prog["flip_out"]
            elif isinstance(op, Resize):
                new_hw = op.draw_new_hw(h, w, rng)
                sf = np.array([new_hw[1] / w, new_hw[0] / h,
                               new_hw[1] / w, new_hw[0] / h], np.float32)
                self._scale_boxes(results, sf)
                if prog["flip_out"]:
                    raise ValueError("det_device_augment: a flip between "
                                     "resizes is unsupported")
                prog["stages"].append(("resize", new_hw))
                prog["n_resize"] += 1
                h, w = new_hw
            elif isinstance(op, RandomCrop):
                # RandomCrop.__call__ on the box path
                box = op._crop_box((h, w, 3), rng)
                ok = True
                if "gt_bboxes" in results:
                    ok = False
                    for _ in range(10):
                        if op._crop_bboxes(results, box):
                            ok = True
                            break
                        box = op._crop_box((h, w, 3), rng)
                if ok:
                    prog["stages"].append(("crop", box))
                    h, w = box[2], box[3]
            else:       # ("autoaug", branches)
                branches = op[1]
                i = int(rng.integers(0, len(branches)))
                h, w = self._walk(branches[i], results, rng, (h, w), prog)
        return h, w

    def __call__(self, results, rng):
        img = results["img"]
        h0, w0 = img.shape[:2]
        sh, sw = self.src_hw
        if h0 > sh or w0 > sw:
            raise ValueError(f"source image {h0}x{w0} exceeds det_src_hw "
                             f"{self.src_hw}")
        src = np.zeros((sh, sw, 3), np.uint8)
        src[:h0, :w0] = np.clip(np.round(img), 0, 255).astype(np.uint8)
        results["img"] = src

        prog = {"stages": [], "flip_src": False, "flip_out": False,
                "n_resize": 0}
        results.setdefault("flip", False)
        h, w = self._walk(self.ops, results, rng, (h0, w0), prog)

        # normalised to the two-stage program R -> C -> R
        s1 = crop = s2 = None
        for kind, val in prog["stages"]:
            if kind == "resize":
                if s1 is None:
                    s1 = val
                elif s2 is None:
                    s2 = val
                else:
                    raise ValueError(
                        "det_device_augment supports at most 2 resizes")
            elif s1 is None or crop is not None or s2 is not None:
                raise ValueError("det_device_augment supports one crop "
                                 "between resizes")
            else:
                crop = val
        if s1 is None:
            s1 = (h0, w0)
        if crop is None:
            crop = (0, 0, s1[0], s1[1])
        if s2 is None:
            s2 = (crop[2], crop[3])
        if s1[0] > sh or s1[1] > sw:
            raise ValueError(f"stage-1 size {s1} exceeds the mid buffer "
                             f"{self.src_hw}; raise loader.det_src_hw")

        results["img_shape"] = (h, w, 3)
        results["aug_src_h"] = np.int32(h0)
        results["aug_src_w"] = np.int32(w0)
        results["aug_flip_src"] = bool(prog["flip_src"])
        results["aug_flip_out"] = bool(prog["flip_out"])
        results["aug_s1_h"] = np.int32(s1[0])
        results["aug_s1_w"] = np.int32(s1[1])
        results["aug_crop_y"] = np.int32(crop[0])
        results["aug_crop_x"] = np.int32(crop[1])
        results["aug_crop_h"] = np.int32(crop[2])
        results["aug_crop_w"] = np.int32(crop[3])
        results["aug_s2_h"] = np.int32(s2[0])
        results["aug_s2_w"] = np.int32(s2[1])
        return results


def _norm_of(c: dict) -> dict:
    return {"mean": list(c.get("mean", DEFAULT_MEAN)),
            "std": list(c.get("std", DEFAULT_STD))}


def _split_tail(cfgs: Sequence[dict], keymap: dict, task: str):
    """(the ops before the tail, {keymap name: the op's kwargs}, the
    Normalize stats or None); an op after the tail has started raises."""
    head, parts, norm = [], {}, None
    for c in cfgs:
        t = c.get("type")
        if t in keymap:
            parts[keymap[t]] = {k: v for k, v in c.items() if k != "type"}
        elif t == "Normalize":
            norm = _norm_of(c)
        elif parts:
            raise ValueError(f"{task}_device_augment: op {t!r} after the "
                             "augment tail started")
        else:
            head.append(c)
    return head, parts, norm


def split_device_augment_cfg(cfgs: Sequence[dict], src_size: int = 256):
    """A cls train pipeline rewritten for device augmentation: the tail
    becomes one ``DeviceAugmentPlanner`` and Normalize moves to the card.
    Returns (new cfgs, img_norm, ``DeviceAugmentConfig`` kwargs)."""
    head, parts, norm = _split_tail(
        cfgs, {"RandomResizedCrop": "rrc", "RandomFlip": "flip",
               "RandAugment": "rand_aug", "RandomErasing": "erase"}, "cls")
    if "rrc" not in parts:
        raise ValueError("cls_device_augment needs a RandomResizedCrop")
    planner = dict(type="DeviceAugmentPlanner", src_size=src_size, **parts)
    rrc_size = parts["rrc"].get("size", 224)
    erase = parts.get("erase", {})
    dev_cfg = dict(
        src_size=src_size,
        out_size=rrc_size if isinstance(rrc_size, int) else rrc_size[0],
        erase_fill=tuple(erase.get("fill_color", (128, 128, 128))),
        erase_fill_std=tuple(erase.get("fill_std", (0, 0, 0))),
        num_policies=int(parts.get("rand_aug", {}).get("num_policies", 2)))
    return head + [planner], norm, dev_cfg


def split_seg_device_augment_cfg(cfgs: Sequence[dict], src_size: int = 512):
    """A seg train pipeline rewritten for device augmentation: the tail
    becomes one ``SegDeviceAugmentPlanner`` and Normalize moves to the
    card. Returns (new cfgs, img_norm, ``SegDeviceAugmentConfig``
    kwargs)."""
    head, parts, norm = _split_tail(
        cfgs, {"Resize": "resize", "RandomCrop": "crop",
               "RandomFlip": "flip", "PhotoMetricDistortion": "photometric",
               "Pad": "pad"}, "seg")
    if "crop" not in parts:
        raise ValueError("seg_device_augment needs a RandomCrop")
    planner = dict(type="SegDeviceAugmentPlanner", src_size=src_size,
                   **parts)
    crop_size = parts["crop"].get("crop_size", (512, 512))
    if crop_size[0] != crop_size[1]:
        raise ValueError("seg_device_augment supports a square crop_size "
                         f"only, not {crop_size}")
    return head + [planner], norm, dict(src_size=src_size,
                                        out_size=int(crop_size[0]))


def split_det_device_augment_cfg(cfgs: Sequence[dict], src_hw=(800, 800)):
    """A det train pipeline rewritten for device augmentation: the
    geometric tail becomes one ``DetDeviceAugmentPlanner``, Normalize
    moves to the card, and Pad must be a no-op (``size_divisor`` <= 1: the
    static bucket pads). Returns (new cfgs, img_norm,
    ``DetDeviceAugmentConfig`` kwargs)."""
    head, tail, norm = [], [], None
    for c in cfgs:
        t = c.get("type")
        if t in ("Resize", "RandomFlip", "AutoAugment"):
            tail.append(dict(c))
        elif t == "Normalize":
            norm = _norm_of(c)
        elif t == "Pad":
            if c.get("size_divisor", 1) > 1 or c.get("size"):
                raise ValueError("det_device_augment: a Pad beyond the "
                                 "static bucket is unsupported")
        elif tail:
            raise ValueError(f"det_device_augment: op {t!r} after the "
                             "geometric tail started")
        else:
            head.append(c)
    if not tail:
        raise ValueError("det_device_augment found no geometric ops")
    planner = dict(type="DetDeviceAugmentPlanner", ops=tail,
                   src_hw=tuple(src_hw))
    return head + [planner], norm, dict(src_hw=tuple(src_hw))


def split_normalize_cfg(cfgs: Sequence[dict]):
    """(the pipeline config without its Normalize op, that op's
    ``{"mean", "std"}`` or None): device-side preprocessing ships uint8
    images and normalizes on the card."""
    out, norm = [], None
    for c in cfgs:
        if c.get("type") == "Normalize":
            norm = _norm_of(c)
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
        out.append(PIPELINES.build({"type": t, **c}))
    return out


def run_pipeline(transforms, results, rng):
    for t in transforms:
        results = t(results, rng)
    return results
