"""Painted results for the eval and demo CLIs (counterpart of
rscotr_tpu/utils/visualize.py, the port's own copy: numpy + PIL).

The reference's ``MTL.show_result`` dispatch and its per-task painters, and
the ``--show / --show-dir`` plumbing of mm* ``single_gpu_test``: det boxes,
seg overlays and cls labels drawn over the ORIGINAL image and saved as PNGs
into ``show_dir``. ``tools/test.py --show-dir`` and
``tools/inference_one_img.py`` paint through it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# the reference's Potsdam palette order (white/blue/cyan/green/yellow/red)
DEFAULT_SEG_PALETTE = [(255, 255, 255), (0, 0, 255), (0, 255, 255),
                       (0, 255, 0), (255, 255, 0), (255, 0, 0)]


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def seg_palette(num_classes: int):
    """First 6 classes use the reference Potsdam palette; extra classes get
    a deterministic pseudo-random palette (mmseg falls back to a random
    palette the same way)."""
    pal = list(DEFAULT_SEG_PALETTE)
    if num_classes > len(pal):
        rng = np.random.Generator(np.random.PCG64(42))
        pal += [tuple(int(v) for v in rng.integers(0, 256, 3))
                for _ in range(num_classes - len(pal))]
    return pal[:num_classes]


def draw_det_results(img, det, labels, classes, score_thr, out_path,
                     bbox_color=(255, 110, 110), width: int = 2):
    """det: (n, 5) xyxy+score in original-image coords; labels: (n,)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(_to_uint8(img))
    d = ImageDraw.Draw(im)
    for box, lab in zip(np.asarray(det), np.asarray(labels)):
        if box[4] < score_thr:
            continue
        x1, y1, x2, y2 = [float(v) for v in box[:4]]
        d.rectangle([x1, y1, x2, y2], outline=bbox_color, width=width)
        name = classes[int(lab)] if classes and int(lab) < len(classes) \
            else str(int(lab))
        d.text((x1, max(y1 - 12, 0)), f"{name}:{box[4]:.2f}",
               fill=bbox_color)
    im.save(out_path)


def draw_seg_results(img, seg, out_path, alpha: float = 0.5,
                     palette: Optional[Sequence] = None):
    """seg: (H, W) int label map aligned with ``img``'s top-left corner."""
    from PIL import Image
    seg = np.asarray(seg)
    pal = palette or seg_palette(int(seg.max()) + 1 if seg.size else 1)
    color = np.zeros((*seg.shape, 3), np.uint8)
    for ci, c in enumerate(pal):
        color[seg == ci] = c
    img = np.asarray(img, np.float32)
    blend = (img[:seg.shape[0], :seg.shape[1]] * (1 - alpha) + color * alpha)
    Image.fromarray(_to_uint8(blend)).save(out_path)


def draw_cls_result(img, class_name: str, prob: float, out_path):
    """Reference show_cls_result only prints; painting the label onto the
    image is the parity-plus equivalent for --show-dir."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(_to_uint8(img))
    d = ImageDraw.Draw(im)
    text = f"{class_name} ({prob:.3f})"
    d.rectangle([0, 0, 8 + 7 * len(text), 16], fill=(0, 0, 0))
    d.text((4, 2), text, fill=(255, 255, 0))
    im.save(out_path)


def _raw_image(dataset, idx: int) -> Optional[np.ndarray]:
    """Original (pre-pipeline) image for painting."""
    s = dataset[idx]
    if "img" in s:
        return np.asarray(s["img"], np.float32)
    if "img_path" in s:
        from PIL import Image
        return np.asarray(Image.open(s["img_path"]).convert("RGB"),
                          np.float32)
    return None


def save_eval_visualizations(datasets, results, show_dir: str,
                             score_thr: float = 0.3,
                             max_per_dataset: int = 0) -> int:
    """Paint every evaluated sample into ``show_dir/<dataset>/<idx>.png``
    (reference: mm* single_gpu_test(show=..., out_dir=...) via
    MTL.show_result). ``results`` is the eval engine's dict
    dataset_name -> list of per-image results. Returns #painted."""
    painted = 0
    for name, res in results.items():
        ds = datasets.get(name)
        if ds is None:
            continue
        out_dir = os.path.join(show_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        for idx, r in enumerate(res):
            if max_per_dataset and idx >= max_per_dataset:
                break
            img = _raw_image(ds, idx)
            if img is None:
                continue
            out = os.path.join(out_dir, f"{idx}.png")
            if ds.task == "cls":
                probs = np.asarray(r)
                top = int(probs.argmax())
                cname = ds.CLASSES[top] if ds.CLASSES else str(top)
                draw_cls_result(img, cname, float(probs[top]), out)
            elif ds.task == "det":
                # per-class list of (n, 5) -> flat arrays
                det = np.concatenate([np.asarray(a).reshape(-1, 5)
                                      for a in r], axis=0)
                labels = np.concatenate(
                    [np.full(len(a), c, np.int32)
                     for c, a in enumerate(r)])
                draw_det_results(img, det, labels, ds.CLASSES, score_thr,
                                 out)
            elif ds.task == "seg":
                draw_seg_results(img, r, out,
                                 palette=seg_palette(len(ds.CLASSES)))
            painted += 1
    return painted
