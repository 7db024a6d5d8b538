"""Backbone feature-map visualisation of one level of one image: top-k
channel heatmaps blended onto the input (the port's counterpart of the root
``tools/featmap_vis/vis_featmap.py``, with its flags and file names
``featmap_l{level}_top{i}.png``)::

    python -m rscotr_tpu_torch.tools.featmap_vis.vis_featmap CONFIG IMG \\
        [--checkpoint X.pth] [--level 0] [--topk 4] [--size 224] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from rscotr_tpu_torch.tools.featmap_vis._common import (load_backbone,
                                                        preprocess,
                                                        run_backbone)


def draw_featmap(featmap: np.ndarray, img: np.ndarray, channel_reduction
                 ="squeeze_mean", topk: int = 4, alpha: float = 0.5):
    """featmap: (H', W', C); img: (H, W, 3) uint8-range float.

    Returns list of blended uint8 images (1 for squeeze_mean, topk for
    select_max).
    """
    from PIL import Image

    def blend(channel):
        c = channel - channel.min()
        c = c / max(c.max(), 1e-6)
        heat = np.zeros((*c.shape, 3), np.float32)
        heat[..., 0] = 255 * c                  # red channel heat
        heat[..., 2] = 255 * (1 - c)
        heat_im = Image.fromarray(heat.astype(np.uint8)).resize(
            (img.shape[1], img.shape[0]), Image.BILINEAR)
        out = np.asarray(heat_im, np.float32) * alpha + img * (1 - alpha)
        return np.clip(out, 0, 255).astype(np.uint8)

    if channel_reduction == "squeeze_mean":
        return [blend(featmap.mean(-1))]
    # select_max: top-k channels by spatial max activation
    order = np.argsort(-featmap.max(axis=(0, 1)))[:topk]
    return [blend(featmap[..., ci]) for ci in order]


def main(argv=None) -> List[str]:
    from PIL import Image

    p = argparse.ArgumentParser(description="featmap heatmaps of one level")
    p.add_argument("config")
    p.add_argument("img")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out-dir", default="featmap_vis_out")
    p.add_argument("--level", type=int, default=0)
    p.add_argument("--topk", type=int, default=4)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--device", default="cuda",
                   help="where the backbone runs (default: the card)")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    raw = Image.open(args.img).convert("RGB").resize((args.size, args.size))
    img = np.asarray(raw, np.float32)
    backbone = load_backbone(args.config, args.checkpoint,
                             device=args.device)
    fm = run_backbone(backbone, preprocess(np.asarray(raw)))[args.level]

    written = []
    for i, o in enumerate(draw_featmap(fm, img,
                                       channel_reduction="select_max",
                                       topk=args.topk)):
        path = os.path.join(args.out_dir,
                            f"featmap_l{args.level}_top{i}.png")
        Image.fromarray(o).save(path)
        print(path)
        written.append(path)
    return written


if __name__ == "__main__":
    main()
