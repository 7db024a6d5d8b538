"""Shared plumbing of the port's featmap tools (counterpart of the root
``tools/featmap_vis/_common.py``): build the bare backbone from a config on
a device, load a checkpoint's backbone weights, preprocess per task, run
images, save the top-k channel montages under the root tools' file names
(``{stem}_l{level}_top{topk}.png``).

The backbone runs in float32, as the root tools' does, with weights from
seed 0 or the ``backbone.*`` entries of an mm-format ``.pth`` (the port's
strict loader: every backbone key present, none extra). On the card each
image's pass launches K2 once per Swin block.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

# ImageNet mean/std in 0-255 range (reference img_norm_cfg)
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)

TASK_SIZE = {"cls": 224, "seg": 512, "det": 800}


def load_backbone(config_path: str, checkpoint: Optional[str] = None,
                  device="cuda"):
    """The config's backbone on ``device`` in eval mode, float32, its
    weights from seed 0 or from ``checkpoint``'s ``backbone.*`` entries."""
    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    from rscotr_tpu_torch.models.build import build_backbone
    from rscotr_tpu_torch.models.layers.common import init_weights
    from rscotr_tpu_torch.utils.config import load_cfg

    cfg = load_cfg(config_path)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_backbone: no CUDA device (the default is "
                           "the card); pass --device cpu to run on the CPU")
    backbone = build_backbone(cfg["model"]["backbone"], torch.float32,
                              device)
    init_weights(backbone, torch.Generator().manual_seed(0))
    if checkpoint:
        state = load_checkpoint(checkpoint)["state_dict"]
        backbone.load_state_dict(
            {k[len("backbone."):]: v for k, v in state.items()
             if k.startswith("backbone.")}, strict=True)
    return backbone.eval()


def preprocess(img: np.ndarray, size: Optional[int] = None) -> np.ndarray:
    """uint8 (H, W, 3) -> normalized float (1, S, S, 3)."""
    from PIL import Image

    if size is not None:
        img = np.asarray(
            Image.fromarray(np.asarray(img, np.uint8)).resize(
                (size, size), Image.BILINEAR))
    x = (np.asarray(img, np.float32) - MEAN) / STD
    return x[None]


@torch.inference_mode()
def run_backbone(backbone, x: np.ndarray) -> List[np.ndarray]:
    """-> list of (H', W', C) float32 numpy feature maps (one per out
    level)."""
    dev = next(backbone.parameters()).device
    feats = backbone(torch.as_tensor(x).to(dev))
    return [f[0].float().cpu().numpy() for f in feats]


def iter_images(root: str) -> Iterable[Tuple[str, np.ndarray]]:
    """Yield (path, uint8 image) for every image under root (folder or
    class-subfolder layout)."""
    from PIL import Image

    exts = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(exts):
                path = os.path.join(dirpath, f)
                yield path, np.asarray(Image.open(path).convert("RGB"))


def save_featmaps(feats, img: np.ndarray, img_path: str, out_dir: str,
                  topk: int = 20, levels=None) -> List[str]:
    """Render each requested level's top-k montage into out_dir; returns
    the written paths."""
    from PIL import Image

    from rscotr_tpu_torch.tools.featmap_vis.draw_featmap import draw_featmap

    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(img_path))[0]
    levels = range(len(feats)) if levels is None else levels
    written = []
    for lvl in levels:
        grid = draw_featmap(feats[lvl], img, channel_reduction=None,
                            topk=topk)
        out = os.path.join(out_dir, f"{stem}_l{lvl}_top{topk}.png")
        Image.fromarray(grid).save(out)
        print(out)
        written.append(out)
    return written


def _display(img: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((size, size)))


def _flags(p, task: str, out_suffix: str = "") -> None:
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out-dir", default=f"featmap_vis_{task}{out_suffix}")
    p.add_argument("--topk", type=int, default=20)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="where the backbone runs (default: the card)")


def folder_main(task: str, argv=None) -> List[str]:
    """Common CLI: config + checkpoint + image folder -> montages."""
    p = argparse.ArgumentParser(
        description=f"{task} backbone featmap visualization")
    p.add_argument("config")
    p.add_argument("img_root", help="folder of images (class subfolders ok)")
    _flags(p, task)
    p.add_argument("--levels", type=int, nargs="*", default=None)
    args = p.parse_args(argv)

    size = args.size or TASK_SIZE.get(task, 224)
    backbone = load_backbone(args.config, args.checkpoint,
                             device=args.device)
    written = []
    for path, img in iter_images(args.img_root):
        feats = run_backbone(backbone, preprocess(img, size))
        written += save_featmaps(feats, _display(img, size), path,
                                 args.out_dir, topk=args.topk,
                                 levels=args.levels)
    return written


def single_img_main(task: str, argv=None) -> List[str]:
    from PIL import Image

    p = argparse.ArgumentParser(
        description=f"{task} featmap visualization (single image)")
    p.add_argument("config")
    p.add_argument("img")
    _flags(p, task)
    p.add_argument("--levels", type=int, nargs="*", default=None)
    args = p.parse_args(argv)

    size = args.size or TASK_SIZE.get(task, 224)
    backbone = load_backbone(args.config, args.checkpoint,
                             device=args.device)
    img = np.asarray(Image.open(args.img).convert("RGB"))
    feats = run_backbone(backbone, preprocess(img, size))
    return save_featmaps(feats, _display(img, size), args.img, args.out_dir,
                         topk=args.topk, levels=args.levels)


def test_split_main(task: str, argv=None) -> List[str]:
    """Visualize over the config's test split (first N samples)."""
    from rscotr_tpu_torch.data.build import build_datasets, load_data_cfg
    from rscotr_tpu_torch.utils.config import load_cfg

    p = argparse.ArgumentParser(
        description=f"{task} featmap visualization (test split)")
    p.add_argument("config")
    _flags(p, task, "_test")
    p.add_argument("--num", type=int, default=8)
    args = p.parse_args(argv)

    size = args.size or TASK_SIZE.get(task, 224)
    cfg = load_data_cfg(load_cfg(args.config), filename=args.config)
    backbone = load_backbone(args.config, args.checkpoint,
                             device=args.device)
    datasets = build_datasets(cfg["data"], split="test") or \
        build_datasets(cfg["data"], split="val")
    written = []
    for name, ds in datasets.items():
        if ds.task != task:
            continue
        for i in range(min(args.num, len(ds))):
            s = ds[i]
            if "img" not in s:
                continue
            img = np.asarray(s["img"], np.uint8)
            feats = run_backbone(backbone, preprocess(img, size))
            written += save_featmaps(feats, _display(img, size),
                                     f"{name}_{i}.png", args.out_dir,
                                     topk=args.topk)
    return written
