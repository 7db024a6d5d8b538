"""One image -> three task outputs: the cls label, a det boxes PNG and a
seg map PNG (PyTorch counterpart of the root ``tools/inference_one_img.py``,
with its flags, its printed lines and its files).

    python -m rscotr_tpu_torch.tools.inference_one_img CONFIG CHECKPOINT \\
        IMG [--out-dir DIR] [--score-thr 0.3] [--device cuda]

Builds the model on ``--device`` (the card unless ``--device cpu``), loads
the mm-format ``.pth`` checkpoint, runs each dataset's test pipeline (minus
``LoadImageFromFile``) on the same raw image, then the task's inference
step: prints the cls class and writes ``det_output.png`` /
``seg_output.png`` into ``--out-dir`` (``utils/visualize.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rscotr_tpu_torch.utils.config import DictAction

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("img")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    from PIL import Image

    from rscotr_tpu_torch.apis import derive_cls_hw
    from rscotr_tpu_torch.data import (collate_cls, collate_det, collate_seg,
                                       load_data_cfg)
    from rscotr_tpu_torch.data.pipelines import build_pipeline, run_pipeline
    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict
    from rscotr_tpu_torch.utils.logging import get_root_logger
    from rscotr_tpu_torch.utils.visualize import (draw_det_results,
                                                  draw_seg_results)

    args = parse_args(argv)
    logger = get_root_logger()
    cfg = load_cfg(args.config)
    if args.cfg_options:
        cfg = merge_from_dict(cfg, args.cfg_options)
    cfg = load_data_cfg(cfg, config_root=ROOT, filename=args.config)

    model = build_model(cfg["model"], device=args.device,
                        cls_hw=derive_cls_hw(cfg))
    load_checkpoint(args.checkpoint, model=model)
    test_cfg = cfg["model"].get("test_cfg") or {}
    infer = make_infer_steps(
        model, max_per_img=(test_cfg.get("det") or {}).get("max_per_img",
                                                           300),
        seg_test_cfg=test_cfg.get("seg"))

    raw = np.asarray(Image.open(args.img).convert("RGB"), np.float32)
    logger.info("image %s: %s", args.img, raw.shape)
    os.makedirs(args.out_dir, exist_ok=True)

    for name, entry in cfg["data"].items():
        task = entry["task"]
        ds_cfg = entry["data"].get("test") or entry["data"].get("val")
        pipeline = build_pipeline((ds_cfg or {}).get("pipeline", []))
        res = {"img": raw.copy(), "ori_shape": raw.shape,
               "img_shape": raw.shape}
        res = run_pipeline(pipeline, res, np.random.default_rng(0))
        opts = dict(entry.get("loader", {}))

        if task == "cls":
            batch = collate_cls([{**res, "gt_label": np.int32(0)}])
            probs = infer["cls"](batch["img"]).cpu().numpy()[0]
            ds_classes = _classes_for(cfg, name)
            top = int(probs.argmax())
            label = ds_classes[top] if ds_classes else str(top)
            print(f"[cls/{name}] class = {label} (p={probs[top]:.3f})")
        elif task == "det":
            bucket = opts.get("det_bucket_hw", (800, 800))
            batch = collate_det([res], bucket, opts.get("max_gt", 100))
            det, labels = infer["det"](batch["img"], batch["img_hw"],
                                       batch["scale_factor"])
            det = det.cpu().numpy()[0]
            labels = labels.cpu().numpy()[0]
            classes = _classes_for(cfg, name) or \
                [str(i) for i in range(100)]
            out = os.path.join(args.out_dir, "det_output.png")
            draw_det_results(raw, det, labels, classes, args.score_thr, out)
            n = int((det[:, 4] >= args.score_thr).sum())
            print(f"[det/{name}] {n} boxes >= {args.score_thr} -> {out}")
        elif task == "seg":
            size = opts.get("seg_size", 512)
            batch = collate_seg([res], size)
            seg = infer["seg"](batch["img"]).cpu().numpy()[0]
            h, w = batch["img_hw"][0]
            out = os.path.join(args.out_dir, "seg_output.png")
            draw_seg_results(raw, seg[:h, :w], out)
            print(f"[seg/{name}] seg map {seg.shape} -> {out}")


def _classes_for(cfg, name):
    entry = cfg["data"][name]
    ds = entry["data"].get("test") or entry["data"].get("val") or {}
    return ds.get("classes")


if __name__ == "__main__":
    main()
