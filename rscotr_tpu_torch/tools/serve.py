"""Batch inference from an exported serving artifact, with NO model code
(PyTorch counterpart of the root ``tools/serve.py``).

    python -m rscotr_tpu_torch.tools.serve ARTIFACT_DIR IMG [IMG...] \\
        [--tasks cls det seg] [--out-dir DIR] [--score-thr 0.3] \\
        [--device cuda]

Consumes the directory written by ``tools/export_model.py`` (``{task}.pt2``
+ ``params.npz`` + ``meta.json``; see ``rscotr_tpu_torch/export.py``) and
runs a directory (or list) of images through the loaded programs on
``--device`` (the card unless ``--device cpu``; it must be the device type
the artifact was exported on). Imports only ``rscotr_tpu_torch.export``
(which registers the kernels' operators), torch, numpy and PIL: no configs,
no model modules, no registries.

Outputs (mirroring the test-engine contracts):
  cls: top-1 class per image, printed + results.json
  det: boxes above --score-thr in ORIGINAL image coords, results.json
  seg: per-image label map PNG ({stem}_seg.png) at original resolution

Batching: images are grouped into the artifact's fixed batch size (the
static-shape serving bucket); the final partial batch is padded and the
padding dropped. det preprocessing is keep-ratio resize into the bucket +
bottom/right zero-pad, with box coords rescaled back to the original
image (the test pipeline's Resize/Pad contract).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("artifact", help="directory from tools/export_model.py")
    p.add_argument("images", nargs="+",
                   help="image files and/or directories of images")
    p.add_argument("--tasks", nargs="+", default=None,
                   choices=["cls", "det", "seg"],
                   help="default: every task in the artifact")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="where the programs run (default: the card)")
    return p.parse_args(argv)


def _list_images(paths):
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(os.path.join(p, f) for f in sorted(os.listdir(p))
                       if os.path.splitext(f)[1].lower() in exts)
        else:
            out.append(p)
    if not out:
        raise SystemExit("no images found")
    return out


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def _prep(task: str, raw: np.ndarray, size: int, img_norm, is_uint8: bool):
    """-> (img, img_hw, scale_factor). raw: (H, W, 3) uint8."""
    H, W = raw.shape[:2]
    if task == "det":
        s = min(size / H, size / W)
        h, w = int(round(H * s)), int(round(W * s))
        img = np.zeros((size, size, 3), np.uint8)
        img[:h, :w] = _resize(raw, h, w)
        hw = np.array([h, w], np.int32)
        scale = np.array([w / W, h / H, w / W, h / H], np.float32)
    else:
        img = _resize(raw, size, size)
        hw = np.array([size, size], np.int32)
        scale = np.ones(4, np.float32)
    if not is_uint8:
        mean, std = (img_norm if img_norm else
                     ([123.675, 116.28, 103.53], [58.395, 57.12, 57.375]))
        img = ((img.astype(np.float32) - np.asarray(mean, np.float32))
               / np.asarray(std, np.float32))
        if task == "det":  # re-zero the pad region, like device_normalize
            keep = np.zeros((size, size, 1), np.float32)
            keep[:hw[0], :hw[1]] = 1.0
            img = img * keep
    return img, hw, scale


def _resize_labels_nearest(p: np.ndarray, h: int, w: int) -> np.ndarray:
    H, W = p.shape
    ys = np.clip(np.round((np.arange(h) + 0.5) * H / h - 0.5), 0,
                 H - 1).astype(int)
    xs = np.clip(np.round((np.arange(w) + 0.5) * W / w - 0.5), 0,
                 W - 1).astype(int)
    return p[ys[:, None], xs[None, :]]


def main(argv=None):
    """Run the CLI; returns the results dict written to results.json."""
    from PIL import Image

    from rscotr_tpu_torch.export import load_artifact

    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    fns, meta = load_artifact(args.artifact, tasks=args.tasks,
                              device=args.device)
    tasks = args.tasks or sorted(meta["tasks"].keys())
    files = _list_images(args.images)
    raws = [np.asarray(Image.open(f).convert("RGB"), np.uint8)
            for f in files]
    print(f"serving {len(files)} image(s) for tasks {tasks} "
          f"from {args.artifact} on {args.device}")

    results = {os.path.basename(f): {} for f in files}
    for task in tasks:
        tmeta = meta["tasks"][task]
        bs, size = tmeta["bs"], tmeta["size"]
        is_uint8 = tmeta["input_specs"][0][1] == "uint8"
        prepped = [_prep(task, r, size, meta.get("img_norm"), is_uint8)
                   for r in raws]
        for b0 in range(0, len(files), bs):
            chunk = prepped[b0:b0 + bs]
            valid = len(chunk)
            while len(chunk) < bs:            # pad the final partial batch
                chunk.append(chunk[-1])
            img = np.stack([c[0] for c in chunk])
            if task == "det":
                det, labels = fns[task](img, np.stack([c[1] for c in chunk]),
                                        np.stack([c[2] for c in chunk]))
                det, labels = det.cpu().numpy(), labels.cpu().numpy()
                for i in range(valid):
                    name = os.path.basename(files[b0 + i])
                    keep = det[i][:, 4] >= args.score_thr
                    results[name]["det"] = {
                        "boxes_xyxy_score": det[i][keep].tolist(),
                        "labels": labels[i][keep].tolist()}
            elif task == "cls":
                probs = fns[task](img).cpu().numpy()
                for i in range(valid):
                    name = os.path.basename(files[b0 + i])
                    k = int(probs[i].argmax())
                    label = _class_name(meta, probs.shape[-1], k)
                    results[name]["cls"] = {"top1": k, "label": label,
                                            "prob": float(probs[i][k])}
                    print(f"[cls] {name}: {label} (p={probs[i][k]:.3f})")
            else:  # seg
                preds = fns[task](img).cpu().numpy()
                for i in range(valid):
                    f = files[b0 + i]
                    name = os.path.basename(f)
                    H, W = raws[b0 + i].shape[:2]
                    lab = _resize_labels_nearest(preds[i], H, W)
                    stem = os.path.splitext(name)[0]
                    out_png = os.path.join(args.out_dir,
                                           f"{stem}_seg.png")
                    Image.fromarray(lab.astype(np.uint8)).save(out_png)
                    results[name]["seg"] = {"png": out_png,
                                            "classes": sorted(
                                                np.unique(lab).tolist())}

    out_json = os.path.join(args.out_dir, "results.json")
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results written to {out_json}")
    return results


def _class_name(meta, num_classes, k):
    for ds_classes in (meta.get("classes") or {}).values():
        if ds_classes and len(ds_classes) == num_classes:
            return str(ds_classes[k])
    return str(k)


if __name__ == "__main__":
    main()
