"""Export a trained model's inference steps as a serving artifact (PyTorch
counterpart of the root ``tools/export_model.py``, with its flags;
``--device`` takes the place of ``--platforms``).

    python -m rscotr_tpu_torch.tools.export_model CONFIG CHECKPOINT \\
        --out DIR [--tasks cls det seg] [--device cuda] \\
        [--input-dtype float32|uint8] [--check] [--{cls,det,seg}-{bs,size} N]

Builds the model on ``--device`` (the card unless ``--device cpu``), loads
the mm-format ``.pth`` checkpoint (``strict=True``), traces each task's step
with ``torch.export`` at its (bs, size) bucket and writes ``{task}.pt2``,
``params.npz`` and ``meta.json`` (``rscotr_tpu_torch/export.py``), which
``tools/serve.py`` runs without the model code. The buckets come from the
config's data section: ``samples_per_gpu`` and ``cls_size`` / the largest
``det_bucket_hw``'s height / ``seg_size`` (``apis.derive_shapes``), with
the root tool's defaults (cls 16 x 224, det 1 x 800, seg 2 x 512) for a
task the config has no dataset of; the ``--{task}-bs`` / ``--{task}-size``
flags win.

``--check`` reloads the artifact and compares each task's outputs with the
live steps on seeded random inputs (atol / rtol 1e-5); exit code 1 on a
mismatch.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the root tool's buckets for a task the config has no dataset of
DEFAULT_SHAPES = {"cls": dict(bs=16, size=224), "det": dict(bs=1, size=800),
                  "seg": dict(bs=2, size=512)}
CHECK_TOL = 1e-5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--tasks", nargs="+", default=["cls", "det", "seg"],
                   choices=["cls", "det", "seg"])
    p.add_argument("--device", default="cuda",
                   help="where the programs are traced and will run "
                        "(default: the card)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify outputs against "
                        "the live model")
    p.add_argument("--input-dtype", default="float32",
                   choices=["float32", "uint8"],
                   help="uint8 = raw-bytes-in serving artifact "
                        "(normalization baked into the program)")
    for t in ("cls", "det", "seg"):
        p.add_argument(f"--{t}-bs", type=int, default=0)
        p.add_argument(f"--{t}-size", type=int, default=0)
    return p.parse_args(argv)


def serving_shapes(cfg: dict, overrides=None) -> dict:
    """{task: {"bs", "size"}} from a composed config (``derive_shapes``),
    the defaults for absent tasks, then the non-zero ``overrides``."""
    from rscotr_tpu_torch.apis import derive_shapes
    shapes = {t: dict(s) for t, s in DEFAULT_SHAPES.items()}
    for t, nhwc in derive_shapes(cfg).items():
        if t in shapes:
            shapes[t] = dict(bs=int(nhwc[0]), size=int(nhwc[1]))
    for t, ov in (overrides or {}).items():
        shapes[t].update({k: int(v) for k, v in ov.items() if v})
    return shapes


def check_inputs(task, bs, size, img_dtype, rng):
    """Seeded inputs of one task: random pixels (uint8 bytes or normal
    floats), full-size ``img_hw``, unit ``scale_factor``."""
    import torch
    img = (rng.integers(0, 256, (bs, size, size, 3)).astype(np.uint8)
           if img_dtype == torch.uint8 else
           rng.normal(size=(bs, size, size, 3)).astype(np.float32))
    if task == "det":
        return (img, np.full((bs, 2), size, np.int32),
                np.ones((bs, 4), np.float32))
    return (img,)


def main(argv=None) -> int:
    import torch

    from rscotr_tpu_torch.apis import derive_cls_hw, derive_img_norm
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.export import (export_inference, load_artifact,
                                         save_artifact)
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_cfg

    args = parse_args(argv)
    cfg = load_data_cfg(load_cfg(args.config), config_root=ROOT,
                        filename=args.config)
    shapes = serving_shapes(cfg, {
        t: {"bs": getattr(args, f"{t}_bs"),
            "size": getattr(args, f"{t}_size")}
        for t in ("cls", "det", "seg")})

    model = build_model(cfg["model"], device=args.device,
                        cls_hw=derive_cls_hw(cfg))
    ck = load_checkpoint(args.checkpoint, model=model)

    test_cfg = cfg["model"].get("test_cfg") or {}
    max_per_img = (test_cfg.get("det") or {}).get("max_per_img", 300)
    img_norm = derive_img_norm(cfg)
    seg_test_cfg = test_cfg.get("seg")
    img_dtype = torch.uint8 if args.input_dtype == "uint8" else \
        torch.float32

    print(f"exporting tasks={args.tasks} shapes="
          f"{ {t: shapes[t] for t in args.tasks} } device={args.device}")
    exported = {}
    for t in args.tasks:
        t0 = time.perf_counter()
        exported.update(export_inference(
            model, shapes, tasks=[t], max_per_img=max_per_img,
            img_norm=img_norm, seg_test_cfg=seg_test_cfg,
            img_dtype=img_dtype))
        print(f"  {t}: traced in {time.perf_counter() - t0:.2f} s, "
              f"{len(exported[t].graph.nodes)} nodes")
    save_artifact(args.out, exported, model.state_dict(), shapes,
                  classes=ck["meta"].get("CLASSES"), img_norm=img_norm,
                  extra_meta={"config": os.path.basename(args.config)})
    for t in args.tasks:
        sz = os.path.getsize(os.path.join(args.out, f"{t}.pt2"))
        print(f"  {t}.pt2: {sz / 1e6:.2f} MB")
    sz = os.path.getsize(os.path.join(args.out, "params.npz"))
    print(f"  params.npz: {sz / 1e6:.2f} MB")
    print(f"artifact written to {args.out}")

    if not args.check:
        return 0
    fns, _meta = load_artifact(args.out, tasks=args.tasks,
                               device=args.device)
    infer = make_infer_steps(model, max_per_img=max_per_img,
                             img_norm=img_norm, seg_test_cfg=seg_test_cfg)
    rng = np.random.default_rng(0)
    ok = True
    for t in args.tasks:
        inputs = check_inputs(t, shapes[t]["bs"], shapes[t]["size"],
                              img_dtype, rng)
        got, want = fns[t](*inputs), infer[t](*inputs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        match = len(got) == len(want) and all(
            g.shape == w.shape and g.dtype == w.dtype and torch.allclose(
                g.float(), w.float(), atol=CHECK_TOL, rtol=CHECK_TOL)
            for g, w in zip(got, want))
        print(f"  check {t}: {'OK' if match else 'MISMATCH'}")
        ok = ok and match
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
