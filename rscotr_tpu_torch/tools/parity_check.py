"""Parity-protocol tool of the port (PyTorch counterpart of the root
``tools/parity_check.py``, with its subcommands, flags, keys, printed
lines and exit codes; PARITY.md):

  dump CONFIG CHECKPOINT.pth --out fwd.npz [--seed 0] [--device cuda]
      Build the config's model on ``--device``, load the mm-format ``.pth``
      strictly (``engine.checkpoint.load_checkpoint``; an orbax directory
      of the JAX package is refused with the ``tools/convert_checkpoint.py
      --to-torch`` command that converts it), run the inference steps of
      every configured task on the root tool's seeded inputs (N(0, 1), one
      image at each task's ``derive_shapes`` size, drawn in the order cls,
      det, seg from ``np.random.default_rng(seed)``) and save the raw
      outputs to an .npz: ``cls`` (1, C) probabilities, ``det_boxes``
      (1, k, 5) and ``det_labels`` (1, k) int32, ``seg`` (1, H, W, C)
      float32 logits, as the root tool writes them, so a port dump and a
      JAX dump compare key for key.

  compare A.npz B.npz [--tol 1e-3]
      Elementwise max-|delta| per output; exit 1 if any exceeds --tol.

  metrics M.json --published PUB.json [--tol 0.3]
      Compare a tools/test.py --eval-out metrics file against published
      numbers (same keys; missing keys in M.json are an error), in the
      eval stack's scales (accuracy / mIoU / mF in percent, bbox_mAP a
      0..1 fraction).

``compare`` and ``metrics`` are numpy-only copies of the root tool's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cmd_dump(args):
    import numpy as np

    from rscotr_tpu_torch.apis import (derive_cls_hw, derive_img_norm,
                                       derive_shapes)
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_cfg

    cfg = load_data_cfg(load_cfg(args.config), config_root=ROOT,
                        filename=args.config)
    model = build_model(cfg["model"], device=args.device,
                        cls_hw=derive_cls_hw(cfg))
    load_checkpoint(args.checkpoint, model=model)
    test_cfg = cfg["model"].get("test_cfg") or {}
    infer = make_infer_steps(
        model, max_per_img=(test_cfg.get("det") or {}).get(
            "max_per_img", 300),
        img_norm=derive_img_norm(cfg), seg_test_cfg=test_cfg.get("seg"))
    model.eval()
    shapes = derive_shapes(cfg)
    rng = np.random.default_rng(args.seed)
    out = {}

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype)

    if "cls" in shapes and getattr(model, "cls_head", None) is not None:
        x = rng.normal(size=(1,) + shapes["cls"][1:]).astype(np.float32)
        out["cls"] = host(infer["cls"](x), np.float32)
    if "det" in shapes and getattr(model, "bbox_head", None) is not None:
        s = shapes["det"]
        x = rng.normal(size=(1,) + s[1:]).astype(np.float32)
        hw = np.asarray([[s[1], s[2]]], np.int32)
        sf = np.ones((1, 4), np.float32)
        det, labels = infer["det"](x, hw, sf)
        out["det_boxes"] = host(det, np.float32)
        out["det_labels"] = host(labels, np.int32)
    if "seg" in shapes and getattr(model, "seg_head", None) is not None:
        x = rng.normal(size=(1,) + shapes["seg"][1:]).astype(np.float32)
        out["seg"] = host(infer["seg_logits"](x), np.float32)
    np.savez(args.out, **out)
    for k, v in out.items():
        print(f"dump {k}: shape={v.shape} "
              f"mean={float(np.mean(v)):.6f}")
    print(f"wrote {args.out}")
    return 0


def cmd_compare(args):
    import numpy as np

    a = np.load(args.a)
    b = np.load(args.b)
    keys = sorted(set(a.files) & set(b.files))
    missing = sorted(set(a.files) ^ set(b.files))
    if missing:
        print(f"WARNING: keys only on one side: {missing}")
    worst = 0.0
    for k in keys:
        d = float(np.max(np.abs(a[k].astype(np.float64) -
                                b[k].astype(np.float64))))
        worst = max(worst, d)
        print(f"{k}: max|delta| = {d:.3e} "
              f"({'OK' if d <= args.tol else 'FAIL'} @ tol {args.tol})")
    if worst > args.tol:
        print("FORWARD PARITY: FAIL")
        return 1
    print("FORWARD PARITY: OK")
    return 0


def cmd_metrics(args):
    with open(args.metrics) as f:
        got = json.load(f)
    with open(args.published) as f:
        pub = json.load(f)
    fail = False
    for k, want in pub.items():
        if k not in got:
            print(f"{k}: MISSING from {args.metrics}")
            fail = True
            continue
        d = abs(float(got[k]) - float(want))
        ok = d <= args.tol
        fail = fail or not ok
        print(f"{k}: got={float(got[k]):.4f} published={float(want):.4f} "
              f"|delta|={d:.4f} ({'OK' if ok else 'FAIL'} @ tol "
              f"{args.tol})")
    print("METRIC PARITY:", "FAIL" if fail else "OK")
    return 1 if fail else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Parity protocol: dump, compare, metrics")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("config")
    d.add_argument("checkpoint")
    d.add_argument("--out", required=True)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--device", default="cuda",
                   help="where the model runs (default: the card)")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--tol", type=float, default=1e-3)
    m = sub.add_parser("metrics")
    m.add_argument("metrics")
    m.add_argument("--published", required=True)
    m.add_argument("--tol", type=float, default=0.3)
    args = ap.parse_args(argv)
    return {"dump": cmd_dump, "compare": cmd_compare,
            "metrics": cmd_metrics}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
