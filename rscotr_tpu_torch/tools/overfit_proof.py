"""Overfit-to-metric proof on the card (PyTorch counterpart of the root
``tools/overfit_proof.py``, with its targets, flags, log and JSON line):
fit a fixed 8-image synthetic set per task and drive the real eval stack
to ceiling.

Targets (val == train by construction):
  cls  resisc.accuracy_top-1 >= 100 (percent)
  det  dior.bbox_mAP_50      >= 0.9 (fraction)
  seg  potsdam.mIoU          >= 90  (percent)

The losses, the matcher, CDN and the evaluation together must reach these
ceilings; a sign error, a wrong avg factor or broken CDN supervision cannot.

    python -m rscotr_tpu_torch.tools.overfit_proof --work-dir WORK_DIR \\
        --eval-every 250 --max-iters 4000 [--device cuda]

The model, the optimizer (the config's, fixed lr, its grad clip), the task
masks (``cls_uses_encoder=False``, as the root tool's), one train step per
task, the port's ``IterBasedRunner`` over ``build_multidataloader`` and
``make_eval_fn``. Each chunk of ``--eval-every`` iterations is one
``runner.run`` with a raised ``max_iters``, then an evaluation; each run
starts the data stream again, as the root tool's does (ROADMAP C9), which
on a fixed 8-image set does no harm. Writes the root tool's markdown log
(``--log``, default ``WORK_DIR/proof.md``) and prints its JSON line last;
``main`` returns that dict, and the module exits 0 only when every target
was met.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# accuracy / mIoU come out of the eval stack in percent (mmcv convention);
# COCO-style mAP is a 0-1 fraction
TARGETS = {
    "resisc.accuracy_top-1": 100.0,
    "dior.bbox_mAP_50": 0.9,
    "potsdam.mIoU": 90.0,
}
DEFAULT_CONFIG = os.path.join(ROOT, "configs/multi/MTL_overfit_proof.py")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Overfit-to-metric proof")
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--work-dir", default="work_dirs/overfit_proof")
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--max-iters", type=int, default=4000)
    p.add_argument("--log", default=None,
                   help="markdown log path (default <work-dir>/proof.md)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the card)")
    return p.parse_args(argv)


def write_log(path, args, device, first_met, history, final) -> None:
    """The root tool's markdown log."""
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "1 device(s)")
    with open(path, "w") as f:
        f.write("# Overfit-to-metric proof\n\n")
        f.write(f"Run: {datetime.datetime.now().isoformat()} on "
                f"`{device.type}` ({where}), config "
                f"`{os.path.relpath(args.config, ROOT)}`, "
                f"eval every {args.eval_every}, cap {args.max_iters} "
                f"iters.\n\n")
        f.write("Fixed 8-image synthetic set per task, val == train; "
                "metrics through the real eval stack "
                "(engine/test.py + dataset.evaluate).\n\n")
        f.write("| target | threshold | first met at iter | final |\n")
        f.write("|---|---|---|---|\n")
        for k, thr in TARGETS.items():
            f.write(f"| {k} | {thr} | "
                    f"{first_met.get(k, 'NOT MET')} | "
                    f"{final.get(k, float('nan')):.4f} |\n")
        f.write("\n## Metric trajectory\n\n```\n")
        for it, m in history:
            f.write(f"iter {it}: " + json.dumps(
                {k: round(m.get(k, 0.0), 4) for k in TARGETS}) + "\n")
        f.write("```\n")


def main(argv=None) -> dict:
    args = parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)

    from rscotr_tpu_torch.apis import (derive_cls_hw, make_eval_fn,
                                       make_step_config)
    from rscotr_tpu_torch.data.build import (build_datasets,
                                             build_multidataloader,
                                             load_data_cfg)
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.runner import IterBasedRunner
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_cfg
    from rscotr_tpu_torch.utils.logging import get_root_logger

    logger = get_root_logger(os.path.join(args.work_dir, "overfit.log"))
    cfg = load_data_cfg(load_cfg(args.config), config_root=ROOT,
                        filename=args.config)
    device = torch.device(args.device)
    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(args.seed),
                        cls_hw=derive_cls_hw(cfg))
    optimizer = build_optimizer(
        cfg["optimizer"], model.named_parameters(),
        lr_config=dict(cfg.get("lr_config") or {"policy": "fixed"},
                       max_iters=args.max_iters),
        grad_clip=(cfg.get("optimizer_config") or {}).get("grad_clip"))
    masks = task_param_masks([n for n, _ in model.named_parameters()],
                             cls_uses_encoder=False)
    step_cfg = make_step_config(cfg)
    steps = {t: make_train_step(model, optimizer, t, step_cfg, masks.get(t))
             for t in ("cls", "det", "seg")}
    datasets = build_datasets(cfg["data"], split="train")
    eval_fn = make_eval_fn(cfg, model)

    runner = IterBasedRunner(steps, model, optimizer,
                             max_iters=args.eval_every, rng_seed=args.seed)
    ml = build_multidataloader(cfg, datasets, seed=args.seed)

    first_met, history = {}, []
    while runner.step < args.max_iters:
        runner.max_iters = min(runner.step + args.eval_every,
                               args.max_iters)
        runner.run(ml)
        metrics = eval_fn(runner)
        history.append((runner.step, metrics))
        logger.info("iter %d metrics: %s", runner.step,
                    {k: round(v, 4) for k, v in metrics.items()
                     if k in TARGETS})
        for k, thr in TARGETS.items():
            if k not in first_met and metrics.get(k, 0.0) >= thr:
                first_met[k] = runner.step
                logger.info("TARGET MET: %s >= %.2f at iter %d",
                            k, thr, runner.step)
        if len(first_met) == len(TARGETS):
            break

    final = history[-1][1] if history else {}
    ok = len(first_met) == len(TARGETS)
    log_path = args.log or os.path.join(args.work_dir, "proof.md")
    write_log(log_path, args, device, first_met, history, final)
    logger.info("proof %s -> %s", "COMPLETE" if ok else "INCOMPLETE",
                log_path)
    result = {"ok": ok, "first_met": first_met,
              "final": {k: final.get(k) for k in TARGETS}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
