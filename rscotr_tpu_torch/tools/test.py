"""Evaluate a checkpoint (PyTorch counterpart of the root ``tools/test.py``,
with its flags and its output keys).

    python -m rscotr_tpu_torch.tools.test CONFIG CHECKPOINT \\
        [--tasks cls det seg] [--eval-out metrics.json] [--work-dir DIR]

Composes the config (``--cfg-options`` merged in, each dataset's config
file inlined), builds the test datasets (the val ones when the config has
no test split) of the ``--tasks`` chosen and their loaders, builds the
model on ``--device`` (the card unless ``--device cpu``), loads the mm-format
``.pth`` checkpoint (``engine.checkpoint.resolve_checkpoint``'s aliases,
``strict=True``), runs every batch through ``make_infer_steps`` and writes
each dataset's metrics, keyed ``{dataset}.{metric}``, as JSON to
``--eval-out`` (default ``WORK_DIR/eval_metrics.json``, else
``eval_metrics.json``). An orbax checkpoint of the JAX package is refused
with the command that converts it (``tools/convert_checkpoint.py
--to-torch``). ``--show`` / ``--show-dir`` paint every evaluated image into
``SHOW_DIR/<dataset>/<index>.png`` (``utils/visualize.py``; ``--show``
alone paints into ``WORK_DIR/painted``), det boxes at or above
``--show-score-thr``.

``--launcher pytorch`` (or ``slurm`` / ``mpi``; ``jax`` is refused) joins
the launcher's process group: every rank evaluates its strided share of
the batches (``engine.test.multi_process_test``), the results are
gathered, and rank 0 writes the metrics, ``--out``, the painted images and
the formatted results::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m rscotr_tpu_torch.tools.test CONFIG CKPT --launcher pytorch
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, Optional

from rscotr_tpu_torch.utils.config import DictAction

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# --eval metric names -> the task whose datasets take them
METRIC_TASK = {"accuracy": "cls", "support": "cls", "precision": "cls",
               "recall": "cls", "f1_score": "cls", "bbox": "det",
               "proposal": "det", "proposal_fast": "det", "mIoU": "seg",
               "mDice": "seg", "mFscore": "seg"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the MTL model")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--tasks", nargs="+", default=["cls", "det", "seg"],
                   choices=["cls", "det", "seg"])
    p.add_argument("--out", help="dump raw outputs pickle")
    p.add_argument("--test_outputs", help="reuse cached raw outputs pickle")
    p.add_argument("--eval-out", help="metrics json path")
    p.add_argument("--show", action="store_true",
                   help="paint results (into WORK_DIR/painted unless "
                        "--show-dir)")
    p.add_argument("--show-dir", help="painted images directory")
    p.add_argument("--show-score-thr", type=float, default=0.3)
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--work-dir",
                   help="directory for the metrics, the log and formatted "
                        "results")
    p.add_argument("--eval", nargs="+",
                   help="metric names passed to dataset.evaluate "
                        "(e.g. bbox / mIoU mFscore / accuracy)")
    p.add_argument("--format-only", action="store_true",
                   help="write submission-format results (COCO det json, "
                        "seg label PNGs) and skip evaluation")
    p.add_argument("--launcher", default="none",
                   choices=["none", "jax", "pytorch", "slurm", "mpi"])
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the card)")
    # accepted for reference command-line compatibility
    p.add_argument("--gpu-id", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--gpu-collect", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--tmpdir", help=argparse.SUPPRESS)
    p.add_argument("--local_rank", type=int, default=0,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _eval_kwargs(cfg: dict, args, logger) -> Dict[str, dict]:
    """Each task's ``evaluation`` kwargs, with ``--eval``'s metric names
    routed to their task (unknown names to every selected task)."""
    eval_kwargs = {t: dict((cfg.get("evaluation") or {}).get(t, {}))
                   for t in ("cls", "det", "seg")}
    if not args.eval:
        return eval_kwargs
    per_task: Dict[str, list] = {}
    for m in args.eval:
        t = METRIC_TASK.get(m)
        for tt in ([t] if t else list(args.tasks)):
            per_task.setdefault(tt, []).append(m)
    for t, ms in per_task.items():
        if t not in args.tasks:
            logger.warning("--eval %s targets task %r which is not in "
                           "--tasks; ignoring", ms, t)
            continue
        eval_kwargs[t]["metric"] = ms[0] if len(ms) == 1 else tuple(ms)
    return eval_kwargs


def main(argv=None, stats: Optional[Dict[str, dict]] = None):
    """Run the CLI; returns the metrics dict (None with --format-only),
    the same on every rank. ``stats`` is handed to ``multi_process_test``
    (per-batch loader and step times, peak memory; this rank's batches)."""
    args = parse_args(argv)

    from rscotr_tpu_torch.apis import derive_cls_hw, derive_img_norm
    from rscotr_tpu_torch.data.build import (build_dataloaders,
                                             build_datasets, load_data_cfg)
    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.engine.test import (evaluate_results,
                                              multi_process_test)
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict
    from rscotr_tpu_torch.utils.logging import get_root_logger

    cfg = load_cfg(args.config)
    if args.cfg_options:
        cfg = merge_from_dict(cfg, args.cfg_options)
    cfg = load_data_cfg(cfg, config_root=ROOT, filename=args.config)
    device, rank = args.device, 0
    if args.launcher != "none":
        from rscotr_tpu_torch.parallel import initialize_distributed, mesh
        device = initialize_distributed(
            args.launcher, device=args.device,
            backend=(cfg.get("dist_params") or {}).get("backend"))
        rank = mesh.rank()
    logger = get_root_logger(os.path.join(args.work_dir, "test.log")
                             if args.work_dir else None)

    cfg["data"] = {name: entry for name, entry in cfg["data"].items()
                   if entry["task"] in args.tasks}
    datasets = build_datasets(cfg["data"], split="test") or \
        build_datasets(cfg["data"], split="val")
    loaders = build_dataloaders(datasets, cfg["data"], train=False)

    if args.test_outputs and os.path.isfile(args.test_outputs):
        with open(args.test_outputs, "rb") as f:
            results = pickle.load(f)
        logger.info("loaded cached outputs from %s", args.test_outputs)
    else:
        model = build_model(cfg["model"], device=device,
                            cls_hw=derive_cls_hw(cfg))
        ck = load_checkpoint(args.checkpoint, model=model)
        logger.info("loaded %d tensors from %s", len(ck["state_dict"]),
                    ck["path"])
        if ck["meta"].get("CLASSES"):
            logger.info("checkpoint CLASSES meta: %s",
                        {k: len(v) for k, v in ck["meta"]["CLASSES"].items()})
        test_cfg = cfg["model"].get("test_cfg") or {}
        infer = make_infer_steps(
            model, max_per_img=(test_cfg.get("det") or {}).get(
                "max_per_img", 300),
            img_norm=derive_img_norm(cfg), seg_test_cfg=test_cfg.get("seg"))
        results = multi_process_test(infer, loaders,
                                     max_batches=args.max_batches,
                                     stats=stats)
        if args.out and rank == 0:
            with open(args.out, "wb") as f:
                pickle.dump(results, f)

    if (args.show or args.show_dir) and rank == 0:
        from rscotr_tpu_torch.utils.visualize import save_eval_visualizations
        show_dir = args.show_dir or os.path.join(args.work_dir or ".",
                                                 "painted")
        n = save_eval_visualizations(datasets, results, show_dir,
                                     score_thr=args.show_score_thr)
        logger.info("painted %d result images into %s", n, show_dir)

    if args.format_only:
        out_dir = args.work_dir or "formatted"
        for name, ds in datasets.items():
            if rank != 0:
                break
            paths = ds.format_results(results.get(name, []), out_dir)
            logger.info("formatted %s -> %s", name,
                        paths[0] if len(paths) == 1
                        else f"{len(paths)} files in {out_dir}")
        return None

    metrics = evaluate_results(datasets, results,
                               _eval_kwargs(cfg, args, logger),
                               allow_empty=bool(args.test_outputs))
    logger.info("metrics: %s", json.dumps(metrics, indent=2))
    out_path = args.eval_out or (
        os.path.join(args.work_dir, "eval_metrics.json")
        if args.work_dir else "eval_metrics.json")
    if rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(metrics, f, indent=2)
        logger.info("metrics written to %s", out_path)
    return metrics


if __name__ == "__main__":
    main()
    from rscotr_tpu_torch.parallel.mesh import destroy_distributed
    destroy_distributed()
