"""Train the MTL model (PyTorch counterpart of the root ``tools/train.py``,
with its flags and its outputs).

    python -m rscotr_tpu_torch.tools.train CONFIG [--work-dir WD] \\
        [--max-iters N] [--resume-from P | --auto-resume] [--no-validate] \\
        [--device cuda|cpu]

Composes the config (``--cfg-options`` merged in, each dataset's config
file inlined), writes it to the work dir (default
``work_dirs/<config name>``), logs the environment and the seed, then runs
``apis.train_model`` on ``--device`` (the card unless ``--device cpu``):
``iter_N.pth`` and ``last_checkpoint`` at each checkpoint interval and at
the last step, ``best_checkpoint.pth`` on a better save-best score,
``train.log`` and ``metrics.jsonl``. ``--steps-per-dispatch K`` sets the
grouped order of K same-task steps (``runner.steps_per_dispatch``).
``--deterministic`` makes a run repeat bit for bit on the card
(``utils.rng.set_random_seed``: ``torch.use_deterministic_algorithms``,
under which K1b and K2b sum in a fixed order, cuDNN's deterministic
algorithms, ``CUBLAS_WORKSPACE_CONFIG``, set first thing). ``--diff-seed``
adds the process rank to the seed (0: one process).

``--launcher pytorch`` (or ``slurm`` / ``mpi``) joins the process group
its launcher set up, on the backend of ``dist_params.backend`` (default
``nccl`` on the card, ``gloo`` on the CPU), one rank per device; every
rank trains its share of the global batch (``samples_per_gpu`` x ranks),
with FSDP when ``parallel.fsdp=True``; rank 0 writes the logs and the
checkpoints::

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m rscotr_tpu_torch.tools.train CONFIG --launcher pytorch

``--launcher jax`` (a TPU pod's) is refused.
"""

from __future__ import annotations

import argparse
import os
import pprint
from typing import Callable, Optional, Sequence

from rscotr_tpu_torch.utils.config import DictAction

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the MTL co-training model")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--load-task-pretrain", action="store_true",
                   help="load the single-task pretrain of "
                        "model.train_cfg.task_pretrain")
    p.add_argument("--resume-from", help="checkpoint to resume from")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--no-validate", action="store_true")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--gpus", type=int,
                   help="(deprecated upstream, accepted for parity)")
    g.add_argument("--gpu-ids", type=int, nargs="+",
                   help="(deprecated upstream, accepted for parity)")
    g.add_argument("--gpu-id", type=int, default=0,
                   help="accepted for parity; the card is --device")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--diff-seed", action="store_true",
                   help="add the process rank to the seed")
    p.add_argument("--deterministic", action="store_true",
                   help="a run that repeats bit for bit: deterministic "
                        "algorithms (K1b / K2b ordered sums), cuDNN's "
                        "without benchmark search")
    p.add_argument("--options", nargs="+", action=DictAction,
                   help="deprecated alias of --cfg-options")
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--launcher", default="none",
                   choices=["none", "pytorch", "slurm", "mpi", "jax"])
    p.add_argument("--local_rank", type=int, default=0,
                   help="accepted for torch.distributed.launch command "
                        "compatibility")
    p.add_argument("--auto-scale-lr", action="store_true")
    p.add_argument("--max-iters", type=int, default=None,
                   help="override runner.max_iters (smoke runs)")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="override runner.steps_per_dispatch: the grouped "
                        "order of K same-task steps (1: the strategy's "
                        "order)")
    p.add_argument("--device", default="cuda",
                   help="where the model trains (default: the card)")
    return p.parse_args(argv)


def main(argv=None, hooks: Sequence = (),
         train_fn: Optional[Callable] = None):
    """Run the CLI; returns the runner. ``hooks``: more runner hooks,
    registered after the config's; ``train_fn``: the training API
    (``apis.train_model`` unless given)."""
    args = parse_args(argv)
    if args.deterministic:
        # before anything can make a cuBLAS handle
        from rscotr_tpu_torch.utils.rng import deterministic_cublas
        deterministic_cublas()

    from rscotr_tpu_torch import apis
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict
    from rscotr_tpu_torch.utils.logging import collect_env, get_root_logger
    from rscotr_tpu_torch.utils.rng import set_random_seed

    cfg = load_cfg(args.config)
    if args.options:
        if args.cfg_options:
            raise ValueError("--options and --cfg-options cannot both be "
                             "set; --options is the deprecated alias")
        args.cfg_options = args.options
    if args.cfg_options:
        cfg = merge_from_dict(cfg, args.cfg_options)
    if args.steps_per_dispatch:
        cfg = merge_from_dict(
            cfg, {"runner.steps_per_dispatch": args.steps_per_dispatch})
    cfg = load_data_cfg(cfg, config_root=ROOT, filename=args.config)
    rank = 0
    if args.launcher != "none":
        from rscotr_tpu_torch.parallel import initialize_distributed, mesh
        initialize_distributed(
            args.launcher, device=args.device,
            backend=(cfg.get("dist_params") or {}).get("backend"))
        rank = mesh.rank()

    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if rank == 0:
        with open(os.path.join(work_dir, os.path.basename(args.config)),
                  "w") as f:
            f.write("".join(f"{k} = {pprint.pformat(v, width=88)}\n"
                            for k, v in cfg.items()))

    logger = get_root_logger(os.path.join(work_dir, "train.log"))
    for k, v in collect_env().items():
        logger.info("env: %s = %s", k, v)

    seed = args.seed if args.seed is not None else 0
    if args.diff_seed:
        seed += rank
    set_random_seed(seed, deterministic=args.deterministic)
    logger.info("seed=%d deterministic=%s", seed, args.deterministic)

    if args.auto_scale_lr:
        base_bs = (cfg.get("auto_scale_lr") or {}).get("base_batch_size",
                                                       16)
        from rscotr_tpu_torch.parallel.mesh import world_size
        world_bs = sum(e["data"].get("samples_per_gpu", 1)
                       for e in cfg["data"].values()) * world_size()
        cfg["optimizer"]["lr"] = cfg["optimizer"]["lr"] * world_bs / base_bs
        logger.info("auto-scaled lr to %g", cfg["optimizer"]["lr"])

    pretrain = None
    if args.load_task_pretrain:
        tp = (cfg["model"].get("train_cfg") or {}).get(
            "task_pretrain") or {}
        pretrain = tp.get("pretrained")
        logger.info("task pretrain: %s (rule=%s)", pretrain, tp.get("rule"))

    train_fn = train_fn or apis.train_model
    return train_fn(cfg, work_dir, seed=seed,
                    validate=not args.no_validate,
                    resume_from=args.resume_from,
                    auto_resume=args.auto_resume,
                    load_task_pretrain_path=pretrain,
                    max_iters_override=args.max_iters, device=args.device,
                    hooks=hooks)


if __name__ == "__main__":
    main()
    from rscotr_tpu_torch.parallel.mesh import destroy_distributed
    destroy_distributed()
