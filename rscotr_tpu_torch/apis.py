"""Config-level entry points of the port (PyTorch counterpart of
rscotr_tpu/apis.py, written out again here because that module imports
jax): the step config, the eval function, the schedule and checkpoint
resolution, and ``train_model``, which wires model, data, optimizer, runner
and hooks together from a composed config.

``make_step_config(cfg)`` derives the ``TrainStepConfig`` from a composed
config (``utils.config.load_cfg``): task weights, the CDN setup with the
static DN group width ``dn_max_gt = min(20, max_gt)`` (5 groups, pad 200 for
the flagship), the DINO loss and matcher weights, the cls label smoothing
and batch augments, the device-side normalization stats, and the configs of
the on-device augmentation stages that the loaders ask for
(``derive_device_aug``, ``derive_det_device_aug``,
``derive_seg_device_aug``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from rscotr_tpu_torch.data.build import det_src_hw, seg_src_size
from rscotr_tpu_torch.data.pipelines import (split_device_augment_cfg,
                                             split_seg_device_augment_cfg)
from rscotr_tpu_torch.engine.train_step import TrainStepConfig
from rscotr_tpu_torch.models.heads.cdn import CdnConfig
from rscotr_tpu_torch.models.heads.dino_loss import DetLossConfig
from rscotr_tpu_torch.ops.device_augment import (DetDeviceAugmentConfig,
                                                 DeviceAugmentConfig,
                                                 SegDeviceAugmentConfig)
from rscotr_tpu_torch.utils.logging import get_root_logger

_IMAGENET = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
# loader options that move Normalize onto the card
_ON_CARD = ("device_preprocess", "cls_device_augment", "seg_device_augment",
            "det_device_augment")


def derive_img_norm(cfg: dict) -> Optional[Tuple[tuple, tuple]]:
    """(mean, std) for device-side normalization, from the Normalize op
    of any dataset whose loader sets device_preprocess or a device-augment
    option; ImageNet stats when such a loader's pipelines carry none; None
    when no loader asks."""
    found, asked = None, False
    for entry in cfg.get("data", {}).values():
        opts = dict(entry.get("loader", {}))
        if not any(opts.get(k) for k in _ON_CARD):
            continue
        asked = True
        for split in ("train", "val", "test"):
            dcfg = entry["data"].get(split) or {}
            for op in dcfg.get("pipeline", []) or []:
                if op.get("type") == "Normalize":
                    norm = (tuple(op.get("mean")), tuple(op.get("std")))
                    if found is not None and found != norm:
                        raise ValueError(
                            "device_preprocess with mixed img_norm stats "
                            f"is unsupported: {found} vs {norm}")
                    found = norm
    return found if found is not None or not asked else _IMAGENET


def derive_shapes(cfg: dict) -> Dict[str, tuple]:
    """The static input shape of each task from the data config (NHWC at
    ``samples_per_gpu``; det at its largest bucket, with ``det_max_gt``)."""
    shapes = {}
    for entry in (cfg.get("data") or {}).values():
        task = entry["task"]
        opts = dict(entry.get("loader", {}))
        bs = entry["data"].get("samples_per_gpu", 1)
        if task == "cls":
            s = opts.get("cls_size", 224)
            shapes["cls"] = (bs, s, s, 3)
        elif task == "det":
            bucket = opts.get("det_bucket_hw", (800, 800))
            if isinstance(bucket[0], (tuple, list)):
                bucket = max(bucket, key=lambda b: b[0] * b[1])
            shapes["det"] = (bs, bucket[0], bucket[1], 3)
            shapes["det_max_gt"] = opts.get("max_gt", 100)
        elif task == "seg":
            s = opts.get("seg_size", 512)
            shapes["seg"] = (bs, s, s, 3)
    return shapes


def derive_cls_hw(cfg: dict) -> Optional[Tuple[int, int]]:
    """The cls input size (H, W) of a composed config, as
    ``derive_shapes`` takes it (the last cls dataset's
    ``loader.cls_size``, 224 by default); None when the config has no cls
    dataset. ``build_model`` takes it as ``cls_hw`` to size an
    ``MlvlClsHead`` of scheme 5, 6 or 7."""
    cls = derive_shapes(cfg).get("cls")
    return None if cls is None else cls[1:3]


def _aug_loader(cfg: dict, task: str):
    """(entry, loader options) of the first ``task`` dataset whose loader
    sets ``{task}_device_augment``, else None."""
    for entry in cfg.get("data", {}).values():
        opts = dict(entry.get("loader", {}))
        if entry["task"] == task and opts.get(f"{task}_device_augment"):
            return entry, opts
    return None


def _train_pipeline(entry: dict) -> list:
    return list((entry["data"].get("train") or {}).get("pipeline") or [])


def derive_device_aug(cfg: dict) -> Optional[DeviceAugmentConfig]:
    """The cls stage's config when a cls loader sets
    ``cls_device_augment`` (the pipeline rewrite is data/build.py's)."""
    found = _aug_loader(cfg, "cls")
    if found is None:
        return None
    entry, opts = found
    _, _, kw = split_device_augment_cfg(
        _train_pipeline(entry), src_size=opts.get("cls_src_size", 256))
    return DeviceAugmentConfig(**kw)


def derive_det_device_aug(cfg: dict) -> Optional[DetDeviceAugmentConfig]:
    """The det stage's config when a det loader sets
    ``det_device_augment``."""
    found = _aug_loader(cfg, "det")
    return None if found is None else \
        DetDeviceAugmentConfig(src_hw=det_src_hw(found[1]))


def derive_seg_device_aug(cfg: dict) -> Optional[SegDeviceAugmentConfig]:
    """The seg stage's config when a seg loader sets
    ``seg_device_augment``."""
    found = _aug_loader(cfg, "seg")
    if found is None:
        return None
    entry, opts = found
    _, _, kw = split_seg_device_augment_cfg(
        _train_pipeline(entry), src_size=seg_src_size(opts))
    return SegDeviceAugmentConfig(**kw)


def make_step_config(cfg: dict) -> TrainStepConfig:
    model_cfg = cfg["model"]
    tw = dict(model_cfg.get("task_weight", {"cls": 1, "det": 1, "seg": 1}))
    cdn_cfg = det_cfg = None
    if model_cfg.get("bbox_head"):
        bh = model_cfg["bbox_head"]
        dn = bh.get("dn_cfg", {}) or {}
        gc = dn.get("group_cfg", {}) or {}
        ns = dn.get("noise_scale", {}) or {}
        max_gt = 100
        for entry in cfg.get("data", {}).values():
            if entry["task"] == "det":
                max_gt = dict(entry.get("loader", {})).get("max_gt", 100)
        cdn_cfg = CdnConfig(
            num_classes=bh.get("num_classes", 20),
            num_queries=bh.get("num_query", 600),
            max_gt=max_gt,
            num_dn_queries=gc.get("num_dn_queries", 100) or 100,
            label_noise_scale=ns.get("label", 0.5),
            box_noise_scale=ns.get("box", 1.0),
            dn_max_gt=min(gc.get("dn_max_gt", 20), max_gt))
        lc = bh.get("loss_cls", {}) or {}
        lb = bh.get("loss_bbox", {}) or {}
        li = bh.get("loss_iou", {}) or {}
        tc = (model_cfg.get("train_cfg", {}) or {}).get("det", {}) or {}
        asn = tc.get("assigner", {}) or {}
        det_cfg = DetLossConfig(
            num_classes=bh.get("num_classes", 20),
            loss_cls_weight=lc.get("loss_weight", 1.0),
            loss_bbox_weight=lb.get("loss_weight", 5.0),
            loss_iou_weight=li.get("loss_weight", 2.0),
            cost_cls_weight=(asn.get("cls_cost", {}) or {}).get(
                "weight", 2.0),
            cost_bbox_weight=(asn.get("reg_cost", {}) or {}).get(
                "weight", 5.0),
            cost_iou_weight=(asn.get("iou_cost", {}) or {}).get(
                "weight", 2.0),
            focal_alpha=lc.get("alpha", 0.25),
            focal_gamma=lc.get("gamma", 2.0))

    cls_cfg = model_cfg.get("cls_head") or {}
    loss_cfg = cls_cfg.get("loss", {}) or {}
    train_cls = (model_cfg.get("train_cfg", {}) or {}).get("cls", {}) or {}
    return TrainStepConfig(
        task_weight=tw,
        cls_num_classes=cls_cfg.get("num_classes", 45),
        cls_label_smooth=loss_cfg.get("label_smooth_val", 0.1),
        cls_use_augments=bool(train_cls.get("augments")),
        seg_ignore_index=255,
        cdn=cdn_cfg, det=det_cfg,
        img_norm=derive_img_norm(cfg),
        device_aug=derive_device_aug(cfg),
        seg_device_aug=derive_seg_device_aug(cfg),
        det_device_aug=derive_det_device_aug(cfg))


def make_eval_fn(cfg: dict, model, max_per_img: int = 300,
                 skip_det: bool = False, max_batches: int = 0,
                 source=None):
    """``eval_fn(runner=None) -> {"{dataset}.{metric}": value}``: the val
    datasets of a composed config (its test datasets when it has no val
    split; det left out with ``skip_det``) through ``make_infer_steps`` and
    each dataset's ``evaluate``, with the model in eval mode.
    ``MultiDatasetsEvalHook`` calls it with the runner, whose model is this
    one (the train step puts it back in train mode).

    Under ``torch.distributed`` every rank calls it: each evaluates its
    strided batches and the results are gathered
    (``engine.test.adaptive_process_test``), so the metrics are the same on
    every rank. ``source``: an FSDP model whose full weights are gathered
    into ``model`` (a plain copy) before each evaluation."""
    from rscotr_tpu_torch.data.build import build_dataloaders, build_datasets
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.engine.test import (adaptive_process_test,
                                              evaluate_results)
    val_datasets = build_datasets(cfg["data"], split="val") or \
        build_datasets(cfg["data"], split="test")
    if skip_det:
        val_datasets = {k: v for k, v in val_datasets.items()
                        if v.task != "det"}
    loaders = build_dataloaders(val_datasets, cfg["data"], train=False)
    infer = make_infer_steps(
        model, max_per_img=max_per_img, img_norm=derive_img_norm(cfg),
        seg_test_cfg=(cfg["model"].get("test_cfg") or {}).get("seg"))
    eval_kwargs = {t: dict((cfg.get("evaluation") or {}).get(t, {}))
                   for t in ("cls", "det", "seg")}

    prepare = None
    if source is not None:
        from rscotr_tpu_torch.parallel.fsdp import load_full_weights

        def prepare():
            load_full_weights(source, model)

    def eval_fn(runner=None) -> dict:
        model.eval()
        results = adaptive_process_test(infer, loaders,
                                        max_batches=max_batches,
                                        prepare=prepare)
        return evaluate_results(val_datasets, results, eval_kwargs)

    return eval_fn


def load_task_pretrain(model, pretrain_path: str, rule: str = "dino_mmdet"):
    """Load a single-task checkpoint (``.pth``) into ``model`` by top-level
    module: each of ``backbone``, ``neck``, ``bbox_head`` and
    ``shared_encoder`` that both hold, with the same parameter names and
    shapes, is copied (parameters only, as JAX copies the ``params``
    collection); a module whose names or shapes differ is skipped with a
    warning. Returns ``model``.

    As in the JAX package (rscotr_tpu/apis.py:239-260), nothing is renamed:
    a standalone ``DINO`` checkpoint names its encoder ``encoder``, so
    ``shared_encoder`` keeps its init although the reference remaps it
    (ROADMAP C10)."""
    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    logger = get_root_logger()
    src = load_checkpoint(pretrain_path)["state_dict"]
    params = dict(model.named_parameters())
    buffers = {n for n, _ in model.named_buffers()}
    loaded = []
    for top in ("backbone", "neck", "bbox_head", "shared_encoder"):
        pre = top + "."
        dst_names = {n for n in params if n.startswith(pre)}
        src_names = {n for n in src if n.startswith(pre)} - buffers
        if not dst_names or not src_names:
            continue
        if src_names != dst_names or any(
                src[n].shape != params[n].shape for n in dst_names):
            logger.warning("task_pretrain: skipping %s (structure "
                           "mismatch)", top)
            continue
        with torch.no_grad():
            for n in dst_names:
                params[n].copy_(src[n])
        loaded.append(top)
    logger.info("task_pretrain(%s) loaded: %s", rule, loaded)
    return model


def resolve_schedule(cfg: dict, epoch_len: int,
                     max_iters_override: Optional[int] = None) -> dict:
    """The training schedule of either runner flavour.

    ``runner=dict(type='IterBasedRunner', max_iters=N)`` passes through.
    ``runner=dict(type='EpochBasedRunner', max_epochs=N)`` turns epochs
    into iterations with the loader length ``epoch_len``: ``max_iters``,
    by-epoch LR steps, and the checkpoint and eval intervals (each unless
    its ``by_epoch`` is False) scale by ``epoch_len``; the loop stays
    iteration-based. ``max_iters_override`` wins; ``lr_config.max_iters``
    defaults to the result."""
    runner_cfg = dict(cfg.get("runner") or {})
    lr_cfg = dict(cfg.get("lr_config") or {})
    ckpt_cfg = dict(cfg.get("checkpoint_config") or {})
    eval_cfg = dict(cfg.get("evaluation") or {})
    epoch_based = runner_cfg.get("type") == "EpochBasedRunner" or (
        "max_epochs" in runner_cfg and "max_iters" not in runner_cfg)
    if epoch_based:
        epoch_len = max(int(epoch_len), 1)
        max_iters = int(runner_cfg.get("max_epochs", 1)) * epoch_len
        if lr_cfg.get("policy") == "step" and lr_cfg.get("by_epoch", True):
            lr_cfg["step"] = [int(s) * epoch_len
                              for s in lr_cfg.get("step", [])]
        if ckpt_cfg.get("by_epoch", True) and "interval" in ckpt_cfg:
            ckpt_cfg["interval"] = int(ckpt_cfg["interval"]) * epoch_len
        if eval_cfg.get("by_epoch", True) and "interval" in eval_cfg:
            eval_cfg["interval"] = int(eval_cfg["interval"]) * epoch_len
    else:
        max_iters = runner_cfg.get("max_iters", 300000)
    if max_iters_override:
        max_iters = max_iters_override
    lr_cfg.setdefault("max_iters", max_iters)
    return dict(max_iters=max_iters, lr_config=lr_cfg,
                checkpoint_config=ckpt_cfg, evaluation=eval_cfg,
                epoch_based=epoch_based)


def resolve_init_checkpoint(cfg: dict, resume_from, auto_resume: bool,
                            work_dir: str):
    """mmcv's precedence for the first checkpoint: ``--resume-from``, then
    ``cfg["resume_from"]``, then ``--auto-resume``'s latest checkpoint in
    ``work_dir``. A resume (model, optimizer and step) wins over
    ``cfg["load_from"]`` (weights only). Returns ``(resume_path,
    load_path)``, at most one of them set."""
    from rscotr_tpu_torch.engine.checkpoint import find_latest_checkpoint
    if resume_from is None and cfg.get("resume_from"):
        resume_from = cfg["resume_from"]
    if auto_resume and resume_from is None:
        resume_from = find_latest_checkpoint(work_dir)
    if resume_from:
        return resume_from, None
    return None, cfg.get("load_from") or None


def apply_fp16_cfg(cfg: dict) -> bool:
    """The reference's ``fp16 = dict(loss_scale=...)`` as a bf16 compute
    dtype on the model (params, losses and task outputs stay f32); bf16
    has f32's exponent range, so the loss scale is not needed and is
    ignored. Returns True when it applied (not when the model sets a
    dtype already)."""
    if cfg.get("fp16") is None or cfg["model"].get("compute_dtype"):
        return False
    cfg["model"]["compute_dtype"] = "bfloat16"
    get_root_logger().info(
        "fp16 config -> bfloat16 compute dtype (loss_scale ignored: bf16 "
        "keeps the f32 exponent range)")
    return True


def train_model(cfg: dict, work_dir: str, seed: int = 0,
                validate: bool = True, resume_from: Optional[str] = None,
                auto_resume: bool = False, load_task_pretrain_path=None,
                skip_det_eval: bool = False, max_iters_override=None,
                num_devices: Optional[int] = None, device="cuda",
                hooks: Sequence = ()):
    """Train a composed config (``load_data_cfg`` applied) in ``work_dir``
    on ``device`` (the card unless asked); returns the runner.

    The model comes from ``build_model`` with a generator seeded ``seed``
    (the port needs no ``init_model_params``: its modules initialise when
    built). Then the task pretrain, the train datasets and the
    ``MultiDataLoader``, the schedule, the paramwise AdamW (with
    ``momentum_config`` and ``optimizer_config.cumulative_iters``), the
    task masks (``cls_uses_encoder`` for an ``MlvlClsHead``; applied to
    every model type, so a standalone model's ``encoder`` never trains,
    ROADMAP C6), one train step per task, and the runner in the order of
    ``runner.steps_per_dispatch``. A resume loads the model and the
    optimizer state strictly and starts at the checkpoint's ``iter``; the
    data stream starts again, as in JAX (ROADMAP C9). ``load_from`` loads
    weights only. Hooks: log, checkpoint, the eval hook unless
    ``validate`` is False, ``cfg["custom_hooks"]``, then ``hooks``. A
    non-train ``workflow`` phase is logged and ignored.

    Under ``torch.distributed`` (a process group made by
    ``parallel.initialize_distributed``, e.g. ``tools/train.py --launcher
    pytorch``) each rank runs this on its own device
    (``cuda:{LOCAL_RANK}`` on the card): every rank starts from rank 0's
    weights, loads a checkpoint before anything is sharded, loads its
    share of the global batch of ``samples_per_gpu * world``, and its
    steps sum the task-masked gradients over the ranks
    (``parallel.ddp.GradSync``); ``parallel.fsdp=True`` (JAX's key, with
    ``fsdp_min_leaf_size``) shards the parameters and the moments with
    FSDP2 (``parallel.fsdp.shard_model``) and evaluates on a plain copy
    that gathers the full weights. N ranks compute what one process
    computes on the global batch. ``num_devices`` (default: the group's
    world size) must equal the world size: one process per device."""
    from rscotr_tpu_torch.data.build import (build_datasets,
                                             build_multidataloader)
    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    from rscotr_tpu_torch.engine.hooks import (CheckpointHook, LogHook,
                                               MultiDatasetsEvalHook,
                                               build_custom_hooks)
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.runner import IterBasedRunner
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.parallel import mesh as pmesh

    logger = get_root_logger(os.path.join(work_dir, "train.log"))
    distributed = pmesh.is_initialized()
    world = pmesh.world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices} but {world} process(es) run: the "
            "port runs one process per device; launch them with "
            "python -m torch.distributed.run --nproc_per_node "
            f"{num_devices} -m rscotr_tpu_torch.tools.train CONFIG "
            "--launcher pytorch")
    if distributed:
        device = pmesh.local_device(device)
        logger.info("data parallel over %d process(es) (%s, backend %s)",
                    world, device, torch.distributed.get_backend())
    apply_fp16_cfg(cfg)
    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(seed),
                        cls_hw=derive_cls_hw(cfg))
    pmesh.broadcast_module(model)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model built: %.2fM params on %s", n_params / 1e6,
                next(model.parameters()).device)
    if load_task_pretrain_path:
        load_task_pretrain(model, load_task_pretrain_path)

    # checkpoints load on every rank, before anything is sharded; of a
    # resume only the optimizer state is kept, until the optimizer takes it:
    # the file's host copy (~0.7 GiB for the flagship) is not held for the
    # run
    start_step, resume_opt = 0, None
    resume_from, load_from = resolve_init_checkpoint(
        cfg, resume_from, auto_resume, work_dir)
    if resume_from:
        resume_ck = load_checkpoint(resume_from, model=model)
        start_step = int(resume_ck["meta"].get("iter", 0))
        resume_opt = resume_ck["optimizer"]
        logger.info("resumed from %s @ iter %d", resume_ck["path"],
                    start_step)
        del resume_ck
    elif load_from:
        logger.info("loaded weights (load_from) %s",
                    load_checkpoint(load_from, model=model)["path"])

    sync, eval_model = None, model
    par_cfg = cfg.get("parallel") or {}
    if distributed:
        from rscotr_tpu_torch.parallel.ddp import GradSync
        from rscotr_tpu_torch.parallel.fsdp import (DEFAULT_MIN_LEAF_SIZE,
                                                    describe_fsdp,
                                                    fsdp_managed,
                                                    shard_model)
        skip = ()
        if par_cfg.get("fsdp"):
            mls = par_cfg.get("fsdp_min_leaf_size")
            min_leaf = DEFAULT_MIN_LEAF_SIZE if mls is None else int(mls)
            logger.info(describe_fsdp(model, world, min_leaf))
            if validate:
                # strided eval runs on a plain copy that gathers the full
                # weights (FSDP's all-gathers would wait on ranks with
                # fewer eval batches)
                eval_model = build_model(cfg["model"], device=device,
                                         cls_hw=derive_cls_hw(cfg))
            shard_model(model, min_leaf_size=min_leaf)
            skip = fsdp_managed(model)
        sync = GradSync(skip=skip)

    datasets = build_datasets(cfg["data"], split="train")
    multi_loader = build_multidataloader(cfg, datasets, seed=seed,
                                         world_size=world)
    epoch_len = sum(len(dl) for dl in multi_loader.loaders.values())
    sched = resolve_schedule(cfg, epoch_len, max_iters_override)
    max_iters = sched["max_iters"]
    if sched["epoch_based"]:
        logger.info("EpochBasedRunner config: %d iters/epoch -> "
                    "max_iters %d", epoch_len, max_iters)
    wf = cfg.get("workflow") or []
    if any(phase != "train" for phase, _ in wf):
        logger.warning("workflow %s: non-train phases are ignored; "
                       "validation runs via the eval hook "
                       "(cfg.evaluation)", wf)
    momentum_cfg = dict(cfg.get("momentum_config") or {}) or None
    if momentum_cfg:
        momentum_cfg.setdefault("max_iters", max_iters)
        logger.info("momentum schedule on AdamW beta1: %s", momentum_cfg)
    opt_hook_cfg = dict(cfg.get("optimizer_config") or {})
    cumulative_iters = int(opt_hook_cfg.get("cumulative_iters", 1))
    if cumulative_iters > 1:
        logger.info("gradient accumulation: cumulative_iters=%d",
                    cumulative_iters)
    optimizer = build_optimizer(
        cfg["optimizer"], model.named_parameters(),
        lr_config=sched["lr_config"], grad_clip=opt_hook_cfg.get("grad_clip"),
        momentum_config=momentum_cfg, cumulative_iters=cumulative_iters)

    cls_head_cfg = cfg["model"].get("cls_head") or {}
    masks = task_param_masks(
        [n for n, _ in model.named_parameters()],
        cls_uses_encoder=cls_head_cfg.get("type") == "MlvlClsHead")
    step_cfg = make_step_config(cfg)
    tasks_present = {e["task"] for e in cfg["data"].values()}
    kw = {"sync": sync} if sync is not None else {}
    steps = {t: make_train_step(model, optimizer, t, step_cfg, masks.get(t),
                                **kw)
             for t in tasks_present}
    steps_per_dispatch = int((cfg.get("runner") or {}).get(
        "steps_per_dispatch", 1))
    if steps_per_dispatch > 1:
        logger.info("grouped order: up to %d same-task steps a group, as "
                    "the JAX package dispatches them; one call a step",
                    steps_per_dispatch)

    if resume_opt is not None:
        optimizer.load_state_dict(resume_opt)
        del resume_opt

    profile_cfg = dict(cfg.get("profile_cfg") or {})
    if profile_cfg:
        profile_cfg.setdefault("logdir", os.path.join(work_dir, "profile"))
    runner = IterBasedRunner(steps, model, optimizer, max_iters,
                             rng_seed=seed, start_step=start_step,
                             profile_cfg=profile_cfg,
                             steps_per_dispatch=steps_per_dispatch)
    runner.datasets = datasets
    runner.model_cfg = cfg["model"]
    log_cfg = cfg.get("log_config") or {}
    runner.register_hook(LogHook(interval=log_cfg.get("interval", 300),
                                 work_dir=work_dir))
    ckpt_cfg = sched["checkpoint_config"]
    runner.register_hook(CheckpointHook(
        interval=ckpt_cfg.get("interval", 100000), work_dir=work_dir,
        meta={"CLASSES": {n: list(ds.CLASSES)
                          for n, ds in datasets.items()}},
        max_keep_ckpts=ckpt_cfg.get("max_keep_ckpts", -1),
        async_save=bool(ckpt_cfg.get("async_save", False))))
    if validate:
        ev = sched["evaluation"]
        eval_fn = make_eval_fn(
            cfg, eval_model,
            max_per_img=((cfg["model"].get("test_cfg") or {}).get("det")
                         or {}).get("max_per_img", 300),
            skip_det=skip_det_eval,
            source=model if eval_model is not model else None)
        runner.register_hook(MultiDatasetsEvalHook(
            eval_fn, interval=ev.get("interval", 15000),
            save_best=ev.get("save_best"), work_dir=work_dir,
            strict_save_best=not skip_det_eval))
    for hook in [*build_custom_hooks(cfg.get("custom_hooks")), *hooks]:
        runner.register_hook(hook)

    runner.run(multi_loader)
    return runner


def train_model_without_det_eval(cfg: dict, work_dir: str, **kwargs):
    """``train_model`` with the det datasets left out of the evaluation
    (the reference's tools/train_without_det_eval.py)."""
    kwargs["skip_det_eval"] = True
    return train_model(cfg, work_dir, **kwargs)
