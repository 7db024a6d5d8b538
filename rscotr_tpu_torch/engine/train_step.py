"""Per-task train steps (PyTorch counterpart of
rscotr_tpu/engine/train_step.py): forward the single-task batch, sum the
loss dict, scale it by ``task_weight[task]``, backpropagate and apply the
optimizer under the task's parameter mask.

JAX's step is functional, ``(params, opt_state, batch, rng) -> (params,
opt_state, log_vars)``. The port's ``step(batch, generator) -> log_vars``
updates the model's parameters and the optimizer's state IN PLACE, and
takes an explicit ``torch.Generator`` for everything random in the step
(drop path, dropout, CDN noise, the cls batch augment); a CPU generator
keeps those draws off the device's critical path. ``log_vars`` holds every
weighted loss term, their sum ``loss`` and ``grad_norm``, as device scalars.

Ported: the cls, det and seg steps with their on-device augment branches
(a batch with ``aug_*`` records runs ``ops/device_augment.py``'s stage on
the batch's device, then the explicit normalize, then for seg and det the
``img_hw`` pad mask), and ``make_val_step`` (their losses with the model in
eval mode). JAX's K-step scanned dispatch is not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rscotr_tpu_torch.engine.infer import (device_normalize, normalize,
                                           resize_linear)
from rscotr_tpu_torch.models.heads.cdn import (CdnConfig, cdn_self_attn_mask,
                                               draw_cdn_noise,
                                               generate_cdn_queries)
from rscotr_tpu_torch.models.heads.dino_loss import (DetLossConfig,
                                                     avg_factors, dino_loss)
from rscotr_tpu_torch.ops.box_ops import bbox_xyxy_to_cxcywh
from rscotr_tpu_torch.ops.device_augment import (DetDeviceAugmentConfig,
                                                 DeviceAugmentConfig,
                                                 SegDeviceAugmentConfig,
                                                 run_stage)
from rscotr_tpu_torch.ops.losses import (counted_labels, label_smooth_loss,
                                        softmax_cross_entropy)
from rscotr_tpu_torch.parallel.ddp import reduce_sum
from rscotr_tpu_torch.utils.rng import per_sample, step_shard


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    task_weight: Dict[str, float]
    cls_num_classes: int = 45
    cls_label_smooth: float = 0.1
    cls_mixup_alpha: float = 0.8
    cls_cutmix_alpha: float = 1.0
    cls_use_augments: bool = True
    seg_ignore_index: int = 255
    seg_loss_weight: float = 1.0
    cdn: Optional[CdnConfig] = None
    det: Optional[DetLossConfig] = None
    # (mean, std) in 0-255 range for uint8 batches; None = ImageNet stats
    img_norm: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    # on-device augmentation stages, set when the task's loader asks
    # (loader.{cls,seg,det}_device_augment; the batch carries aug_* records)
    device_aug: Optional[DeviceAugmentConfig] = None
    seg_device_aug: Optional[SegDeviceAugmentConfig] = None
    det_device_aug: Optional[DetDeviceAugmentConfig] = None


# ---------------------------------------------------------------------------
# cls batch augments (mmcls BatchMixup / BatchCutMix, one chosen per batch)
# ---------------------------------------------------------------------------

def draw_cls_augment(generator: torch.Generator, B: int, H: int, W: int,
                     mixup_alpha: float = 0.8,
                     cutmix_alpha: float = 1.0) -> dict:
    """The random draws of ``cls_batch_augment``: a seed from ``generator``
    drives a numpy generator (torch has no seeded Beta sampler)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    rng = np.random.default_rng(seed)
    return dict(perm=rng.permutation(B),
                lam_m=np.float32(rng.beta(mixup_alpha, mixup_alpha)),
                lam_c=np.float32(rng.beta(cutmix_alpha, cutmix_alpha)),
                cx=int(rng.integers(0, W)), cy=int(rng.integers(0, H)),
                use_cutmix=bool(rng.random() < 0.5))


def cls_batch_augment(img: torch.Tensor, labels: torch.Tensor,
                      num_classes: int, draws: dict):
    """Mixup or cutmix of the batch with its permutation ``draws['perm']``
    (train_step.py:79-113 of the JAX package): returns the mixed images and
    the soft targets (B, num_classes)."""
    B, H, W, _ = img.shape
    perm = torch.as_tensor(draws["perm"], device=img.device)
    one = F.one_hot(labels.long(), num_classes).float()
    if draws["use_cutmix"]:
        ratio = np.sqrt(np.float32(1.0) - draws["lam_c"])
        cw = int(np.float32(W) * ratio)
        ch = int(np.float32(H) * ratio)
        cx, cy = draws["cx"], draws["cy"]
        x1, x2 = np.clip([cx - cw // 2, cx + cw // 2], 0, W)
        y1, y2 = np.clip([cy - ch // 2, cy + ch // 2], 0, H)
        out = img.clone()
        out[:, y1:y2, x1:x2] = img[perm][:, y1:y2, x1:x2]
        lam = np.float32(1.0) - np.float32((x2 - x1) * (y2 - y1)) / \
            np.float32(H * W)
    else:
        lam = draws["lam_m"]
        out = float(lam) * img + float(np.float32(1.0) - lam) * img[perm]
    target = float(lam) * one + float(np.float32(1.0) - lam) * one[perm]
    return out, target


# ---------------------------------------------------------------------------
# per-task loss functions
# ---------------------------------------------------------------------------

def _input(task, batch, generator, cfg: TrainStepConfig, train: bool):
    """The step's normalized input. With ``train`` and a stage for the
    batch (``run_stage``): the stage, then normalize, then for seg and det
    the ``img_hw`` pad mask, in JAX's order (the seg stage's pad region
    picks up the photometric adds, zeroed after the normalize). Else the
    batch's own pixels, normalized and masked."""
    img_hw = None if task == "cls" else batch.get("img_hw")
    out = run_stage(task, batch, cfg, generator) if train else None
    if out is not None:
        return normalize(out, cfg.img_norm, img_hw)
    return device_normalize(batch["img"], cfg.img_norm, img_hw)


def cls_loss_fn(model, batch, generator, cfg: TrainStepConfig,
                train: bool = True):
    """``train=False`` (the val step, on a model in eval mode) skips the
    device and batch augments and draws nothing in the forward, as JAX's
    ``deterministic=True`` does; the same holds for the seg and det loss."""
    img = _input("cls", batch, generator, cfg, train)
    target = batch["gt_label"]
    if train and cfg.cls_use_augments:
        draws = draw_cls_augment(generator, *img.shape[:3],
                                 cfg.cls_mixup_alpha, cfg.cls_cutmix_alpha)
        img, target = cls_batch_augment(img, target, cfg.cls_num_classes,
                                        draws)
    logits = model.forward_cls(img, generator if train else None)
    return {"loss_cls": label_smooth_loss(
        logits, target, label_smooth_val=cfg.cls_label_smooth)}


def seg_loss_fn(model, batch, generator, cfg: TrainStepConfig,
                train: bool = True):
    """mmseg's decode-head CE: the logits resized to the labels' size as
    ``jax.image.resize(method="linear")`` does (``resize_linear``, which
    averages when it shrinks), softmax CE over every channel (scheme 2's
    one per query too, ROADMAP C4) with ``seg_ignore_index``, over the
    count of the global batch (``reduce_sum``)."""
    img = _input("seg", batch, generator, cfg, train)
    gt = batch["gt_semantic_seg"]
    logits = model.forward_seg(img, generator if train else None)
    if isinstance(logits, tuple):
        raise NotImplementedError(
            "Mask2FormerHead scheme 3 serves only: Mask2Former's matched mask "
            "and class losses are not ported")
    logits = resize_linear(logits, gt.shape[1:3])
    count = counted_labels(gt, logits.shape[-1], cfg.seg_ignore_index)
    loss = softmax_cross_entropy(
        logits, gt, ignore_index=cfg.seg_ignore_index,
        avg_factor=reduce_sum(count.to(logits.dtype).sum()))
    return {"seg.loss_ce": loss * cfg.seg_loss_weight}


def det_loss_fn(model, batch, generator, cfg: TrainStepConfig,
                mask_cache: Optional[dict] = None, train: bool = True):
    """With ``train=False`` the CDN noise is still drawn from ``generator``
    (JAX's val step draws it from its key too). The avg factors are the
    global batch's (``reduce_sum``)."""
    img_hw = batch["img_hw"]
    img = _input("det", batch, generator, cfg, train)
    gt_bboxes, gt_labels = batch["gt_bboxes"], batch["gt_labels"]
    gt_valid = batch["gt_valid"].bool()
    h, w = img_hw[:, 0].float(), img_hw[:, 1].float()
    gt_norm = bbox_xyxy_to_cxcywh(
        gt_bboxes / torch.stack([w, h, w, h], -1)[:, None, :])

    # DN group widening: the collate encodes the ladder width it chose in
    # the SHAPE of the zero-width ``dn_wide`` entry (ROADMAP C1)
    cdn_cfg = cfg.cdn
    if "dn_wide" in batch:
        s_sel = int(batch["dn_wide"].shape[1])
        if s_sel != cdn_cfg.single_pad:
            cdn_cfg = dataclasses.replace(cdn_cfg, dn_max_gt=s_sel)
    # a batch may carry pre-drawn CDN noise (dn_noise_* entries) so a test
    # drives this and the JAX step with identical draws
    if "dn_noise_p" in batch:
        noise = {k: batch[f"dn_noise_{k}"]
                 for k in ("p", "new_label", "sign", "part")}
    else:
        noise = per_sample(lambda n: draw_cdn_noise(generator, n, cdn_cfg),
                           img.shape[0])
    dn_label_q, dn_bbox_q = generate_cdn_queries(
        gt_norm, gt_labels, gt_valid,
        model.bbox_head.label_embedding.weight, cdn_cfg, noise)
    cache = mask_cache if mask_cache is not None else {}
    if cdn_cfg not in cache:
        cache[cdn_cfg] = torch.as_tensor(cdn_self_attn_mask(cdn_cfg),
                                         device=img.device)
    outs = model.forward_det(img, img_hw, dn_label_q, dn_bbox_q,
                             cache[cdn_cfg], generator if train else None)
    factors = reduce_sum(avg_factors(gt_bboxes, gt_labels, gt_valid, img_hw,
                                     cdn_cfg, cfg.det))
    return dino_loss(*outs, gt_bboxes, gt_labels, gt_valid, img_hw, cdn_cfg,
                     cfg.det, factors)


def parse_losses(losses: Dict[str, torch.Tensor]):
    """Sum all entries into the total loss (reference _parse_losses)."""
    total = sum(losses.values())
    log_vars = dict(losses)
    log_vars["loss"] = total
    return total, log_vars


# ---------------------------------------------------------------------------
# step factory
# ---------------------------------------------------------------------------

def make_train_step(model, optimizer, task: str, cfg: TrainStepConfig,
                    task_mask: Optional[Dict[str, float]] = None,
                    sync=None):
    """Returns ``step(batch, generator) -> log_vars``; ``batch`` holds numpy
    arrays or tensors, moved to the model's device.

    ``sync`` (a ``parallel.ddp.GradSync``): data parallelism over its
    ranks. The batch is this rank's share of the global batch; the step
    runs under ``utils.rng.step_shard`` (per-sample draws for the global
    batch, this rank's rows kept; det and seg normalizers summed over the
    ranks), the cls loss, a mean over the local batch, is scaled by
    ``1 / world``, and the task-masked gradients are summed over the ranks
    before the update. ``log_vars`` then hold this rank's shares of the
    loss terms (their sum over the ranks is the global loss;
    ``LogHook`` sums them on its log steps) and the global ``grad_norm``.
    """
    if task not in ("cls", "det", "seg"):
        raise ValueError(f"unknown task {task!r}")
    weight = float(cfg.task_weight.get(task, 1.0))
    params = dict(model.named_parameters())
    device = next(model.parameters()).device
    mask_cache: dict = {}
    world = sync.world if sync is not None else 1
    share = weight / world if task == "cls" else weight

    def step(batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        model.train()
        for p in params.values():
            p.grad = None
        with step_shard(world, sync.rank if sync else 0,
                        sync.group if sync else None):
            if task == "cls":
                losses = cls_loss_fn(model, batch, generator, cfg)
            elif task == "seg":
                losses = seg_loss_fn(model, batch, generator, cfg)
            else:
                losses = det_loss_fn(model, batch, generator, cfg,
                                     mask_cache)
            total, log_vars = parse_losses(losses)
            (total * share).backward()
        log_vars = {k: v.detach() * share for k, v in log_vars.items()}
        if sync is not None:
            sync(params, task_mask)
        log_vars["grad_norm"] = optimizer.update(
            {n: p.grad for n, p in params.items()}, task_mask)
        for p in params.values():
            p.grad = None
        return log_vars

    return step


def make_val_step(model, task: str, cfg: TrainStepConfig):
    """Returns ``step(batch, generator) -> log_vars``: the task's loss terms
    and their sum ``loss``, each scaled by ``task_weight[task]``, with the
    model in eval mode and no gradients (JAX's ``make_val_step``, the loss
    functions with ``train=False``). ``generator`` draws the det step's CDN
    noise (unless the batch carries it) and nothing else."""
    if task not in ("cls", "det", "seg"):
        raise ValueError(f"unknown task {task!r}")
    weight = float(cfg.task_weight.get(task, 1.0))
    device = next(model.parameters()).device
    mask_cache: dict = {}

    @torch.no_grad()
    def step(batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        model.eval()
        if task == "cls":
            losses = cls_loss_fn(model, batch, generator, cfg, train=False)
        elif task == "seg":
            losses = seg_loss_fn(model, batch, generator, cfg, train=False)
        else:
            losses = det_loss_fn(model, batch, generator, cfg, mask_cache,
                                 train=False)
        _, log_vars = parse_losses(losses)
        return {k: v * weight for k, v in log_vars.items()}

    return step
