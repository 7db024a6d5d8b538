"""Paramwise AdamW with per-task update masks and LR / momentum schedules
(PyTorch counterpart of rscotr_tpu/engine/optimizer.py).

Torch's semantics where they matter, as in the JAX module:

* AdamW with a step count PER PARAMETER and a per-step task mask: a
  parameter the current task does not touch gets no moment update, no
  weight decay and no bias-correction step (torch under DDP
  ``find_unused_parameters``).
* A parameter whose ``.grad`` is None counts as a zero gradient, as JAX's
  zeros do: it adds 0 to the global grad norm, and under a mask of 1 its
  moments decay and its count advances.
* Global-norm grad clip over all gradients, mmcv ``custom_keys``
  multipliers matched longest key first on the parameter name, bias
  correction with the CURRENT beta1 of a momentum schedule, and mmcv
  ``GradientCumulativeOptimizerHook`` averaging over ``cumulative_iters``.

It works on ``model.named_parameters()`` as plain tensor code and updates
the parameters and its own state in place (the JAX optimizer is
functional); it is not ``torch.optim.AdamW``, which has no per-parameter
step counts or masks. Masks and multipliers are host floats, so the schedule
and the branches cost no device sync.

Sharded parameters (FSDP's or tensor parallelism's ``DTensor``s): the
update runs on each rank's local shards and the moments are local shards
too. The global grad norm is the same on every rank: the squared norms of
the sharded gradients are summed over the mesh dims they are sharded on,
then the whole ones are added. ``state_dict`` gathers the moments to full
tensors (a collective on every rank) and ``load_state_dict`` takes full
tensors and keeps this rank's shards.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from rscotr_tpu_torch.parallel.ddp import gather_shards, local


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def make_lr_schedule(lr_config: Optional[dict], base_lr: float
                     ) -> Callable[[int], float]:
    """mmcv lr_config -> step -> lr. Policies 'step', 'poly',
    'CosineAnnealing', 'exp', 'fixed' (by_epoch=False), with linear or
    constant warmup scaling the regular schedule's lr."""
    lr_config = dict(lr_config or {})
    policy = lr_config.get("policy", "fixed")
    known = ("fixed", "step", "poly", "CosineAnnealing", "exp")
    if policy not in known:
        raise ValueError(
            f"lr_config policy {policy!r} not supported (have {known})")
    warmup = lr_config.get("warmup")
    warmup_iters = lr_config.get("warmup_iters", 0)
    warmup_ratio = lr_config.get("warmup_ratio", 0.1)

    def base(step: float) -> float:
        if policy == "step":
            k = sum(step >= s for s in lr_config.get("step", []))
            return base_lr * lr_config.get("gamma", 0.1) ** k
        if policy == "poly":
            min_lr = lr_config.get("min_lr", 0.0)
            frac = min(max(step / lr_config.get("max_iters", 1), 0.0), 1.0)
            return (base_lr - min_lr) * (1 - frac) ** \
                lr_config.get("power", 1.0) + min_lr
        if policy == "CosineAnnealing":
            if lr_config.get("min_lr") is not None:
                target = float(lr_config["min_lr"])
            else:
                target = base_lr * float(lr_config.get("min_lr_ratio", 0.0))
            frac = min(max(step / lr_config.get("max_iters", 1), 0.0), 1.0)
            return target + 0.5 * (base_lr - target) * (
                1.0 + math.cos(math.pi * frac))
        if policy == "exp":
            return base_lr * lr_config.get("gamma", 1.0) ** step
        return base_lr

    def sched(step: int) -> float:
        step = float(step)
        lr = base(step)
        if warmup == "linear" and warmup_iters > 0 and step < warmup_iters:
            lr *= 1.0 - (1.0 - step / warmup_iters) * (1.0 - warmup_ratio)
        elif warmup == "constant" and warmup_iters > 0 and \
                step < warmup_iters:
            lr *= warmup_ratio
        return lr

    return sched


def make_momentum_schedule(momentum_config: Optional[dict],
                           base_momentum: float
                           ) -> Optional[Callable[[int], float]]:
    """mmcv momentum_config -> step -> beta1 (the LR policies with
    min_momentum / min_momentum_ratio for min_lr / min_lr_ratio)."""
    if not momentum_config:
        return None
    mc = dict(momentum_config)
    if "min_momentum" in mc:
        mc["min_lr"] = mc.pop("min_momentum")
    if "min_momentum_ratio" in mc:
        mc["min_lr_ratio"] = mc.pop("min_momentum_ratio")
    return make_lr_schedule(mc, base_momentum)


# ---------------------------------------------------------------------------
# Paramwise multipliers and task masks, keyed by parameter name
# ---------------------------------------------------------------------------

def paramwise_multipliers(names: Iterable[str], custom_keys: Dict[str, dict]
                          ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Per-parameter (lr_mult, decay_mult) from mmcv-style custom_keys: the
    longest key that is a substring of the name wins."""
    keys = sorted(custom_keys, key=len, reverse=True)
    lr, decay = {}, {}
    for name in names:
        lr[name], decay[name] = 1.0, 1.0
        for k in keys:
            if k in name:
                lr[name] = float(custom_keys[k].get("lr_mult", 1.0))
                decay[name] = float(custom_keys[k].get("decay_mult", 1.0))
                break
    return lr, decay


def no_decay_for_norms_and_biases(params: Mapping[str, torch.Tensor],
                                  decay: Mapping[str, float]
                                  ) -> Dict[str, float]:
    """Opt-in: no weight decay on biases, norms and 0/1-dim parameters
    (torch AdamW and the reference decay everything by default)."""
    return {n: (0.0 if n.endswith(".bias") or "norm" in n.lower() or
                p.dim() <= 1 else decay[n]) for n, p in params.items()}


def task_param_masks(names: Iterable[str], cls_uses_encoder: bool = False
                     ) -> Dict[str, Dict[str, float]]:
    """Per-task {name: 0.0 / 1.0} masks by top-level module: cls touches
    backbone + cls_head (+ neck and shared_encoder for MlvlClsHead), det
    backbone + neck + shared_encoder + bbox_head, seg the same with
    seg_head."""
    shared = {"backbone", "neck", "shared_encoder"}
    touch = {
        "cls": {"backbone", "cls_head"} | (shared if cls_uses_encoder
                                           else set()),
        "det": shared | {"bbox_head"},
        "seg": shared | {"seg_head"},
    }
    names = list(names)
    return {t: {n: float(n.split(".")[0] in touch[t]) for n in names}
            for t in touch}


# ---------------------------------------------------------------------------
# Sharded parameters
# ---------------------------------------------------------------------------

def _shard_dims(p: torch.Tensor) -> Tuple[int, ...]:
    if not isinstance(p, DTensor):
        return ()
    return tuple(i for i, pl in enumerate(p.placements)
                 if isinstance(pl, Shard))


def _full(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The full tensor of ``like``'s shape from a local shard ``t`` laid
    out as ``like`` (a collective when ``like`` is sharded)."""
    if not isinstance(like, DTensor):
        return t
    return gather_shards(t, like.device_mesh, like.placements, like.shape)


def _shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``full`` laid out as ``like`` (every rank holds
    ``full``: no communication)."""
    if not isinstance(like, DTensor):
        return full
    return distribute_tensor(full.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None).to_local()


def global_grad_norm(grads: Mapping[str, torch.Tensor],
                     params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every gradient in ``grads`` (local tensors), the
    sharded ones' squares summed over their mesh dims first."""
    groups: Dict[tuple, list] = {}
    for n, g in grads.items():
        p = params[n]
        key = (id(p.device_mesh), _shard_dims(p)) if _shard_dims(p) else ()
        groups.setdefault(key, []).append((p, g))
    dev = next(iter(params.values())).device
    total = torch.zeros((), device=dev)
    for key, items in sorted(groups.items(), key=lambda kv: kv[0] != ()):
        sq = torch.stack(torch._foreach_norm([g for _, g in items])
                         ).float().square().sum()
        if key:
            mesh = items[0][0].device_mesh
            for d in key[1]:
                dist.all_reduce(sq, group=mesh.get_group(d))
        total = total + sq
    return total.sqrt()


# ---------------------------------------------------------------------------
# AdamW with per-parameter step counts and task masking
# ---------------------------------------------------------------------------

class MtlOptimizer:
    """AdamW over named parameters, updated in place by ``update``."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 grad_clip_norm: Optional[float] = 0.1,
                 lr_mult: Optional[Mapping[str, float]] = None,
                 decay_mult: Optional[Mapping[str, float]] = None,
                 b1_schedule: Optional[Callable[[int], float]] = None,
                 cumulative_iters: int = 1):
        self.params = dict(params)
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.lr_mult = dict(lr_mult or {})
        self.decay_mult = dict(decay_mult or {})
        self.b1_schedule = b1_schedule
        self.cumulative_iters = int(cumulative_iters)
        self.mu = {n: torch.zeros_like(local(p))
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(local(p))
                   for n, p in self.params.items()}
        self.count = {n: 0 for n in self.params}
        self.step = 0
        if self.cumulative_iters > 1:
            self.accum = {n: torch.zeros_like(local(p))
                          for n, p in self.params.items()}
            self.accum_mask = {n: 0.0 for n in self.params}

    @torch.no_grad()
    def update(self, grads: Mapping[str, Optional[torch.Tensor]],
               mask: Optional[Mapping[str, float]] = None) -> torch.Tensor:
        """One optimizer iteration; returns the global grad norm (a device
        scalar) of the (averaged) gradients before clipping."""
        names = list(self.params)
        g = {n: local(grads.get(n)) for n in names}
        m = {n: 1.0 if mask is None else float(mask[n]) for n in names}
        K = self.cumulative_iters
        if K > 1:
            for n in names:
                g[n] = self.accum[n] if g[n] is None else \
                    self.accum[n] + g[n] / K
                m[n] = max(self.accum_mask[n], m[n])
            apply = (self.step + 1) % K == 0
            for n in names:
                self.accum[n] = torch.zeros_like(g[n]) if apply else g[n]
                self.accum_mask[n] = 0.0 if apply else m[n]
                if not apply:
                    m[n] = 0.0
        gnorm = global_grad_norm(
            {n: t for n, t in g.items() if t is not None}, self.params)
        scale = None
        if self.grad_clip_norm is not None:
            scale = torch.clamp(self.grad_clip_norm /
                                torch.clamp(gnorm, min=1e-6), max=1.0)

        lr = self.lr_schedule(self.step)
        b1 = self.b1_schedule(self.step) if self.b1_schedule else self.b1
        b2 = self.b2
        # masked-in parameters, grouped by what makes their scalars differ
        groups: Dict[Tuple[int, float, float], list] = {}
        for n in names:
            if m[n] <= 0:
                continue
            self.count[n] += 1
            key = (self.count[n], self.lr_mult.get(n, 1.0),
                   self.decay_mult.get(n, 1.0))
            groups.setdefault(key, []).append(n)
        for (count, lm, dm), ns in groups.items():
            ps = [local(self.params[n]) for n in ns]
            mus = [self.mu[n] for n in ns]
            nus = [self.nu[n] for n in ns]
            gs = [g[n] if g[n] is not None else torch.zeros_like(p)
                  for n, p in zip(ns, ps)]
            if scale is not None:
                gs = torch._foreach_mul(gs, scale)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, gs, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
            mhat = torch._foreach_div(mus, 1 - b1 ** count)
            den = torch._foreach_div(nus, 1 - b2 ** count)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mhat, den)
            if self.weight_decay * dm:
                torch._foreach_add_(upd, ps, alpha=self.weight_decay * dm)
            torch._foreach_add_(ps, upd, alpha=-lr * lm)
        self.step += 1
        return gnorm

    def state_dict(self) -> dict:
        """The state to resume from: the step, the per-parameter update
        counts, the moments (and the gradient accumulators when
        ``cumulative_iters > 1``), full tensors copied to the CPU (sharded
        ones gathered: every rank calls it)."""
        def full(state):
            return {n: _full(t.detach(), self.params[n]).cpu().clone()
                    for n, t in state.items()}

        out = {"step": self.step, "count": dict(self.count),
               "mu": full(self.mu), "nu": full(self.nu)}
        if self.cumulative_iters > 1:
            out["accum"] = full(self.accum)
            out["accum_mask"] = dict(self.accum_mask)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output, over the same parameter
        names."""
        if set(state["mu"]) != set(self.params):
            raise KeyError("optimizer state names other parameters: "
                           f"{sorted(set(state['mu']) ^ set(self.params))}")
        self.step = int(state["step"])
        self.count = {n: int(state["count"][n]) for n in self.params}
        for n, p in self.params.items():
            self.mu[n].copy_(_shard_of(state["mu"][n], p))
            self.nu[n].copy_(_shard_of(state["nu"][n], p))
        if self.cumulative_iters > 1:
            for n, p in self.params.items():
                self.accum[n].copy_(_shard_of(state["accum"][n], p))
            self.accum_mask = {n: float(state["accum_mask"][n])
                               for n in self.params}


def build_optimizer(optimizer_cfg: dict,
                    named_params: Iterable[Tuple[str, torch.Tensor]],
                    lr_config: Optional[dict] = None,
                    grad_clip: Optional[dict] = None,
                    momentum_config: Optional[dict] = None,
                    cumulative_iters: int = 1) -> MtlOptimizer:
    """Build from reference-shaped configs (optimizer / lr_config /
    optimizer_config.{grad_clip, cumulative_iters} / momentum_config)."""
    cfg = dict(optimizer_cfg)
    if cfg.get("type", "AdamW") != "AdamW":
        raise ValueError(f"optimizer type {cfg.get('type')} (AdamW only)")
    params = dict(named_params)
    custom_keys = (cfg.get("paramwise_cfg") or {}).get("custom_keys") or {}
    lr_mult, decay_mult = paramwise_multipliers(params, custom_keys)
    b1, b2 = cfg.get("betas", (0.9, 0.999))
    base_lr = cfg.get("lr", 5e-5)
    return MtlOptimizer(
        params, make_lr_schedule(lr_config, base_lr), b1=b1, b2=b2,
        eps=cfg.get("eps", 1e-8),
        weight_decay=cfg.get("weight_decay", 1e-4),
        grad_clip_norm=(float(grad_clip.get("max_norm", 0.1)) if grad_clip
                        else None),
        lr_mult=lr_mult, decay_mult=decay_mult,
        b1_schedule=make_momentum_schedule(momentum_config, b1),
        cumulative_iters=int(cumulative_iters))
