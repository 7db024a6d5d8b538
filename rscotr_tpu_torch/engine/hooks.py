"""Runner hooks of the port (counterpart of rscotr_tpu/engine/hooks.py):
logging, checkpoints, the multi-dataset evaluation with save-best, and the
hooks a config adds under ``custom_hooks``.

A hook sees the runner after each step: ``runner.step`` (steps done),
``runner.max_iters``, ``runner.log_vars``, ``runner.loss_keys`` (the step's
loss terms among them), ``runner.model``, ``runner.optimizer``,
``runner.preempted``, and ``runner.datasets`` / ``runner.model_cfg`` where
``train_model`` sets them. Hooks fire in ascending ``priority``.

Under ``torch.distributed`` every hook runs on every rank (JAX's hooks run
in every process): ``LogHook`` sums the ranks' loss shares on its log
steps and rank 0 writes them; a checkpoint save is a collective that rank
0 writes; the eval hook evaluates on every rank and decides save-best from
the gathered metrics, which are the same on every rank.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Callable, Dict, Optional

from rscotr_tpu_torch.engine.checkpoint import (CheckpointWriter,
                                                save_checkpoint)
from rscotr_tpu_torch.parallel.ddp import sum_log_vars
from rscotr_tpu_torch.parallel.multihost import process_index
from rscotr_tpu_torch.utils.logging import MetricsSink, get_root_logger
from rscotr_tpu_torch.utils.registry import HOOKS


class Hook:
    priority = 50
    # grouped order (steps_per_dispatch > 1): True keeps a group from
    # crossing this hook's ``interval`` boundary, as JAX's dispatch groups
    # do for hooks that read the parameters; hooks that read only the
    # per-step log_vars set False (runner._hook_boundary)
    scan_boundary = True

    def before_run(self, runner) -> None:
        pass

    def after_train_iter(self, runner) -> None:
        pass

    def after_run(self, runner) -> None:
        pass


# mmcv Priority names, accepted in hook configs (lower fires first)
PRIORITY_NAMES = {
    "HIGHEST": 0, "VERY_HIGH": 10, "HIGH": 30, "ABOVE_NORMAL": 40,
    "NORMAL": 50, "BELOW_NORMAL": 60, "LOW": 70, "VERY_LOW": 90,
    "LOWEST": 100,
}


def build_custom_hooks(custom_hooks_cfg) -> list:
    """The hooks of ``cfg["custom_hooks"]``: each entry ``dict(type=Name,
    priority=..., **kwargs)`` built through ``HOOKS``; ``priority`` takes an
    mmcv name or an int."""
    hooks = []
    for item in (custom_hooks_cfg or []):
        item = dict(item)
        prio = item.pop("priority", None)
        h = HOOKS.build(item)
        if prio is not None:
            h.priority = (PRIORITY_NAMES[prio] if isinstance(prio, str)
                          else int(prio))
        hooks.append(h)
    return hooks


@HOOKS.register_module()
class NumClassCheckHook(Hook):
    """Before training, check that each dataset's CLASSES count equals its
    task head's ``num_classes`` (mmdet's hook of the same name)."""
    _HEAD_KEYS = {"cls": "cls_head", "det": "bbox_head", "seg": "seg_head"}

    def before_run(self, runner) -> None:
        datasets = getattr(runner, "datasets", None) or {}
        model_cfg = getattr(runner, "model_cfg", None) or {}
        for name, ds in datasets.items():
            task = getattr(ds, "task", None)
            classes = getattr(ds, "CLASSES", None)
            head = model_cfg.get(self._HEAD_KEYS.get(task, "")) or {}
            # a standalone segmentor names its head decode_head
            if not head and task == "seg":
                head = model_cfg.get("decode_head") or {}
            num = head.get("num_classes")
            if num is None or classes is None:
                continue
            if len(classes) != int(num):
                raise ValueError(
                    f"NumClassCheckHook: dataset '{name}' has "
                    f"{len(classes)} CLASSES but the {task} head is "
                    f"configured with num_classes={num}")


@HOOKS.register_module()
class LogHook(Hook):
    """Every ``interval`` steps and at the last: the log vars to
    ``metrics.jsonl`` (and TensorBoard) and the main ones to the log, with
    ``time`` the mean seconds a step since the last line. This is where the
    steps' device scalars become Python floats: the runner reads none."""
    priority = 90
    scan_boundary = False

    def __init__(self, interval: int = 300, work_dir: str = "work_dir"):
        self.interval = interval
        self.sink = MetricsSink(work_dir) if process_index() == 0 else None
        self.logger = get_root_logger()
        self._t0 = time.time()
        self._iter0 = 0

    def before_run(self, runner) -> None:
        self._t0 = time.time()
        self._iter0 = runner.step

    def after_train_iter(self, runner) -> None:
        if runner.step % self.interval != 0 and \
                runner.step != runner.max_iters:
            return
        lv = sum_log_vars(runner.log_vars, getattr(runner, "loss_keys", ()))
        logs = {k: float(v) for k, v in lv.items()}
        iters = max(runner.step - self._iter0, 1)
        logs["time"] = (time.time() - self._t0) / iters
        self._t0 = time.time()
        self._iter0 = runner.step
        if self.sink is None:
            return
        self.sink.log_scalars(runner.step, logs)
        main = {k: round(v, 4) for k, v in logs.items()
                if k.endswith(".loss")
                or k in ("loss", "time", "data_time", "grad_norm")}
        self.logger.info("iter %d/%d %s", runner.step, runner.max_iters,
                         main)

    def after_run(self, runner) -> None:
        if self.sink is not None:
            self.sink.close()


@HOOKS.register_module()
class CheckpointHook(Hook):
    """Every ``interval`` steps and at the last: ``iter_N.pth`` with the
    model, the optimizer state and ``meta`` (mmcv CheckpointHook).
    ``max_keep_ckpts`` keeps the newest N ``iter_N.pth`` files (-1: all);
    ``best_checkpoint.pth`` is never touched, and neither is a checkpoint
    ahead of the current step (left by an earlier run in the same work
    dir). ``async_save`` copies the state to the host in the loop and
    writes the file on a writer thread; ``after_run`` drains it and
    re-raises a failed write (one process only: under
    ``torch.distributed`` rank 0 writes in the save's collective). After a
    preemption (SIGTERM) ``after_run`` writes the current step's
    checkpoint if no save covered it."""
    priority = 70

    def __init__(self, interval: int = 100000, work_dir: str = "work_dir",
                 meta: Optional[dict] = None, max_keep_ckpts: int = -1,
                 async_save: bool = False):
        self.interval = interval
        self.work_dir = work_dir
        self.meta = meta or {}
        self.max_keep_ckpts = max_keep_ckpts
        self.writer = CheckpointWriter() if async_save else None
        self._last_saved = -1

    def _prune(self, current_step: int) -> None:
        if self.max_keep_ckpts <= 0:
            return
        steps = []
        for f in os.listdir(self.work_dir):
            m = re.fullmatch(r"iter_(\d+)\.pth", f)
            if m and int(m.group(1)) <= current_step:
                steps.append(int(m.group(1)))
        for s in sorted(steps)[:-self.max_keep_ckpts]:
            try:
                os.remove(os.path.join(self.work_dir, f"iter_{s}.pth"))
            except OSError:
                get_root_logger().exception(
                    "checkpoint prune failed for iter_%d.pth", s)

    def _save(self, runner) -> None:
        step = runner.step
        save_checkpoint(self.work_dir, step, runner.model, runner.optimizer,
                        meta=self.meta, writer=self.writer,
                        post_save=lambda: self._prune(step))
        self._last_saved = step

    def after_train_iter(self, runner) -> None:
        if runner.step % self.interval == 0 or \
                runner.step == runner.max_iters:
            self._save(runner)

    def after_run(self, runner) -> None:
        if getattr(runner, "preempted", False) and \
                self._last_saved != runner.step and runner.step > 0:
            get_root_logger().info(
                "preemption checkpoint @ iter %d", runner.step)
            self._save(runner)
        if self.writer is not None:
            self.writer.wait()


class KeyIndicator:
    """The weighted multi-metric save-best score (the reference's
    evaluation.py:9-26, :144-148): ``sum(w_i * metrics[key_i]) /
    len(keys)``. Strict by default: a configured key missing from the
    metrics raises. ``strict=False`` (the without-det-eval flow, whose det
    keys are absent) warns once a key and counts it 0, as the reference's
    ``eval_res.get(key, 0.)`` does."""

    def __init__(self, key_weights: Dict[str, float], strict: bool = True):
        self.key_weights = dict(key_weights)
        self.strict = strict
        self._warned: set = set()

    def __call__(self, metrics: Dict[str, float]) -> float:
        total = 0.0
        for key, w in self.key_weights.items():
            if key in metrics:
                total += w * float(metrics[key])
            elif self.strict:
                raise KeyError(
                    f"save_best metric {key!r} missing from eval metrics "
                    f"{sorted(metrics)}: check the configured key names")
            elif key not in self._warned:
                self._warned.add(key)
                get_root_logger().warning(
                    "save_best metric %r missing from eval metrics %s: "
                    "it contributes 0 to the best score",
                    key, sorted(metrics))
        if not self.key_weights:
            return float("-inf")
        return total / len(self.key_weights)


@HOOKS.register_module()
class MultiDatasetsEvalHook(Hook):
    """Every ``interval`` steps and at the last: ``eval_fn(runner)`` over
    the val sets, its metrics logged with its seconds and added to
    ``log_vars`` as ``val/{key}``; with ``save_best``, a better
    ``KeyIndicator`` score writes ``best_checkpoint.pth`` (weights only)."""
    priority = 30

    def __init__(self, eval_fn: Callable[[Any], Dict[str, float]],
                 interval: int = 15000,
                 save_best: Optional[Dict[str, float]] = None,
                 work_dir: str = "work_dir",
                 strict_save_best: bool = True):
        self.eval_fn = eval_fn
        self.interval = interval
        self.indicator = (KeyIndicator(save_best, strict=strict_save_best)
                          if save_best else None)
        self.work_dir = work_dir
        self.best_score = float("-inf")
        self.logger = get_root_logger()

    def after_train_iter(self, runner) -> None:
        if runner.step % self.interval != 0 and \
                runner.step != runner.max_iters:
            return
        t0 = time.perf_counter()
        metrics = self.eval_fn(runner)
        self.logger.info("eval @ iter %d in %.2f s: %s", runner.step,
                         time.perf_counter() - t0,
                         {k: round(float(v), 4) for k, v in metrics.items()})
        runner.log_vars.update({f"val/{k}": v for k, v in metrics.items()})
        if self.indicator is not None:
            score = self.indicator(metrics)
            if score > self.best_score:
                self.best_score = score
                save_checkpoint(self.work_dir, runner.step, runner.model,
                                meta={"best_score": score,
                                      "metrics": metrics},
                                name="best_checkpoint")
                self.logger.info("new best score %.4f @ iter %d", score,
                                 runner.step)
