"""IterBasedRunner: the co-training loop (counterpart of
rscotr_tpu/engine/runner.py).

It draws annotated batches from a ``MultiDataLoader``, calls the train step
of each batch's ``task`` (``make_train_step``: the step updates the model
and the optimizer in place and returns its loss terms as device scalars),
names the log vars ``{task}.{dataset}.{loss}`` (``grad_norm`` bare) beside
``data_time`` and ``time``, and runs the hooks after each step.

* ``data_time`` is the step's wait for its batch (a group's first step
  carries the group's collection, the others 0); ``time`` runs from the
  end of the previous step call (before its hooks) to the end of this one,
  as in JAX.
* Batches come through a ``PrefetchIterator``. On the card its worker
  copies each batch to a pinned host buffer and from there to the card on
  a side stream (``non_blocking``), records an event that the step's stream
  waits on, and marks each tensor as used by that stream
  (``record_stream``), so the copy overlaps the previous step.
* Step ``s`` draws from ``utils.rng.step_generator(rng_seed, s)``, which
  depends on ``(rng_seed, s)`` alone, as JAX's ``fold_in(root, s)``.
* The runner reads no device value: ``LogHook`` turns the log vars into
  floats at its interval.
* SIGTERM stops the loop at the next step boundary and ``CheckpointHook``
  writes the step's checkpoint. Under ``torch.distributed`` the signal may
  reach some ranks only, so each boundary takes the max of the ranks'
  flags (``_should_stop``, on the ``"main"`` gloo group of
  ``parallel.multihost``, as JAX's runner all-gathers them) and every rank
  enters the collective save together.
* Each rank moves its batches to its own device (the model's); the
  profiler runs on rank 0.
* ``profile_cfg`` (``start``, ``end``, ``logdir``) traces steps [start,
  end) with ``torch.profiler`` and writes a Chrome trace to ``logdir``.

``steps_per_dispatch`` K > 1 keeps JAX's ORDER without JAX's dispatch. JAX
runs K same-shape steps of one task in one ``lax.scan`` and, to fill the
scan, regroups the strategy's draw stream (``_next_group``): up to K draws
of one (task, dataset, shapes) group, looked ahead through a FIFO buffer of
at most 4K draws, snapped down to a power of two, and no group crossing the
interval of a hook that reads the parameters (``_hook_boundary``). That
order decides which batch each optimizer step sees, so the port keeps it,
and then runs each batch of a group as an ordinary step call with its own
step generator, the hooks after each. There is no scan, no stacking and no
deferred flush. K = 1 is the same loop with groups of one batch: the
strategy's order. Where the data stream ends (an exhaust-all strategy), the
loaders are re-seeded with the step that JAX's hooks show at that moment
(its deferred flush lags them by a group), so the next epoch's shuffle is
JAX's too.
"""

from __future__ import annotations

import collections
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rscotr_tpu_torch.data.loader import PrefetchIterator
from rscotr_tpu_torch.engine.hooks import Hook
from rscotr_tpu_torch.parallel import multihost
from rscotr_tpu_torch.utils.logging import get_root_logger
from rscotr_tpu_torch.utils.rng import step_generator

_READY = "_ready"   # the copy's event, in a batch moved to the card


class IterBasedRunner:
    def __init__(self, train_steps: Dict[str, Callable], model=None,
                 optimizer=None, max_iters: int = 0, rng_seed: int = 0,
                 start_step: int = 0, prefetch: int = 2,
                 profile_cfg: Optional[dict] = None,
                 steps_per_dispatch: int = 1,
                 handle_preemption: bool = True):
        self.train_steps = train_steps
        self.model = model
        self.optimizer = optimizer
        self.max_iters = max_iters
        self.rng_seed = rng_seed
        self.step = start_step
        self.log_vars: Dict[str, object] = {}
        self.loss_keys: List[str] = []
        self._hooks: List[Hook] = []
        self.logger = get_root_logger()
        self.prefetch = prefetch
        self.profile_cfg = dict(profile_cfg or {})
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.handle_preemption = handle_preemption
        self.preempted = False
        params = list(model.parameters()) if model is not None else []
        self.device = params[0].device if params else torch.device("cpu")
        self._copy_stream = None
        self._consumer = None
        self._profiler = None

    def register_hook(self, hook: Hook) -> None:
        self._hooks.append(hook)
        self._hooks.sort(key=lambda h: h.priority)

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------

    def _transfer_batch(self, batch):
        """Runs in the prefetch thread: every array of the batch to the
        card (pinned host copy, then an async copy on the side stream), and
        an event the step waits on. On the CPU the batch stays as it is."""
        if self.device.type != "cuda":
            return batch
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in batch.items():
                if not isinstance(v, np.ndarray):
                    out[k] = v
                    continue
                t = torch.from_numpy(v)
                if t.numel():
                    t = t.pin_memory().to(self.device, non_blocking=True)
                else:   # the zero-width dn_wide marker: its shape only
                    t = torch.empty(t.shape, dtype=t.dtype,
                                    device=self.device)
                t.record_stream(self._consumer)
                out[k] = t
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        out[_READY] = ready
        return out

    def _make_iter(self, multi_loader):
        it = iter(multi_loader)
        if self.prefetch and self.prefetch > 0:
            # a group takes up to K draws at once: hold ~2 groups so the
            # worker prepares the next while the steps run
            depth = self.prefetch if self.steps_per_dispatch <= 1 else \
                max(self.prefetch, 2 * self.steps_per_dispatch)
            it = PrefetchIterator(it, depth=depth,
                                  transfer_fn=self._transfer_batch)
        return it

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------

    def _train_one(self, batch, t_last: float, data_time: float) -> float:
        """Run the step of one batch and the hooks; returns the time the
        step ended (before the hooks)."""
        task = batch.pop("task")
        dataset_name = batch.pop("dataset_name")
        ready = batch.pop(_READY, None)
        self._maybe_profile()
        if ready is not None:
            self._consumer.wait_event(ready)
        log_vars = self.train_steps[task](
            batch, step_generator(self.rng_seed, self.step))
        self.step += 1
        self.log_vars = {(f"{task}.{dataset_name}.{k}"
                          if k != "grad_norm" else k): v
                         for k, v in log_vars.items()}
        # per-rank shares of the loss under data parallelism (LogHook sums
        # them over the ranks)
        self.loss_keys = [k for k in self.log_vars if k != "grad_norm"]
        t_now = time.perf_counter()
        self.log_vars["data_time"] = data_time
        self.log_vars["time"] = t_now - t_last
        for h in self._hooks:
            h.after_train_iter(self)
        return t_now

    def _maybe_profile(self):
        pc = self.profile_cfg
        if not pc or multihost.process_index() != 0:
            return
        if self.step == pc.get("start", -1):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            self.logger.info("profiler: start at iter %d", self.step)
        if self.step == pc.get("end", -1) and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        logdir = self.profile_cfg.get("logdir", "profile")
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"trace_iter{self.step}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self.logger.info("profiler: stop at iter %d -> %s", self.step, path)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def _install_sigterm(self):
        """SIGTERM -> finish the current step, checkpoint, stop. Returns
        the call that restores the previous handler (a no-op where no
        handler can be installed: off the main thread, or disabled)."""
        if not self.handle_preemption or \
                threading.current_thread() is not threading.main_thread():
            return lambda: None

        def on_sigterm(signum, frame):
            self.preempted = True
            self.logger.warning(
                "SIGTERM received: stopping at the next step boundary and "
                "writing a checkpoint (resume with --auto-resume)")

        prev = signal.signal(signal.SIGTERM, on_sigterm)
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _should_stop(self) -> bool:
        """The preemption check at a step boundary, agreed by every rank:
        the max of their flags (a collective; one process reads its own)."""
        if not self.handle_preemption or multihost.process_count() == 1:
            return self.preempted
        if multihost.all_reduce_max([self.preempted])[0]:
            self.preempted = True
        return self.preempted

    def run(self, multi_loader) -> None:
        self.logger.info("start training: iter %d -> %d", self.step,
                         self.max_iters)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._consumer = torch.cuda.current_stream(self.device)
        for h in self._hooks:
            h.before_run(self)
        restore = self._install_sigterm()
        try:
            self._run_groups(multi_loader)
        finally:
            restore()
            if self._profiler is not None:
                self._stop_profile()
        for h in self._hooks:
            h.after_run(self)
        self.logger.info("training %s at iter %d",
                         "preempted" if self.preempted else "finished",
                         self.step)

    # ------------------------------------------------------------------
    # the order: groups of up to K same-shape batches (K = 1: one batch
    # each, the strategy's order)
    # ------------------------------------------------------------------

    def _interval_hooks(self):
        for h in self._hooks:
            iv = getattr(h, "interval", None)
            if getattr(h, "scan_boundary", True) and isinstance(iv, int) \
                    and iv > 0:
                yield iv

    def _hook_boundary(self, at_step: Optional[int] = None) -> int:
        """The most steps a group may take from ``at_step`` (default the
        current step) without crossing the end of the run or the interval
        of a hook that reads the parameters."""
        s = self.step if at_step is None else at_step
        room = self.max_iters - s
        for iv in self._interval_hooks():
            room = min(room, iv - s % iv)
        return max(room, 1)

    def _param_hook_fires_at(self, s: int) -> bool:
        """True when the run ends at step ``s`` or a parameter-reading
        hook fires there: where JAX's deferred flush drains."""
        return s >= self.max_iters or any(
            s % iv == 0 for iv in self._interval_hooks())

    def _draw(self, state, multi_loader):
        """One annotated batch; at the end of the data stream the loaders
        are re-seeded with the step JAX's hooks see at that moment."""
        try:
            return next(state["it"])
        except StopIteration:
            multi_loader.seed_sampler(state["visible"])
            state["it"] = self._make_iter(multi_loader)
            return next(state["it"])

    @staticmethod
    def _group_key(b):
        # shapes belong to the key: a bucket list gives det batches of
        # other sizes, the DN ladder other dn_wide widths
        return (b["task"], b["dataset_name"],
                tuple(getattr(b.get("img"), "shape", ()) or ()),
                tuple(getattr(b.get("out_template"), "shape", ()) or ()),
                tuple(getattr(b.get("dn_wide"), "shape", ()) or ()))

    def _next_group(self, state, multi_loader, k: int):
        """Up to ``k`` batches of ONE group, in JAX's order: the buffer's
        head decides the group, its members come from the buffer first
        (FIFO), then from new draws while the buffer holds fewer than
        ``4 * k``; the group is cut to a power of two and the rest goes
        back to the buffer's front."""
        buf = state["buf"]
        if not buf:
            buf.append(self._draw(state, multi_loader))
        key = self._group_key(buf[0])
        group = [buf.popleft()]
        i = 0
        while len(group) < k and i < len(buf):
            if self._group_key(buf[i]) == key:
                group.append(buf[i])
                del buf[i]
            else:
                i += 1
        while len(group) < k and len(buf) < 4 * k:
            b = self._draw(state, multi_loader)
            if self._group_key(b) == key:
                group.append(b)
            else:
                buf.append(b)
        keep = 1 << (len(group).bit_length() - 1)
        for b in reversed(group[keep:]):
            buf.appendleft(b)
        return group[:keep]

    def _run_groups(self, multi_loader) -> None:
        K = self.steps_per_dispatch
        # "visible": the step JAX's hooks see while it draws the next group;
        # its per-step loop (K = 1) shows the current step, its deferred
        # flush (K > 1) lags a group unless a parameter-reading hook drained
        # the last one
        state = {"it": self._make_iter(multi_loader),
                 "buf": collections.deque(), "visible": self.step}
        t_last = time.perf_counter()
        try:
            while self.step < self.max_iters and not self._should_stop():
                start = self.step
                t0 = time.perf_counter()
                group = self._next_group(state, multi_loader,
                                         min(K, self._hook_boundary()))
                data_time = time.perf_counter() - t0
                for batch in group:
                    if self._should_stop():
                        break
                    t_last = self._train_one(batch, t_last, data_time)
                    data_time = 0.0
                state["visible"] = self.step if K == 1 or \
                    self._param_hook_fires_at(self.step) else start
        finally:
            if isinstance(state["it"], PrefetchIterator):
                state["it"].close()
