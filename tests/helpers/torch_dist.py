"""Rank processes of the port's multi-process CPU tests.

``run_ranks(task, world, tmp_path, **kw)`` starts ``world`` processes of
this file, each joining a gloo group through ``init_method=file://...`` (a
file under ``tmp_path``, so parallel test workers never share a port) with
``torch.set_num_threads(1)``; rank ``r`` runs ``TASKS[task](**kw)`` and
pickles what it returns. A spawn that does not end within ``timeout``
seconds is killed and fails its test, so a hung collective cannot eat the
suite's time limit. Returns the ranks' results, rank 0 first.

This module imports no JAX: the rank processes run the port alone.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")


def run_ranks(task: str, world: int, tmp_path, timeout: float = 120.0,
              **kw) -> list:
    tmp = str(tmp_path)
    spec = os.path.join(tmp, f"{task}.spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump(kw, f)
    init = os.path.join(tmp, f"{task}.init")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs, logs, outs = [], [], []
    for r in range(world):
        out = os.path.join(tmp, f"{task}.rank{r}.pkl")
        log = open(os.path.join(tmp, f"{task}.rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(r),
             str(world), init, spec, out],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
        outs.append(out)
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{task}: ranks did not end within {timeout} s"
                             + _tails(logs))
    finally:
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        raise AssertionError(
            f"{task}: rank exit codes {[p.returncode for p in procs]}"
            + _tails(logs))
    res = []
    for out in outs:
        with open(out, "rb") as f:
            res.append(pickle.load(f))
    return res


def _tails(logs) -> str:
    parts = []
    for r, log in enumerate(logs):
        with open(log.name) as f:
            parts.append(f"\n--- rank {r} ---\n" + "".join(
                f.readlines()[-40:]))
    return "".join(parts)


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def cdn_noise(j: int, cdn, B: int) -> dict:
    """The j-th det step's CDN noise for a global batch of ``B`` (both
    packages' det steps take it as ``dn_noise_*`` batch entries)."""
    shape = (B, 2 * cdn.num_groups, cdn.single_pad)
    rng = np.random.default_rng(100 + j)
    return dict(
        dn_noise_p=rng.uniform(size=shape).astype(np.float32),
        dn_noise_new_label=rng.integers(0, 20, shape).astype(np.int32),
        dn_noise_sign=(rng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
        dn_noise_part=rng.uniform(size=shape + (4,)).astype(np.float32))


def with_noise(make, cdn, B: int, world: int = 1, rank: int = 0,
               asarray=np.asarray):
    """``make_train_step`` whose det steps get the j-th noise draw of the
    global batch of ``B``, this rank's rows (``rank::world``) of it."""
    calls = []

    def wrapped(model, optimizer, task, cfg, mask=None, **kw):
        step = make(model, optimizer, task, cfg, mask, **kw)
        if task != "det":
            return step

        def det_step(*args):
            args = list(args)
            i = 2 if len(args) == 4 else 0   # JAX: (params, opt, batch, rng)
            noise = {k: v[rank::world] for k, v in
                     cdn_noise(len(calls), cdn, B).items()}
            args[i] = dict(args[i], **{k: asarray(v)
                                       for k, v in noise.items()})
            calls.append(1)
            return step(*args)
        return det_step
    return wrapped


def tiny_cfg(opts: dict):
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict
    cfg = load_cfg(TINY)
    if opts:
        cfg = merge_from_dict(cfg, opts)
    return load_data_cfg(cfg, config_root=ROOT, filename=TINY)


def task_train(opts, work_dir, max_iters, noise_b=None, sigterm_at=None):
    """``train_model`` of the tiny config (``opts`` merged in) on this
    rank: the per-step logs of ``metrics.jsonl`` (rank 0), the gathered
    final state dict and optimizer state, the runner's end."""
    import json

    import torch

    from rscotr_tpu_torch import apis
    from rscotr_tpu_torch.engine import train_step
    from rscotr_tpu_torch.engine.checkpoint import full_state_dict
    from rscotr_tpu_torch.engine.hooks import Hook
    from rscotr_tpu_torch.parallel import mesh
    cfg = tiny_cfg(opts)
    hooks = []
    if sigterm_at is not None:
        class Kill(Hook):
            def after_train_iter(self, runner):
                if runner.step == sigterm_at[1] and \
                        mesh.rank() == sigterm_at[0]:
                    os.kill(os.getpid(), signal.SIGTERM)
        hooks.append(Kill())
    if noise_b:
        cdn = apis.make_step_config(cfg).cdn
        real = train_step.make_train_step
        train_step.make_train_step = with_noise(
            real, cdn, noise_b, mesh.world_size(), mesh.rank())
    try:
        runner = apis.train_model(cfg, work_dir, validate=False,
                                  max_iters_override=max_iters,
                                  device="cpu", hooks=hooks)
    finally:
        if noise_b:
            train_step.make_train_step = real
    state = full_state_dict(runner.model)
    opt = runner.optimizer.state_dict()
    logs = []
    path = os.path.join(work_dir, "metrics.jsonl")
    if mesh.rank() == 0 and os.path.isfile(path):
        with open(path) as f:
            logs = [json.loads(line) for line in f]
    return dict(logs=logs, state=state, opt=opt, step=runner.step,
                opt_step=runner.optimizer.step, preempted=runner.preempted,
                files=sorted(os.listdir(work_dir)),
                sharded=any(type(p).__name__ == "DTensor"
                            for p in runner.model.parameters()),
                threads=torch.get_num_threads())


def task_eval(max_batches=0):
    """``multi_process_test`` of the tiny config's val sets on a seeded
    model."""
    import torch

    from rscotr_tpu_torch.apis import derive_img_norm
    from rscotr_tpu_torch.data.build import build_dataloaders, build_datasets
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.engine.test import multi_process_test
    from rscotr_tpu_torch.models import build_model
    cfg = tiny_cfg({})
    ds = build_datasets(cfg["data"], split="val")
    loaders = build_dataloaders(ds, cfg["data"], train=False)
    model = build_model(cfg["model"], device="cpu",
                        generator=torch.Generator().manual_seed(3))
    model.eval()
    infer = make_infer_steps(model, max_per_img=50,
                             img_norm=derive_img_norm(cfg),
                             seg_test_cfg={"mode": "whole"})
    return multi_process_test(infer, loaders, max_batches=max_batches)


def tp_setup():
    """The tiny model and optimizer of one process, seeded, and the step
    config (batch augments off)."""
    import torch

    from rscotr_tpu_torch import apis
    from rscotr_tpu_torch.models import build_model
    cfg = tiny_cfg({"model.train_cfg.cls.augments": []})
    model = build_model(cfg["model"], device="cpu",
                        generator=torch.Generator().manual_seed(5))
    return cfg, model, apis.make_step_config(cfg)


def tp_batches(cdn):
    rng = np.random.default_rng(0)
    cls = {"img": rng.normal(size=(4, 128, 128, 3)).astype(np.float32),
           "gt_label": rng.integers(0, 45, 4).astype(np.int32)}
    boxes = np.zeros((1, 20, 4), np.float32)
    boxes[0, :3] = [[10, 20, 90, 120], [100, 30, 200, 90],
                    [40, 150, 220, 250]]
    det = {"img": rng.normal(size=(1, 256, 256, 3)).astype(np.float32),
           "img_hw": np.array([[256, 256]], np.int32),
           "gt_bboxes": boxes,
           "gt_labels": np.array([[1, 5, 7] + [0] * 17], np.int32),
           "gt_valid": np.arange(20)[None] < 3,
           **cdn_noise(0, cdn, 1)}
    seg = {"img": rng.normal(size=(2, 128, 128, 3)).astype(np.float32),
           "gt_semantic_seg": rng.integers(0, 5, (2, 128, 128)
                                           ).astype(np.int32),
           "img_hw": np.full((2, 2), 128, np.int32)}
    return {"cls": cls, "det": det, "seg": seg}


def run_tp_steps(tasks, world: int = 1):
    """One step per task of ``tasks`` (the tiny model, seeded; one process
    when ``world`` is 1, else tensor parallelism over ``world`` ranks):
    each step's log vars and the full state after, as a checkpoint holds
    it (rank 0's; the other ranks get an empty dict)."""
    from rscotr_tpu_torch.engine.checkpoint import full_state_dict
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.parallel import tp
    from rscotr_tpu_torch.utils.rng import step_generator
    cfg, model, step_cfg = tp_setup()
    if world > 1:
        tp.parallelize(model, tp.make_mesh_2d(1, world, "cpu"))
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=dict(cfg["lr_config"]),
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    masks = task_param_masks([n for n, _ in model.named_parameters()])
    batches = tp_batches(step_cfg.cdn)
    logs = []
    for i, t in enumerate(tasks):
        step = make_train_step(model, opt, t, step_cfg, masks[t])
        lv = step(batches[t], step_generator(0, i))
        logs.append({k: float(v) for k, v in lv.items()})
    return dict(logs=logs, state=full_state_dict(model))


def task_tp(tasks):
    from rscotr_tpu_torch.parallel import mesh
    return run_tp_steps(tasks, world=mesh.world_size())


def run_cls_dp_step(world: int = 1, rank: int = 0, augments: bool = True):
    """One cls step of the tiny model (seeded) with the batch augments on:
    in one process on the 4-image batch, else on this rank's rows
    ``rank::world`` of it under ``GradSync``. Returns the log vars (this
    rank's shares) and the state after."""
    import torch

    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.parallel.ddp import GradSync
    from rscotr_tpu_torch.utils.rng import step_generator
    cfg = tiny_cfg({} if augments else
                   {"model.train_cfg.cls.augments": []})
    from rscotr_tpu_torch import apis
    from rscotr_tpu_torch.models import build_model
    model = build_model(cfg["model"], device="cpu",
                        generator=torch.Generator().manual_seed(5))
    step_cfg = apis.make_step_config(cfg)
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=dict(cfg["lr_config"]),
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    masks = task_param_masks([n for n, _ in model.named_parameters()])
    kw = {"sync": GradSync()} if world > 1 else {}
    step = make_train_step(model, opt, "cls", step_cfg, masks["cls"], **kw)
    batch = {k: v[rank::world] for k, v in tp_batches(step_cfg.cdn)["cls"]
             .items()}
    lv = step(batch, step_generator(0, 0))
    return dict(logs={k: float(v) for k, v in lv.items()},
                state={k: v.detach().clone()
                       for k, v in model.state_dict().items()})


def task_cls_dp(augments=True):
    from rscotr_tpu_torch.parallel import mesh
    return run_cls_dp_step(mesh.world_size(), mesh.rank(), augments)


TASKS = {"train": task_train, "eval": task_eval, "tp": task_tp,
         "cls_dp": task_cls_dp}


def main(argv) -> int:
    task, rank, world, init, spec, out = argv
    # the metric sink skips TensorBoard (its import pulls in tensorflow)
    sys.modules["torch.utils.tensorboard"] = None
    import torch
    torch.set_num_threads(1)
    from rscotr_tpu_torch.parallel import mesh
    with open(spec, "rb") as f:
        kw = pickle.load(f)
    mesh.initialize_distributed("pytorch", device="cpu",
                                init_method=f"file://{init}",
                                world=int(world), rank_id=int(rank),
                                timeout_s=100)
    try:
        res = TASKS[task](**kw)
    finally:
        mesh.destroy_distributed()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
