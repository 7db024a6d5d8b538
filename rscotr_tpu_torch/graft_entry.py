"""Driver entry points of the port (counterpart of the root
``__graft_entry__.py``).

``entry()`` returns the flagship MTL's det forward (backbone -> neck ->
shared encoder -> two-stage DINO decoder, the deepest graph) as a function
of its weights, with example arguments.

``dryrun_multichip(n)`` runs the root's dry run over ``n`` ranks of
``torch.distributed``, one process each, leg by leg: one data-parallel
train step per task of the tiny config, two cls steps in the runner's
grouped order, the three device-augment steps on real planner / collate
batches, the strided eval over the val sets, an FSDP2 det step with a
checkpoint round trip of the gathered state, and (n even, >= 4) a cls step
over a 2-D (n/2 data x 2 model) mesh with tensor parallelism and the
trajectory leg: two ranks through the runner, the eval hook with
save-best and a collective checkpoint, held to one process on the same
global batch. JAX's K-step ``lax.scan`` has no counterpart in the port
(ROADMAP "Not queued"): its leg is the runner's grouped order of K = 2.

The ranks are processes of this module (``--rank``). On the CPU they join
a gloo group through a ``file://`` store in a temporary directory; on the
card over NCCL when there is a card per rank, else they share the cards
over gloo (``parallel.mesh.local_device``: ``LOCAL_RANK % count``). A rank
that fails, or a run that passes ``timeout``, raises ``RuntimeError`` with
the tail of the failing rank's log, and every rank is killed: a hung
collective never hangs the caller.

    python -m rscotr_tpu_torch.graft_entry [n] [--device cpu]   # n = 8

Both run on the card unless the caller passes ``device="cpu"``; a CUDA
``device`` without a card raises.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rscotr_tpu_torch.engine.hooks import Hook
from rscotr_tpu_torch.models.layers.common import Linear

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CFG = os.path.join(
    ROOT, "configs/multi/MTL_slvlcls_swin-t-p4-w7_1x1_resisc_dior_potsdam.py")
TINY_CFG = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
DEVAUG_CFG = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic_devaug.py")
# the dry run's whole time, spawned ranks included
DRYRUN_TIMEOUT = 900.0
# GT rows of the dry run's det batch, 3 of them valid (the root's)
DET_GT = 20
# the trajectory leg: steps, global batch, its ranks
TRAJ_STEPS, TRAJ_BATCH, TRAJ_RANKS = 4, 8, 2


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} asked for, but there is no "
                           "CUDA device; pass device=\"cpu\" to run on the "
                           "CPU")
    return dev


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------

def entry(device="cuda", config: Optional[str] = None, det_hw=(256, 256),
          seed: int = 0):
    """-> ``(fn, example_args)``: the flagship MTL's det forward in eval
    mode under ``torch.no_grad()``, ``fn(params, img, hw)``, with
    ``params`` the model's state dict (``torch.func.functional_call``, as
    ``export.py`` swaps weights), ``img`` (1, *det_hw, 3) zeros and ``hw``
    [[*det_hw]] int32 on ``device``. ``config`` (default the paper MTL,
    ``MTL_slvlcls_swin-t-p4-w7_1x1_resisc_dior_potsdam.py``) is read by
    ``config.Config.fromfile`` and ``data.build.load_data_cfg``; the
    weights come from a generator seeded ``seed``. JAX's weights carry
    across with ``utils.convert.state_dict_from_jax`` as ``params``."""
    from rscotr_tpu_torch.apis import derive_cls_hw
    from rscotr_tpu_torch.config import Config
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.export import _Step
    from rscotr_tpu_torch.models import build_model
    dev = _device(device)
    path = config or FLAGSHIP_CFG
    cfg = load_data_cfg(Config.fromfile(path).to_dict(), config_root=ROOT,
                        filename=path)
    model = build_model(cfg["model"], device=dev,
                        generator=torch.Generator().manual_seed(seed),
                        cls_hw=derive_cls_hw(cfg)).eval()
    step = _Step(model, model.forward_det)

    def fn(params, img, hw):
        with torch.no_grad():
            return torch.func.functional_call(
                step, {f"model.{k}": v for k, v in params.items()},
                (img, hw))

    img = torch.zeros((1, *det_hw, 3), dtype=torch.float32, device=dev)
    hw = torch.tensor([list(det_hw)], dtype=torch.int32, device=dev)
    return fn, (dict(model.state_dict()), img, hw)


# ---------------------------------------------------------------------------
# the dry run's batches (numpy, the root's shapes)
# ---------------------------------------------------------------------------

def dryrun_batches(n: int, cdn, num_det_classes: int = 20) -> dict:
    """The root's global batches of ``n`` samples (numpy ``default_rng(0)``
    draws: cls 128^2, det 256^2 with ``DET_GT`` GT rows of which 3 are
    valid, seg 128^2), and the det step's CDN noise for the ``cdn``
    config (``default_rng(100)``), which both packages' det steps take as
    ``dn_noise_*`` entries."""
    rng = np.random.default_rng(0)
    G = DET_GT
    batches = {
        "cls": {"img": rng.normal(size=(n, 128, 128, 3)).astype(np.float32),
                "gt_label": rng.integers(0, 45, n).astype(np.int32)},
        "det": {"img": rng.normal(size=(n, 256, 256, 3)).astype(np.float32),
                "img_hw": np.full((n, 2), 256, np.int32),
                "gt_bboxes": np.tile(np.array([[10, 10, 60, 60]],
                                              np.float32), (n, G, 1)),
                "gt_labels": np.zeros((n, G), np.int32),
                "gt_valid": np.tile((np.arange(G) < 3)[None], (n, 1))},
        "seg": {"img": rng.normal(size=(n, 128, 128, 3)).astype(np.float32),
                "gt_semantic_seg": rng.integers(
                    0, 5, (n, 128, 128)).astype(np.int32)},
    }
    shape = (n, 2 * cdn.num_groups, cdn.single_pad)
    nrng = np.random.default_rng(100)
    batches["det"].update(
        dn_noise_p=nrng.uniform(size=shape).astype(np.float32),
        dn_noise_new_label=nrng.integers(0, num_det_classes, shape
                                         ).astype(np.int32),
        dn_noise_sign=(nrng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
        dn_noise_part=nrng.uniform(size=shape + (4,)).astype(np.float32))
    return batches


def _rows(batch: dict, rank: int, world: int) -> dict:
    return {k: v[rank::world] for k, v in batch.items()}


def _tiny_cfg(path: str) -> dict:
    """A tiny config composed, one sample per rank for every task (train)
    and per eval batch."""
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.utils.config import load_cfg
    cfg = load_data_cfg(load_cfg(path), config_root=ROOT, filename=path)
    for entry_ in cfg["data"].values():
        entry_["data"]["samples_per_gpu"] = 1
        entry_["data"]["test_samples_per_gpu"] = 1
    return cfg


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def _summed(log_vars: dict, group=None) -> dict:
    """The ranks' shares of the loss terms summed (the global batch's
    values), as floats."""
    from rscotr_tpu_torch.parallel.ddp import sum_log_vars
    out = sum_log_vars(log_vars, [k for k in log_vars if k != "grad_norm"],
                       group)
    return {k: float(v) for k, v in out.items()}


class _Tap(Hook):
    """A runner hook that keeps each step's loss term ``key``, summed over
    the ranks."""
    priority = 90

    def __init__(self, key: str):
        self.key, self.values = key, []

    def after_train_iter(self, runner):
        self.values.append(_summed(
            {self.key: runner.log_vars[self.key]})[self.key])


def _legs(rank: int, world: int, device: str, weights: Optional[str],
          work_dir: str) -> dict:
    """Legs 1-6 of the dry run on this rank; rank 0 returns the printed
    lines and each leg's losses."""
    from torch.distributed.tensor import DTensor

    from rscotr_tpu_torch.apis import make_eval_fn, make_step_config
    from rscotr_tpu_torch.data.build import (build_dataloaders,
                                             build_datasets)
    from rscotr_tpu_torch.engine.checkpoint import (full_state_dict,
                                                    load_checkpoint,
                                                    save_checkpoint)
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.runner import IterBasedRunner
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.parallel import fsdp, mesh, tp
    from rscotr_tpu_torch.parallel.ddp import GradSync
    from rscotr_tpu_torch.utils.rng import step_generator

    dev = mesh.local_device(device)
    cfg = _tiny_cfg(TINY_CFG)
    tag = f"dryrun_multichip[{world}]"
    lines, losses = [], {}

    def new_model():
        m = build_model(cfg["model"], device=dev,
                        generator=torch.Generator().manual_seed(0))
        if weights:
            load_checkpoint(weights, model=m)
        return m

    def new_optimizer(m):
        return build_optimizer(
            cfg["optimizer"], m.named_parameters(),
            lr_config=dict(cfg["lr_config"]),
            grad_clip=(cfg.get("optimizer_config") or {}).get("grad_clip"))

    model = new_model()
    mesh.broadcast_module(model)
    optimizer = new_optimizer(model)
    masks = task_param_masks([n for n, _ in model.named_parameters()])
    step_cfg = make_step_config(cfg)
    batches = dryrun_batches(world, step_cfg.cdn,
                             cfg["model"]["bbox_head"]["num_classes"])
    sync = GradSync() if world > 1 else None
    kw = {"sync": sync} if sync is not None else {}

    # 1. one data-parallel step per task on the root's global batches; the
    #    cls batch augments off, since under data parallelism they pair
    #    images within a rank (ROADMAP C15)
    dp_cfg = dataclasses.replace(step_cfg, cls_use_augments=False)
    for i, task in enumerate(("cls", "det", "seg")):
        step = make_train_step(model, optimizer, task, dp_cfg, masks[task],
                               **kw)
        lv = _summed(step(_rows(batches[task], rank, world),
                          step_generator(0, i)))
        losses[task] = lv["loss"]
        lines.append(f"{tag} {task}: loss={lv['loss']:.4f}")

    # 2. the root's K-step scan: two cls steps on the same batch in the
    #    runner's grouped order (steps_per_dispatch 2), the augments on
    cls_step = make_train_step(model, optimizer, "cls", step_cfg,
                               masks["cls"], **kw)

    def same_batch():
        while True:
            yield dict(_rows(batches["cls"], rank, world), task="cls",
                       dataset_name="resisc")

    runner = IterBasedRunner({"cls": cls_step}, model, optimizer, 2,
                             rng_seed=3, prefetch=0, steps_per_dispatch=2)
    tap = _Tap("cls.resisc.loss")
    runner.register_hook(tap)
    runner.run(same_batch())
    losses["cls group K=2"] = tap.values
    lines.append(f"{tag} cls group K=2: loss={tap.values[-1]:.4f}")

    # 3. the three device-augment steps on planner / aug-collate batches
    cfg_da = _tiny_cfg(DEVAUG_CFG)
    step_cfg_da = make_step_config(cfg_da)
    if None in (step_cfg_da.device_aug, step_cfg_da.det_device_aug,
                step_cfg_da.seg_device_aug):
        raise RuntimeError(f"{DEVAUG_CFG}: a task without its device stage")
    loaders = build_dataloaders(build_datasets(cfg_da["data"], "train"),
                                cfg_da["data"], train=True, num_threads=1,
                                world_size=world)
    for name, dl in loaders.items():
        task = dl.dataset.task
        step = make_train_step(model, optimizer, task, step_cfg_da,
                               masks[task], **kw)
        lv = _summed(step(next(iter(dl)), step_generator(5, 0)))
        losses[f"{task} devaug"] = lv["loss"]
        lines.append(f"{tag} {task} devaug: loss={lv['loss']:.4f}")

    # 4. the strided eval over the val sets (the first n images of each),
    #    gathered on every rank
    metrics = make_eval_fn(cfg, model, max_per_img=50, max_batches=world)()
    if not any(k.endswith("accuracy_top-1") for k in metrics):
        raise RuntimeError(f"eval: no accuracy_top-1 in {sorted(metrics)}")
    losses["eval"] = metrics
    lines.append(f"{tag} eval: {len(metrics)} metric keys over strided "
                 "batches")

    # 5. FSDP2: the model's state sharded over the ranks, one det step,
    #    then the gathered state through save / load
    fmodel = new_model()
    fmodel.load_state_dict(model.state_dict())
    lines.append(fsdp.describe_fsdp(fmodel, world,
                                    fsdp.DEFAULT_MIN_LEAF_SIZE))
    fsdp.shard_model(fmodel, min_leaf_size=fsdp.DEFAULT_MIN_LEAF_SIZE)
    fopt = new_optimizer(fmodel)
    fkw = {"sync": GradSync(skip=fsdp.fsdp_managed(fmodel))} \
        if world > 1 else {}
    step = make_train_step(fmodel, fopt, "det", dp_cfg, masks["det"], **fkw)
    lv = _summed(step(_rows(batches["det"], rank, world),
                      step_generator(0, 4)))
    if not np.isfinite(lv["loss"]):
        raise RuntimeError(f"fsdp det loss {lv['loss']}")
    big = max(fmodel.parameters(), key=lambda p: p.numel())
    if world > 1 and not (isinstance(big, DTensor) and any(
            pl.is_shard() for pl in big.placements)):
        raise RuntimeError("FSDP sharding lost after the update")
    losses["fsdp det"] = lv["loss"]
    lines.append(f"dryrun_multichip[{world} fsdp] det: "
                 f"loss={lv['loss']:.4f}")
    path = save_checkpoint(os.path.join(work_dir, "fsdp"), 1, fmodel, fopt,
                           meta={"iter": 1})
    want = full_state_dict(fmodel)
    if rank == 0:
        got = load_checkpoint(path)["state_dict"]
        bad = sorted(k for k in want
                     if k not in got or not torch.equal(got[k], want[k]))
        if bad or len(got) != len(want):
            raise RuntimeError(f"fsdp checkpoint round trip: {bad[:5]}")
        lines.append(f"dryrun_multichip[{world} fsdp] checkpoint "
                     f"gather/save/restore: {len(got)} tensors bit-exact")
    del fmodel, fopt

    # 6. a 2-D (n/2 data x 2 model) mesh: data parallelism over 'data',
    #    tensor parallelism over 'model'
    if world % 2 == 0 and world >= 4:
        mesh2 = tp.make_mesh_2d(world // 2, 2, dev.type)
        lines.append(tp.describe_tp(model, 2, world // 2))
        tmodel = new_model()
        tmodel.load_state_dict(model.state_dict())
        tp.parallelize(tmodel, mesh2)
        data = mesh2["data"]
        step = make_train_step(tmodel, new_optimizer(tmodel), "cls", dp_cfg,
                               masks["cls"],
                               sync=GradSync(group=data.get_group()))
        rows = _rows({k: v[:world // 2] for k, v in batches["cls"].items()},
                     data.get_local_rank(), world // 2)
        lv = _summed(step(rows, step_generator(0, 7)), data.get_group())
        if not np.isfinite(lv["loss"]):
            raise RuntimeError(f"dp*tp cls loss {lv['loss']}")
        losses["tp cls"] = lv["loss"]
        lines.append(f"dryrun_multichip[{world // 2}x2 dp*tp] cls: "
                     f"loss={lv['loss']:.4f}")
    return dict(device=str(dev), lines=lines, losses=losses)


class MiniCls(nn.Module):
    """The trajectory leg's model (tests/helpers/dist_trajectory.py's):
    ``head(relu(proj(mean over H, W)))``, flax-default initialisation."""

    def __init__(self, num_classes: int = 7, hidden: int = 64, device=None):
        super().__init__()
        self.proj = Linear(3, hidden, device=device)
        self.head = Linear(hidden, num_classes, device=device)

    def forward_cls(self, img, generator=None):
        return self.head(F.relu(self.proj(img.mean(dim=(1, 2)))))


class _TrajectoryDs:
    task = "cls"
    CLASSES = tuple(f"c{i}" for i in range(7))

    def __init__(self, length: int = 32):
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.Generator(np.random.PCG64(idx))
        return {"img": rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
                "gt_label": np.int32(idx % 7)}

    def evaluate(self, results, **kw):
        labels = np.asarray([i % 7 for i in range(len(results))])
        pred = np.asarray([np.argmax(r) for r in results])
        return {"accuracy": float((pred == labels).mean() * 100.0)}


def _collate(samples):
    return {"img": np.stack([s["img"] for s in samples]),
            "gt_label": np.asarray([s["gt_label"] for s in samples],
                                   np.int32)}


class _ValLoader:
    """The trajectory's val set in order, 4 at a time (every rank sees
    every batch; ``multi_process_test`` strides them)."""
    batch_size = 4

    def __init__(self):
        self.dataset = _TrajectoryDs(16)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        for s in range(0, len(self.dataset), self.batch_size):
            yield _collate([self.dataset[i] for i in
                            range(s, s + self.batch_size)])


def trajectory(rank: int, world: int, device: str, work_dir: str,
               init: Optional[dict] = None, steps: int = TRAJ_STEPS,
               global_batch: int = TRAJ_BATCH) -> dict:
    """The trajectory leg on this rank of ``world`` (one process when
    ``world`` is 1): ``MiniCls`` (seeded, or ``init``'s state dict) trained
    ``steps`` steps of ``global_batch`` through the runner, the rank-strided
    ``TaskDataLoader`` (shuffle seed 7), an eval every 2 steps through
    ``MultiDatasetsEvalHook`` with save-best, then a collective checkpoint.
    Returns the summed losses, the final weights (rank 0), the eval metrics
    and the best checkpoint's path."""
    from rscotr_tpu_torch.data.iteration_strategies import strategies_map
    from rscotr_tpu_torch.data.loader import MultiDataLoader, TaskDataLoader
    from rscotr_tpu_torch.engine.checkpoint import (full_state_dict,
                                                    save_checkpoint)
    from rscotr_tpu_torch.engine.hooks import MultiDatasetsEvalHook
    from rscotr_tpu_torch.engine.optimizer import build_optimizer
    from rscotr_tpu_torch.engine.runner import IterBasedRunner
    from rscotr_tpu_torch.engine.test import (evaluate_results,
                                              multi_process_test)
    from rscotr_tpu_torch.engine.train_step import (TrainStepConfig,
                                                    make_train_step)
    from rscotr_tpu_torch.models.layers.common import init_weights
    from rscotr_tpu_torch.parallel import mesh
    from rscotr_tpu_torch.parallel.ddp import GradSync

    dev = mesh.local_device(device)
    model = MiniCls(device=dev)
    init_weights(model, torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict({k: torch.as_tensor(np.array(v))
                               for k, v in init.items()}, strict=True)
    mesh.broadcast_module(model)
    dl = TaskDataLoader(_TrajectoryDs(), global_batch // world,
                        collate_fn=_collate, num_threads=1, shuffle=True,
                        seed=7, num_replicas=world, rank=rank)
    loaders = {"resisc": dl}
    multi = MultiDataLoader(loaders, strategies_map["round_robin"](loaders))
    opt = build_optimizer(dict(type="AdamW", lr=1e-2, weight_decay=1e-4),
                          model.named_parameters(),
                          lr_config=dict(policy="fixed"))
    step = make_train_step(
        model, opt, "cls",
        TrainStepConfig(task_weight={"cls": 1.0}, cls_num_classes=7,
                        cls_use_augments=False),
        **({"sync": GradSync()} if world > 1 else {}))

    @torch.no_grad()
    def infer(img):
        return F.softmax(model.forward_cls(torch.as_tensor(img).to(dev)), -1)

    evals = []

    def eval_fn(runner):
        res = multi_process_test({"cls": infer}, {"resisc_val": _ValLoader()})
        m = evaluate_results({"resisc_val": _ValLoader().dataset}, res,
                             {"cls": {}, "det": {}, "seg": {}})
        evals.append(m)
        return m

    runner = IterBasedRunner({"cls": step}, model, opt, steps, prefetch=0)
    tap = _Tap("cls.resisc.loss")
    runner.register_hook(tap)
    runner.register_hook(MultiDatasetsEvalHook(
        eval_fn, interval=2, save_best={"resisc_val.accuracy": 1.0},
        work_dir=work_dir))
    runner.run(multi)
    final = full_state_dict(model)
    save_checkpoint(work_dir, runner.step, model, opt)
    best = os.path.join(work_dir, "best_checkpoint.pth")
    return dict(device=str(dev), losses=tap.values,
                params={k: v.numpy() for k, v in final.items()},
                eval_metrics=evals,
                best_ckpt=best if os.path.isfile(best) else None)


def _check_trajectory(single: dict, double: dict) -> None:
    """The root's protocol: losses and the final ``proj`` / ``head``
    weights at rtol 1e-4 / atol 1e-6, eval metrics at rtol 1e-6, a best
    checkpoint written."""
    np.testing.assert_allclose(double["losses"], single["losses"],
                               rtol=1e-4, atol=1e-6)
    if sorted(single["params"]) != sorted(double["params"]):
        raise RuntimeError("trajectory: the runs hold other weights")
    for k, v in single["params"].items():
        np.testing.assert_allclose(double["params"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if not len(double["eval_metrics"]) == len(single["eval_metrics"]) == 2:
        raise RuntimeError("trajectory: not two evals in each run")
    for ms, mr in zip(single["eval_metrics"], double["eval_metrics"]):
        if ms.keys() != mr.keys():
            raise RuntimeError(f"trajectory: metrics {ms} vs {mr}")
        for k in ms:
            np.testing.assert_allclose(mr[k], ms[k], rtol=1e-6)
    if double["best_ckpt"] is None:
        raise RuntimeError("trajectory: no best checkpoint written")


_MODES = {"legs": _legs, "trajectory": trajectory}


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _spawn(mode: str, ranks, td: str, spec: dict, deadline: float):
    """Start one process of this module per (rank, world) of ``ranks``
    (those of one world share a ``file://`` store under ``td``), wait for
    all, and return their results in order. A rank that exits non-zero, or
    the passing of ``deadline``, kills the rest and raises with the
    failing rank's log tail."""
    procs = []
    for i, (rank, world) in enumerate(ranks):
        stem = os.path.join(td, f"{mode}.{world}.{rank}")
        spec_path = stem + ".spec.pkl"
        with open(spec_path, "wb") as f:
            pickle.dump(dict(spec, init=os.path.join(td, f"{mode}.{world}"
                                                     ".store"),
                             work_dir=os.path.join(td, f"{mode}.{world}.wd")),
                        f)
        env = dict(os.environ, LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONUNBUFFERED="1",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        log = open(stem + ".log", "w")
        procs.append((f"{mode} rank {rank}/{world}", subprocess.Popen(
            [sys.executable, "-m", "rscotr_tpu_torch.graft_entry", "--rank",
             mode, str(rank), str(world), spec_path, stem + ".out.pkl"],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log,
            stem))
    try:
        while any(p.poll() is None for _, p, _, _ in procs):
            for name, p, log, _ in procs:
                if p.poll() not in (None, 0):
                    raise RuntimeError(f"dryrun_multichip: {name} exited "
                                       f"with {p.returncode}"
                                       + _tail(log.name))
            if time.monotonic() > deadline:
                stuck = [(n, log) for n, p, log, _ in procs
                         if p.poll() is None]
                raise RuntimeError(
                    "dryrun_multichip: timed out with "
                    f"{[n for n, _ in stuck]} running"
                    + _tail(stuck[0][1].name))
            time.sleep(0.2)
        for name, p, log, _ in procs:
            if p.returncode:
                raise RuntimeError(f"dryrun_multichip: {name} exited with "
                                   f"{p.returncode}" + _tail(log.name))
    finally:
        for _, p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    out = []
    for _, _, _, stem in procs:
        with open(stem + ".out.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _tail(path: str, lines: int = 40) -> str:
    with open(path, errors="replace") as f:
        return f"\n--- {os.path.basename(path)} ---\n" + "".join(
            f.readlines()[-lines:])


def _weights_file(weights, td: str) -> Optional[str]:
    """``weights`` as a checkpoint path the ranks load: a state-dict file
    as given, a dict of arrays saved under ``td``."""
    if weights is None or isinstance(weights, (str, os.PathLike)):
        return None if weights is None else os.fspath(weights)
    path = os.path.join(td, "weights.pth")
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in
                weights.items()}, path)
    return path


def dryrun_multichip(n_devices: int, device="cuda", weights=None,
                     timeout: float = DRYRUN_TIMEOUT) -> dict:
    """Run the dry run's legs over ``n_devices`` ranks (module docstring)
    and print the root's lines. ``weights``: a state-dict file or a dict of
    arrays that replaces the tiny model's seed-0 init. Returns each leg's
    losses (rank 0's, the ranks' shares summed), the ranks' devices, the
    backend and, for n even and >= 4, the trajectory leg's two runs."""
    n = int(n_devices)
    dev = _device(device)
    backend = "nccl" if dev.type == "cuda" and \
        torch.cuda.device_count() >= n else "gloo"
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="dryrun_") as td:
        spec = dict(device=dev.type, backend=backend,
                    weights=_weights_file(weights, td),
                    timeout_s=float(timeout))
        ranks = _spawn("legs", [(r, n) for r in range(n)], td, spec,
                       deadline)
        print(f"dryrun_multichip[{n}]: {n} rank(s) over {backend}, devices "
              + ", ".join(f"rank {r} {res['device']}"
                          for r, res in enumerate(ranks)), flush=True)
        for line in ranks[0]["lines"]:
            print(line, flush=True)
        out = dict(ranks[0]["losses"], backend=backend,
                   devices=[r["device"] for r in ranks])
        if n % 2 == 0 and n >= 4:
            runs = _spawn("trajectory", [(r, TRAJ_RANKS)
                                         for r in range(TRAJ_RANKS)]
                          + [(0, 1)], td, dict(spec, weights=None),
                          deadline)
            double, single = runs[0], runs[-1]
            _check_trajectory(single, double)
            out["trajectory"] = dict(single=single, double=double)
            print(f"dryrun_multichip[{TRAJ_RANKS} ranks] train + eval + "
                  f"save_best + checkpoint: trajectory == 1 process "
                  f"({len(single['losses'])} steps, "
                  f"{len(single['eval_metrics'])} evals)", flush=True)
    print(f"dryrun_multichip({n}) OK", flush=True)
    return out


def _rank_main(argv) -> int:
    """``--rank MODE RANK WORLD SPEC OUT``: one rank of the dry run."""
    mode, rank, world, spec_path, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from rscotr_tpu_torch.parallel import mesh
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    os.makedirs(spec["work_dir"], exist_ok=True)
    group = mode == "legs" or world > 1
    if group:
        mesh.initialize_distributed(
            "pytorch", spec["backend"], spec["device"],
            init_method=f"file://{spec['init']}", world=world, rank_id=rank,
            timeout_s=spec["timeout_s"])
    try:
        kw = dict(device=spec["device"], work_dir=spec["work_dir"])
        if mode == "legs":
            kw["weights"] = spec["weights"]
        res = _MODES[mode](rank, world, **kw)
    finally:
        if group:
            mesh.destroy_distributed()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--rank"]:
        return _rank_main(argv[1:])
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m rscotr_tpu_torch.graft_entry",
        description="the port's dry run over n ranks")
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
