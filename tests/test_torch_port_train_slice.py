"""The training slice end to end: the tiny config's cls, det and seg train
steps through the port's ``make_train_step`` against the JAX package's, on
the schedule cls, det, seg, det, cls, seg from the same weights (carried
across by ``state_dict_from_jax``), the same numpy-seeded batches (seg:
uint8 labels in [0, 5) with a band of the ignore index 255) and the same
CDN noise (the ``dn_noise_*`` batch entries), float32, JAX under highest
matmul precision, ``cls_use_augments=False`` (the augment draws come from
each framework's own generator; ``cls_batch_augment`` has its own test).

Tolerances are those of tests/test_composed_parity.py: every loss term and
``grad_norm`` per step at rtol 2e-3 / atol 2e-4, the final parameters at
2e-4 + 5e-3 * |w| (Adam normalizes each step to ~lr, so a parameter whose
true gradient is near zero turns float noise into O(1e-4) update
differences; a composition bug such as a wrong weight, avg factor or mask
moves updates by O(lr * steps)).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu.apis import make_step_config as jax_make_step_config
from rscotr_tpu.config import Config
from rscotr_tpu.engine import build_optimizer as jax_build_optimizer
from rscotr_tpu.engine import make_train_step as jax_make_train_step
from rscotr_tpu.engine import task_param_masks as jax_task_param_masks
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu_torch.apis import make_step_config
from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                               task_param_masks)
from rscotr_tpu_torch.engine.train_step import make_train_step
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
SCHEDULE = ("cls", "det", "seg", "det", "cls", "seg")
TASKS = ("cls", "det", "seg")


def _batches(cdn):
    rng = np.random.default_rng(7)
    cls = dict(img=rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
               gt_label=rng.integers(0, 45, 2).astype(np.int32))
    G = cdn.max_gt
    boxes = np.zeros((2, G, 4), np.float32)
    labels = np.zeros((2, G), np.int32)
    valid = np.zeros((2, G), bool)
    hw = np.array([[128, 128], [100, 120]], np.int32)   # one padded image
    for b, n in enumerate((3, 6)):
        xy = rng.uniform(0, 70, (n, 2))
        wh = rng.uniform(8, 40, (n, 2))
        boxes[b, :n] = np.concatenate([xy, np.minimum(xy + wh, hw[b, ::-1])],
                                      1)
        labels[b, :n] = rng.integers(0, 20, n)
        valid[b, :n] = True
    det = dict(img=rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8),
               img_hw=hw, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid)
    shape = (2, 2 * cdn.num_groups, cdn.single_pad)
    noises = []
    for i in range(2):
        nrng = np.random.default_rng(100 + i)
        noises.append(dict(
            dn_noise_p=nrng.uniform(size=shape).astype(np.float32),
            dn_noise_new_label=nrng.integers(0, 20, shape).astype(np.int32),
            dn_noise_sign=(nrng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                           ).astype(np.float32),
            dn_noise_part=nrng.uniform(size=shape + (4,)).astype(
                np.float32)))
    seg = []
    for _ in range(2):
        labels = rng.integers(0, 5, (2, 64, 64)).astype(np.uint8)
        labels[:, 20:23] = 255
        seg.append(dict(
            img=rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            gt_semantic_seg=labels))
    return cls, det, noises, seg


@pytest.fixture(scope="module")
def trained():
    jcfg = Config.fromfile(TINY)
    jstep_cfg = dataclasses.replace(jax_make_step_config(jcfg),
                                    cls_use_augments=False)
    cfg = load_cfg(TINY)
    step_cfg = dataclasses.replace(make_step_config(cfg),
                                   cls_use_augments=False)
    jm = jax_build_model(jcfg.model)
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    tree = jax.tree.map(lambda x: np.asarray(x).copy(), params["params"])
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(state_dict_from_jax(tree), strict=True)

    kw = dict(lr_config=cfg["lr_config"],
              grad_clip=cfg["optimizer_config"]["grad_clip"])
    jopt = jax_build_optimizer(jcfg.optimizer, params["params"], **kw)
    jstate = jopt.init(params["params"])
    jmasks = jax_task_param_masks(params["params"])
    jsteps = {t: jax_make_train_step(jm, jopt, t, jstep_cfg, jmasks[t],
                                     donate=False) for t in TASKS}
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(), **kw)
    masks = task_param_masks(n for n, _ in model.named_parameters())
    steps = {t: make_train_step(model, opt, t, step_cfg, masks[t])
             for t in TASKS}

    cls_b, det_b, noises, seg_b = _batches(step_cfg.cdn)
    logs = []
    gen = torch.Generator().manual_seed(0)
    n_det = n_seg = 0
    with jax.default_matmul_precision("highest"):
        for i, task in enumerate(SCHEDULE):
            batch = cls_b
            if task == "det":
                batch = dict(det_b, **noises[n_det])
                n_det += 1
            elif task == "seg":
                batch = seg_b[n_seg]
                n_seg += 1
            params, jstate, jlv = jsteps[task](
                params, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.key(i))
            lv = steps[task](batch, gen)
            logs.append((task, {k: float(v) for k, v in jlv.items()},
                         {k: float(v) for k, v in lv.items()}))
    final_jax = state_dict_from_jax(
        jax.tree.map(lambda x: np.asarray(x).copy(), params["params"]))
    return dict(logs=logs, final_jax=final_jax, model=model,
                step_cfgs=(jstep_cfg, step_cfg))


def test_step_config_matches_jax(trained):
    jstep_cfg, step_cfg = trained["step_cfgs"]
    assert step_cfg.task_weight == dict(jstep_cfg.task_weight)
    for f in dataclasses.fields(step_cfg.det):
        assert getattr(step_cfg.det, f.name) == getattr(jstep_cfg.det, f.name)
    for name in ("num_classes", "num_queries", "max_gt", "single_pad",
                 "num_groups", "pad_size", "label_noise_scale",
                 "box_noise_scale"):
        assert getattr(step_cfg.cdn, name) == getattr(jstep_cfg.cdn, name)
    assert (step_cfg.cls_num_classes, step_cfg.cls_label_smooth) == \
        (jstep_cfg.cls_num_classes, jstep_cfg.cls_label_smooth)


@pytest.mark.parametrize("i", range(len(SCHEDULE)))
def test_step_losses_match_jax(trained, i):
    task, want, got = trained["logs"][i]
    assert set(got) == set(want), (sorted(got), sorted(want))
    if task == "det":
        assert "d0.dn_loss_iou" in got and "interm_loss_cls" in got
    if task == "seg":
        assert set(got) == {"seg.loss_ce", "loss", "grad_norm"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-4,
                                   err_msg=f"step {i} ({task}) {k}")


def test_final_params_match_jax(trained):
    sd = trained["model"].state_dict()
    bad = []
    for name, w in trained["final_jax"].items():
        g = sd[name].numpy()
        w = w.numpy()
        err = np.abs(g - w) - (2e-4 + 5e-3 * np.abs(w))
        if (err > 0).any():
            j = np.unravel_index(np.argmax(err), err.shape)
            bad.append(f"{name}{list(j)}: got {g[j]:.6g} want {w[j]:.6g}")
    assert not bad, "final params diverged:\n" + "\n".join(bad[:20])
