"""``with_cp`` (activation checkpointing per Swin block and per deformable
encoder layer; ROADMAP C16) on the CPU:

* the tiny MTL's parameter gradients with ``with_cp`` equal those without
  it bit for bit, for the cls, det and seg losses, with drop path 0.3
  drawing from one explicit generator, which ends in the same state; the
  blocks and layers really run twice (forward and recompute);
* the test has teeth: a recompute that draws from the generator again
  (what ``torch.utils.checkpoint`` alone gives, since it restores only the
  default generators) gives other gradients;
* a serving forward (eval mode) and a config without the key are
  unchanged;
* the port's steps with ``with_cp`` on the schedule det, seg against
  the JAX package's with ``with_cp`` (``nn.remat``), from the same
  weights and batches, drop path 0 as the tiny config has it, at the
  tolerances of tests/test_torch_port_train_slice.py: every loss term and
  ``grad_norm`` at rtol 2e-3 / atol 2e-4, the final parameters at
  2e-4 + 5e-3 * |w|.
"""

import copy
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
from rscotr_tpu_torch.engine.train_step import (cls_loss_fn, det_loss_fn,
                                                make_train_step,
                                                parse_losses, seg_loss_fn)
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.models.backbones import swin
from rscotr_tpu_torch.models.layers import transformer
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
CP = {"model.backbone.with_cp": True, "model.shared_encoder.with_cp": True}
LOSS_FNS = {"cls": cls_loss_fn, "det": det_loss_fn, "seg": seg_loss_fn}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch keeps to 2 threads, so that the test workers beside this one
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _batches(cdn):
    """One cls, det (with its CDN noise) and seg batch, numpy-seeded."""
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
    shape = (2, 2 * cdn.num_groups, cdn.single_pad)
    nrng = np.random.default_rng(100)
    det = dict(
        img=rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8),
        img_hw=hw, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
        dn_noise_p=nrng.uniform(size=shape).astype(np.float32),
        dn_noise_new_label=nrng.integers(0, 20, shape).astype(np.int32),
        dn_noise_sign=(nrng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
        dn_noise_part=nrng.uniform(size=shape + (4,)).astype(np.float32))
    seg_labels = rng.integers(0, 5, (2, 64, 64)).astype(np.uint8)
    seg_labels[:, 20:23] = 255
    seg = dict(img=rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
               gt_semantic_seg=seg_labels)
    return {"cls": cls, "det": det, "seg": seg}


def _cfg(with_cp, drop_path=0.3):
    cfg = load_cfg(TINY)
    mc = cfg["model"]
    mc["backbone"]["drop_path_rate"] = drop_path
    if with_cp is not None:
        mc["backbone"]["with_cp"] = with_cp
        mc["shared_encoder"]["with_cp"] = with_cp
    return cfg


def _grads(task, with_cp):
    """(gradients by name, the generator's state after the step)."""
    cfg = _cfg(with_cp)
    step_cfg = dataclasses.replace(make_step_config(cfg),
                                   cls_use_augments=False)
    model = build_model(cfg["model"], device="cpu",
                        generator=torch.Generator().manual_seed(0)).train()
    batch = {k: torch.as_tensor(v)
             for k, v in _batches(step_cfg.cdn)[task].items()}
    g = torch.Generator().manual_seed(11)
    total, _ = parse_losses(LOSS_FNS[task](model, batch, g, step_cfg))
    total.backward()
    return ({n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}, g.get_state())


@pytest.mark.parametrize("task", ["cls", "det", "seg"])
def test_with_cp_gradients_bit_equal(task, monkeypatch):
    calls = {"block": 0, "layer": 0}
    block_fwd = swin.SwinBlock._forward
    layer_fwd = transformer.DeformableEncoderLayer.forward

    def counted_block(self, *a, **kw):
        calls["block"] += 1
        return block_fwd(self, *a, **kw)

    def counted_layer(self, *a, **kw):
        calls["layer"] += 1
        return layer_fwd(self, *a, **kw)

    monkeypatch.setattr(swin.SwinBlock, "_forward", counted_block)
    monkeypatch.setattr(transformer.DeformableEncoderLayer, "forward",
                        counted_layer)
    want, want_state = _grads(task, False)
    plain = dict(calls)
    calls.update(block=0, layer=0)
    got, got_state = _grads(task, True)
    # every block (and, past cls, every encoder layer) ran again in the
    # backward
    assert plain["block"] > 0 and calls["block"] == 2 * plain["block"]
    assert calls["layer"] == 2 * plain["layer"]
    assert (plain["layer"] > 0) == (task != "cls")
    assert sorted(got) == sorted(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert torch.equal(got_state, want_state)


def test_with_cp_redraw_changes_gradients(monkeypatch):
    """Without the fix (the recompute draws its drop-path masks from the
    generator again) the gradients differ."""
    want, _ = _grads("cls", True)

    def redraw(fn, x, generator):
        return torch.utils.checkpoint.checkpoint(fn, x, generator,
                                                 use_reentrant=False)

    monkeypatch.setattr(swin, "checkpoint_with_generator", redraw)
    got, _ = _grads("cls", True)
    assert any(not torch.equal(got[n], want[n]) for n in want)


def test_with_cp_serving_and_default_unchanged():
    """Eval mode takes no checkpoint; a config without the key builds
    without it."""
    cfg = _cfg(None)
    model = build_model(cfg["model"], device="cpu")
    assert not model.backbone.stages[0].blocks[0].with_cp
    assert not model.shared_encoder.with_cp
    cp = build_model(_cfg(True)["model"], device="cpu")
    assert cp.backbone.stages[0].blocks[0].with_cp
    assert cp.shared_encoder.with_cp
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(model.forward_cls(x), cp.forward_cls(x))
        assert torch.equal(model.forward_seg(x), cp.forward_seg(x))


@pytest.fixture(scope="module")
def trained_with_cp():
    jcfg = Config.fromfile(TINY)
    jcfg.merge_from_dict(CP)
    jstep_cfg = dataclasses.replace(jax_make_step_config(jcfg),
                                    cls_use_augments=False)
    cfg = _cfg(True, drop_path=load_cfg(TINY)["model"]["backbone"].get(
        "drop_path_rate", 0.0))
    step_cfg = dataclasses.replace(make_step_config(cfg),
                                   cls_use_augments=False)
    jm = jax_build_model(jcfg.model)
    assert jm.backbone.with_cp and jm.shared_encoder.with_cp
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
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(), **kw)
    masks = task_param_masks(n for n, _ in model.named_parameters())
    batches = _batches(step_cfg.cdn)
    logs = []
    gen = torch.Generator().manual_seed(0)
    with jax.default_matmul_precision("highest"):
        for i, task in enumerate(("det", "seg")):
            jstep = jax_make_train_step(jm, jopt, task, jstep_cfg,
                                        jmasks[task], donate=False)
            params, jstate, jlv = jstep(
                params, jstate,
                {k: jnp.asarray(v) for k, v in batches[task].items()},
                jax.random.key(i))
            step = make_train_step(model, opt, task, step_cfg, masks[task])
            lv = step(batches[task], gen)
            logs.append((task, {k: float(v) for k, v in jlv.items()},
                         {k: float(v) for k, v in lv.items()}))
    final_jax = state_dict_from_jax(
        jax.tree.map(lambda x: np.asarray(x).copy(), params["params"]))
    return dict(logs=logs, final_jax=final_jax, model=model)


@pytest.mark.parametrize("i", range(2))
def test_with_cp_step_losses_match_jax(trained_with_cp, i):
    task, want, got = trained_with_cp["logs"][i]
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-4,
                                   err_msg=f"step {i} ({task}) {k}")


def test_with_cp_final_params_match_jax(trained_with_cp):
    sd = trained_with_cp["model"].state_dict()
    bad = []
    for name, w in trained_with_cp["final_jax"].items():
        g = sd[name].numpy()
        w = w.numpy()
        err = np.abs(g - w) - (2e-4 + 5e-3 * np.abs(w))
        if (err > 0).any():
            j = np.unravel_index(np.argmax(err), err.shape)
            bad.append(f"{name}{list(j)}: got {g[j]:.6g} want {w[j]:.6g}")
    assert not bad, "final params diverged:\n" + "\n".join(bad[:20])


def test_with_cp_config_key_read():
    """build_model reads the key where JAX's build reads it."""
    cfg = copy.deepcopy(_cfg(True)["model"])
    m = build_model(cfg, device="cpu")
    assert all(b.with_cp for s in m.backbone.stages for b in s.blocks)
