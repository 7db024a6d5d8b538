"""Seg training of the port against the JAX package (CPU, float32, JAX under
highest matmul precision), with the same weights (``state_dict_from_jax``)
and the same numpy-seeded inputs:

* ``resize_linear`` against ``jax.image.resize(method="linear")`` at up-,
  down- and mixed sizes, integer and non-integer ratios; the weights it
  applies along one axis (the resize of an identity): when no axis shrinks,
  the bilinear grid of ``F.interpolate`` that ``_resize_bilinear`` (the
  mask downsample's resize) takes, which the antialiased grid equals there,
  entry for entry; when an axis shrinks, the widened triangle;
* ``seg_loss_fn``'s value and the gradients of every parameter through
  ``forward_seg``, against ``jax.value_and_grad`` of JAX's ``seg_loss_fn``,
  on the tiny config (uint8 images; uint8 labels in [0, 5) with a band of
  the ignore index 255), labels at the input size and at a size the logits
  shrink to on one axis;
* ``make_step_config``'s seg fields and a seg ``make_train_step`` under the
  seg mask: the masked parts stay bit-identical.

Tolerances: resizes 1e-6 (float32, another summation order); the matrix
against the bilinear grid 2.4e-7 (two float32 ulps at 1: the sample
positions are computed in another order); the loss at 1e-5 relative; each
gradient within 1e-6 + 1e-4 of its tensor's largest JAX entry + 1e-3
relative (float32 sums of ~1e4 terms in another order, through softmaxes;
the 1e-6 floor is for gradients that are zero but for float noise, such as
the last mask-embedding bias, whose shift the mask softmax cancels). The
seg forward thresholds resized mask logits, so a logit within the error of
0 would flip an attention bit: the test asserts that JAX's smallest |logit|
entering a threshold exceeds the whole seg forward's tolerance in
test_torch_port_seg.py (1e-4).
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
from rscotr_tpu.engine.train_step import device_normalize as jax_normalize
from rscotr_tpu.engine.train_step import seg_loss_fn as jax_seg_loss_fn
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu.models.heads import pixel_decoders as jpd
from rscotr_tpu_torch.apis import make_step_config
from rscotr_tpu_torch.engine.infer import resize_linear
from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                               task_param_masks)
from rscotr_tpu_torch.engine.train_step import make_train_step, seg_loss_fn
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.models.heads.pixel_decoders import _resize_bilinear
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
HIGHEST = jax.default_matmul_precision("highest")


def tnp(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


# ---------------------------------------------------------------------------
# the resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((5, 7), (40, 56)),        # up, integer ratio
    ((4, 6), (13, 9)),         # up, non-integer
    ((40, 56), (5, 7)),        # down, integer (antialiased)
    ((13, 9), (4, 6)),         # down, non-integer
    ((8, 8), (6, 20)),         # mixed: one axis shrinks, one grows
    ((10, 30), (7, 30)),       # one axis kept
])
def test_resize_matrix_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).normal(size=(2,) + src + (3,)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,),
                            method="linear")
    got = resize_linear(torch.from_numpy(x), dst)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def resize_matrix(out_size, in_size):
    """(out, in) weights ``resize_linear`` applies along the height: the
    resize of an identity."""
    eye = torch.eye(in_size)[None, :, :, None]          # (1, in, in, 1)
    return resize_linear(eye, (out_size, in_size))[0, :, :, 0].numpy()


@pytest.mark.parametrize("out_size,in_size", [(40, 5), (13, 4), (9, 6),
                                              (64, 8), (7, 7)])
def test_resize_matrix_upsampling_is_the_bilinear_grid(out_size, in_size):
    m = resize_matrix(out_size, in_size)
    eye = torch.eye(in_size)[None, :, :, None]          # (1, in, in, 1)
    grid = _resize_bilinear(eye, (out_size, in_size))[0, :, :, 0]
    np.testing.assert_allclose(m, grid.numpy(), rtol=0, atol=2.4e-7)
    aa = torch.nn.functional.interpolate(
        eye[..., 0][None], size=(out_size, in_size), mode="bilinear",
        align_corners=False, antialias=True)[0, 0, :, :]
    np.testing.assert_allclose(m, aa.numpy(), rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(m, jpd._interp_matrix(out_size, in_size),
                               rtol=0, atol=2.4e-7)


def test_resize_matrix_shrinks_with_a_wider_kernel():
    """Downsampling by 2 averages over the widened triangle, where the
    bilinear grid would sample two neighbours only."""
    m = resize_matrix(4, 8)
    np.testing.assert_allclose(m.sum(1), 1.0, rtol=1e-6)
    assert (m > 0).sum(1).tolist() == [3, 4, 4, 3]
    assert (jpd._interp_matrix(4, 8) > 0).sum(1).tolist() == [2, 2, 2, 2]


# ---------------------------------------------------------------------------
# the seg loss and its gradients
# ---------------------------------------------------------------------------

def _intermediates(tree, name):
    if name in tree:
        return tree[name]["__call__"]
    for sub in tree.values():
        if isinstance(sub, dict):
            found = _intermediates(sub, name)
            if found is not None:
                return found
    return None


def jax_mask_margin(jm, params, img, num_layers, L):
    """JAX's smallest |resized mask logit| entering the attention-mask
    threshold of any decoder layer of ``forward_seg(img)``."""
    with HIGHEST:
        state = jax.jit(lambda p, x: jm.apply(
            p, x, method=jm.forward_seg,
            capture_intermediates=lambda mdl, _: mdl.name in (
                "mask_embed", "pixel_decoder"),
            mutable=["intermediates"])[1])(params, img)
    inter = state["intermediates"]
    mask_feature, ms = _intermediates(inter, "pixel_decoder")[0]
    mes = _intermediates(inter, "mask_embed")
    margin = np.inf
    with HIGHEST:
        for j in range(num_layers):
            mp = jnp.einsum("bqc,bhwc->bqhw", mes[j], mask_feature)
            am = jpd._resize_bilinear(mp.transpose(0, 2, 3, 1),
                                      ms[j % L].shape[1:3])
            margin = min(margin, float(jnp.abs(am).min()))
    return margin


def seg_batch(rng, B=2, hw=(64, 64), label_hw=(64, 64)):
    """uint8 images, uint8 labels in [0, 5) with a band of 255 (ignored)."""
    labels = rng.integers(0, 5, (B,) + label_hw).astype(np.uint8)
    labels[:, label_hw[0] // 3:label_hw[0] // 3 + 2] = 255
    return dict(img=rng.integers(0, 256, (B,) + hw + (3,)).astype(np.uint8),
                gt_semantic_seg=labels)


@pytest.fixture(scope="module")
def tiny_seg():
    cfg = load_cfg(TINY)
    jcfg = Config.fromfile(TINY)
    jm = jax_build_model(cfg["model"])
    params = jax.jit(lambda k: jm.init(
        k, seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    return cfg, jcfg, jm, params


def test_seg_step_config_matches_jax(tiny_seg):
    cfg, jcfg, _, _ = tiny_seg
    got, want = make_step_config(cfg), jax_make_step_config(jcfg)
    assert (got.seg_ignore_index, got.seg_loss_weight) == \
        (want.seg_ignore_index, want.seg_loss_weight) == (255, 1.0)
    assert got.task_weight["seg"] == want.task_weight["seg"] == 0.1


@pytest.mark.parametrize("label_hw", [(64, 64), (6, 12)],
                         ids=["input size", "shrink and grow"])
def test_seg_loss_and_grads_match_jax(tiny_seg, label_hw):
    cfg, jcfg, jm, params = tiny_seg
    step_cfg, jstep_cfg = make_step_config(cfg), jax_make_step_config(jcfg)
    batch = seg_batch(np.random.default_rng(5), label_hw=label_hw)
    hd = cfg["model"]["seg_head"]
    margin = jax_mask_margin(
        jm, params, jax_normalize(jnp.asarray(batch["img"]), None),
        hd["transformer_decoder"]["num_layers"],
        hd["num_transformer_feat_level"])
    assert margin > 1e-4, margin

    def lf(p):
        losses = jax_seg_loss_fn(jm, p, {k: jnp.asarray(v)
                                         for k, v in batch.items()},
                                 jax.random.key(0), jstep_cfg, train=True)
        return losses["seg.loss_ce"]

    with HIGHEST:
        want, jgrads = jax.jit(jax.value_and_grad(lf))(params)
    want_g = state_dict_from_jax(tnp(jgrads["params"]))

    model = build_model(cfg["model"], tasks=("seg",), device="cpu")
    model.load_state_dict(state_dict_from_jax(tnp(params["params"])),
                          strict=True)
    model.train()
    losses = seg_loss_fn(model, {k: torch.as_tensor(v)
                                 for k, v in batch.items()},
                         torch.Generator().manual_seed(0), step_cfg)
    assert set(losses) == {"seg.loss_ce"}
    got = losses["seg.loss_ce"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    bad = []
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        lim = 1e-6 + 1e-4 * np.abs(w).max() + 1e-3 * np.abs(w)
        if (np.abs(g - w) > lim).any():
            bad.append(f"{name}: max err {np.abs(g - w).max():.3g}, max "
                       f"|grad| {np.abs(w).max():.3g}")
    assert not bad, "\n".join(bad[:20])
    assert sum(float(p.grad.abs().sum()) for p in model.parameters()
               if p.grad is not None) > 0


def test_seg_train_step_runs_under_the_seg_mask(tiny_seg):
    cfg = tiny_seg[0]
    model = build_model(cfg["model"], device="cpu")
    names = [n for n, _ in model.named_parameters()]
    masks = task_param_masks(names)
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=cfg["lr_config"],
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    step_cfg = dataclasses.replace(make_step_config(cfg),
                                   seg_loss_weight=2.0)
    step = make_train_step(model, opt, "seg", step_cfg, masks["seg"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lv = step(seg_batch(np.random.default_rng(6)),
              torch.Generator().manual_seed(0))
    assert set(lv) == {"seg.loss_ce", "loss", "grad_norm"}
    assert all(np.isfinite(float(v)) for v in lv.values())
    assert float(lv["loss"]) == pytest.approx(float(lv["seg.loss_ce"]))
    params = dict(model.named_parameters())
    for n in names:
        moved = not torch.equal(before[n], params[n])
        if n.startswith(("cls_head.", "bbox_head.")):
            assert not moved, n
    assert not torch.equal(before["seg_head.query_feat.weight"],
                           params["seg_head.query_feat.weight"])
    assert not torch.equal(before["backbone.patch_embed.proj.weight"],
                           params["backbone.patch_embed.proj.weight"])
