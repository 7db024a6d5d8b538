"""The multi-level cls head of the port against the JAX package (CPU,
float32, JAX under highest matmul precision), with the same weights
(``state_dict_from_jax``) and the same numpy-seeded inputs:

* ``MlvlClsPixelDecoder`` and ``MlvlClsHead`` for each of schemes 1-8,
  through the same plain ``encode_fn``; the token count n that sizes
  ``out_proj`` (schemes 5-8) against ``jax.eval_shape`` of the JAX init, for
  the head alone and for the paper's MTL at its 224^2 cls input (n = 16: the
  levels are 28^2, 14^2, 7^2 and the neck's extra 4^2) and at a size the
  patch embedding pads (200^2);
* a tiny MTL with an ``MlvlClsHead`` (the tiny config's, cls head swapped):
  ``infer["cls"]`` and one cls train step under the masks of
  ``cls_uses_encoder=True``, as JAX's ``train_model`` computes them, against
  JAX's ``make_train_step``; the encoder's parameters move in both.

Tolerances: head and decoder outputs 1e-5 relative + 1e-5 absolute; cls
probabilities 1e-5; the train step's loss terms and grad norm at rtol 2e-3 /
atol 2e-4 and the parameters after it at 2e-4 + 5e-3 * |w|, the tolerances
of test_torch_port_train_slice.py (Adam turns float noise in a near-zero
gradient into an O(lr) update).
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu.apis import derive_shapes as jax_derive_shapes
from rscotr_tpu.apis import make_step_config as jax_make_step_config
from rscotr_tpu.config import Config
from rscotr_tpu.engine import build_optimizer as jax_build_optimizer
from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
from rscotr_tpu.engine import make_train_step as jax_make_train_step
from rscotr_tpu.engine import task_param_masks as jax_task_param_masks
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu.models.heads import cls_heads as jcls
from rscotr_tpu.models.heads import pixel_decoders as jpd
from rscotr_tpu_torch.apis import derive_cls_hw, make_step_config
from rscotr_tpu_torch.engine import make_infer_steps
from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                               task_param_masks)
from rscotr_tpu_torch.engine.train_step import make_train_step
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.models.heads.cls_heads import MlvlClsHead
from rscotr_tpu_torch.models.heads.pixel_decoders import MlvlClsPixelDecoder
from rscotr_tpu_torch.utils import convert
from rscotr_tpu_torch.utils.config import load_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
PAPER = os.path.join(ROOT,
                     "configs/multi/MTL_swin-t-p4-w7_1x1_resisc_dior_potsdam.py")
TOL = 1e-5
HIGHEST = jax.default_matmul_precision("highest")


def tnp(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def jax_encode(tokens, pos, ref, shapes, key_padding_mask=None,
               deterministic=True):
    """A plain stand-in for the shared encoder, the same in both stacks."""
    return tokens * 0.5 + pos * 0.25 + ref[:, :, 0, :1]


def torch_encode(tokens, pos, ref, shapes):
    return tokens * 0.5 + pos * 0.25 + ref[:, :, 0, :1]


def neck_feats(rng, B=2, C=32, sizes=(16, 8, 4, 2)):
    """Neck maps, high -> low resolution, NHWC float32."""
    return [rng.normal(size=(B, s, s + 1, C)).astype(np.float32)
            for s in sizes]


def test_mlvl_cls_pixel_decoder_vs_jax():
    rng = np.random.default_rng(0)
    nk = neck_feats(rng)
    jm = jpd.MlvlClsPixelDecoder(feat_channels=32)
    jnk = [jnp.asarray(a) for a in nk]
    params = jax.jit(lambda k: jm.init(k, jax_encode, jnk))(jax.random.key(0))
    with HIGHEST:
        want = jax.jit(lambda p: jm.apply(p, jax_encode, jnk))(params)
    tree = tnp(params["params"])
    assert tree["level_encoding"].shape == (4, 32)
    m = load(MlvlClsPixelDecoder(feat_channels=32),
             {"level_encoding.weight": tree["level_encoding"]})
    got = m(torch_encode, [torch.from_numpy(a) for a in nk])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == \
        [(2, 2, 3, 32), (2, 4, 5, 32), (2, 8, 9, 32), (2, 16, 17, 32)]
    for g, w in zip(got, want):
        close(g.detach().numpy(), w)


@pytest.mark.parametrize("scheme", range(1, 9))
def test_mlvl_cls_head_vs_jax(scheme):
    rng = np.random.default_rng(scheme)
    nk = neck_feats(rng)
    counts = [s * (s + 1) for s in (2, 4, 8, 16)]      # low -> high
    jm = jcls.MlvlClsHead(num_classes=7, in_channels=32, scheme=scheme,
                          feat_channels=32)
    jnk = [jnp.asarray(a) for a in nk]
    shapes = jax.eval_shape(lambda k: jm.init(k, jnk, jnk, jax_encode),
                            jax.random.key(0))["params"]
    params = jax.jit(lambda k: jm.init(k, jnk, jnk, jax_encode))(
        jax.random.key(scheme))
    with HIGHEST:
        want = jax.jit(lambda p: jm.apply(p, jnk, jnk, jax_encode))(params)
    m = MlvlClsHead(num_classes=7, scheme=scheme, feat_channels=32,
                    token_counts=counts)
    if scheme >= 5:
        n = {5: counts[0], 6: counts[1], 7: sum(counts), 8: 4}[scheme]
        assert shapes["out_proj_w"].shape == (n, 1)
        assert tuple(m.out_proj.weight.shape) == (1, n)
    else:
        assert "out_proj_w" not in shapes and m.out_proj is None
    m = load(m, convert._cls_head(tnp(params["params"]), ""))
    got = m([torch.from_numpy(a) for a in nk], torch_encode)
    assert got.shape == want.shape == (2, 7)
    close(got.detach().numpy(), want)


def test_mlvl_cls_head_needs_a_size():
    for scheme in (5, 6, 7):
        with pytest.raises(ValueError, match="cls_hw"):
            MlvlClsHead(scheme=scheme, device="meta")
    assert MlvlClsHead(scheme=8, device="meta").out_proj.weight.shape == \
        (1, 4)
    cfg = load_cfg(PAPER)
    with pytest.raises(ValueError, match="cls_hw"):
        build_model(cfg["model"], device="meta")


@pytest.mark.parametrize("size,scheme", [(224, 5), (224, 7), (200, 6)])
def test_paper_mtl_token_count_matches_jax(size, scheme):
    cfg = load_cfg(PAPER)
    assert derive_cls_hw(cfg) == (224, 224)
    model_cfg = dict(cfg["model"],
                     cls_head=dict(cfg["model"]["cls_head"], scheme=scheme))
    jm = jax_build_model(dict(model_cfg, bbox_head=None, seg_head=None))
    shapes = jax.eval_shape(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, size, size, 3))), jax.random.key(0))
    n = shapes["params"]["cls_head"]["out_proj_w"].shape[0]
    if (size, scheme) == (224, 5):
        assert n == 16
    model = build_model(model_cfg, tasks=("cls",), device="meta",
                        cls_hw=size)
    assert tuple(model.cls_head.out_proj.weight.shape) == (1, n)


def test_derive_cls_hw_matches_jax_derive_shapes():
    """Two cls datasets of different sizes: both packages size the head
    from the last one; no cls dataset gives no size."""
    cfg, jcfg = load_cfg(TINY), Config.fromfile(TINY)
    extra = dict(cfg["data"]["resisc"], loader=dict(cls_size=96))
    for c in (cfg, jcfg):
        c["data"]["resisc2"] = copy.deepcopy(extra)
    want = jax_derive_shapes(jcfg)["cls"][1:3]
    assert derive_cls_hw(cfg) == want == (96, 96)
    del cfg["data"]["resisc"], cfg["data"]["resisc2"]
    assert derive_cls_hw(cfg) is None


# ---------------------------------------------------------------------------
# a tiny MTL with an MlvlClsHead: serving and one train step
# ---------------------------------------------------------------------------

def _mlvl_tiny(scheme=5):
    cfg = load_cfg(TINY)
    cfg["model"]["cls_head"] = dict(
        type="MlvlClsHead", num_classes=45, in_channels=64, scheme=scheme,
        pixel_decoder=dict(type="MlvlClsPixelDecoder", num_encoder_levels=4,
                           strides=[8, 16, 32, 64], feat_channels=64),
        loss=dict(type="LabelSmoothLoss", label_smooth_val=0.1))
    cfg["model"]["bbox_head"] = cfg["model"]["seg_head"] = None
    return cfg


@pytest.fixture(scope="module")
def mlvl_trained():
    cfg = _mlvl_tiny()
    jcfg = Config.fromfile(TINY)
    jcfg.model = cfg["model"]
    hw = derive_cls_hw(cfg)
    assert hw == (128, 128)
    jm = jax_build_model(cfg["model"])
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1,) + hw + (3,))))(jax.random.key(0))
    tree = tnp(params["params"])
    assert tree["cls_head"]["out_proj_w"].shape == (4, 1)   # 2^2 tokens
    model = build_model(cfg["model"], device="cpu", cls_hw=hw)
    model.load_state_dict(convert.state_dict_from_jax(tree), strict=True)

    rng = np.random.default_rng(11)
    batch = dict(img=rng.integers(0, 256, (2,) + hw + (3,)).astype(np.uint8),
                 gt_label=rng.integers(0, 45, 2).astype(np.int32))
    with HIGHEST:
        want_probs = np.asarray(jax_make_infer_steps(jm)["cls"](
            params, jnp.asarray(batch["img"])))
    got_probs = make_infer_steps(model)["cls"](batch["img"]).numpy()

    kw = dict(lr_config=cfg["lr_config"],
              grad_clip=cfg["optimizer_config"]["grad_clip"])
    jstep_cfg = dataclasses.replace(jax_make_step_config(jcfg),
                                    cls_use_augments=False)
    jopt = jax_build_optimizer(jcfg.optimizer, params["params"], **kw)
    jmask = jax_task_param_masks(params["params"],
                                 cls_uses_encoder=True)["cls"]
    jstep = jax_make_train_step(jm, jopt, "cls", jstep_cfg, jmask,
                                donate=False)
    step_cfg = dataclasses.replace(make_step_config(cfg),
                                   cls_use_augments=False)
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(), **kw)
    cls_head_cfg = cfg["model"].get("cls_head") or {}
    mask = task_param_masks(
        (n for n, _ in model.named_parameters()),
        cls_uses_encoder=cls_head_cfg.get("type") == "MlvlClsHead")["cls"]
    step = make_train_step(model, opt, "cls", step_cfg, mask)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with HIGHEST:
        new, _, jlv = jstep(params, jopt.init(params["params"]),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.key(1))
    lv = step(batch, torch.Generator().manual_seed(0))
    return dict(probs=(got_probs, want_probs), before=before, model=model,
                logs=({k: float(v) for k, v in lv.items()},
                      {k: float(v) for k, v in jlv.items()}),
                tree_before=tree, tree_after=tnp(new["params"]), mask=mask)


def test_tiny_mlvl_infer_cls_matches_jax(mlvl_trained):
    got, want = mlvl_trained["probs"]
    assert got.shape == want.shape == (2, 45)
    close(got, want)


def test_tiny_mlvl_cls_step_matches_jax(mlvl_trained):
    got, want = mlvl_trained["logs"]
    assert set(got) == set(want) == {"loss_cls", "loss", "grad_norm"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    sd = mlvl_trained["model"].state_dict()
    final = convert.state_dict_from_jax(mlvl_trained["tree_after"])
    bad = []
    for name, w in final.items():
        g, w = sd[name].numpy(), w.numpy()
        if (np.abs(g - w) > 2e-4 + 5e-3 * np.abs(w)).any():
            bad.append(name)
    assert not bad, bad[:10]


def test_tiny_mlvl_cls_step_trains_the_encoder(mlvl_trained):
    """cls_uses_encoder: the neck and the shared encoder move in both
    packages. (The level encoding reaches the loss only through the
    sampling offsets and attention weights, whose weights start at zero, so
    its first gradient is zero in both.)"""
    mask = mlvl_trained["mask"]
    assert mask["shared_encoder.layers.0.ffns.0.layers.1.weight"] == 1.0
    assert mask["neck.convs.0.conv.weight"] == 1.0
    before = mlvl_trained["before"]
    sd = mlvl_trained["model"].state_dict()
    jb = convert.state_dict_from_jax(mlvl_trained["tree_before"])
    ja = convert.state_dict_from_jax(mlvl_trained["tree_after"])
    for name in ("shared_encoder.layers.0.ffns.0.layers.1.weight",
                 "neck.convs.0.conv.weight",
                 "cls_head.out_proj.weight"):
        assert not torch.equal(sd[name], before[name]), name
        assert not torch.equal(ja[name], jb[name]), name
    name = "cls_head.pixel_decoder.level_encoding.weight"
    assert torch.equal(sd[name], before[name]) and torch.equal(ja[name],
                                                                jb[name])
