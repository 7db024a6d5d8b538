"""The model zoo of the port against the JAX package (CPU, float32 unless
said, JAX under highest matmul precision), with the same weights
(``state_dict_from_jax``, ResNet statistics from ``batch_stats``) and the
same numpy-seeded inputs:

* ``ResNet(depth=50, num_stages=2)`` with random BatchNorm parameters and
  statistics, float32 and bfloat16 compute, loaded strictly from the
  bridged tree (``num_batches_tracked`` included); the stem's max-pool pads
  with -inf; ``norm_eval=False`` refuses training;
* a tiny standalone ``DINO`` (the tiny config's Swin, neck, encoder and
  DINO head): ``infer["det"]`` and one det train step;
* a tiny standalone ``RSCoTrSeg`` (the tiny config's Swin, a 3-level
  encoder, the Mask2Former head with input convs): ``infer["seg_logits"]``
  and one seg train step;
* ROADMAP C6: ``task_param_masks`` of both packages leave a standalone
  model's ``encoder`` out of the det and seg masks;
* dropout: the kept share, the 1 / (1 - rate) scale, one mask per
  generator seed, identity in eval mode, for the port's ``Dropout`` and
  through the modules that take a rate (the FFN, Swin's ``drop_rate``);
  ``build_model`` refuses the rates no config sets and no kernel runs;
* the full-width configs ``build_model`` builds on the ``meta`` device with
  the keys and shapes of the bridged ``jax.eval_shape`` init.

Tolerances: ResNet float32 1e-4 relative + 1e-4 absolute (50 layers of
float32 sums in another order); bfloat16 2^-6 of the output's largest
entry (the convs round their operands to bf16 in both packages, and a
rounding boundary may fall on either side); det outputs 1e-4 and boxes
1e-3 pixels; seg logits 1e-4; train-step loss terms and grad norm at rtol
2e-3 / atol 2e-4, parameters after the step at 2e-4 + 5e-3 * |w|, as in
test_torch_port_train_slice.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu.apis import make_step_config as jax_make_step_config
from rscotr_tpu.config import Config
from rscotr_tpu.engine import build_optimizer as jax_build_optimizer
from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
from rscotr_tpu.engine import make_train_step as jax_make_train_step
from rscotr_tpu.engine import task_param_masks as jax_task_param_masks
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu.models.backbones import resnet as jresnet
from rscotr_tpu_torch.apis import derive_cls_hw, make_step_config
from rscotr_tpu_torch.engine import make_infer_steps
from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                               task_param_masks)
from rscotr_tpu_torch.engine.train_step import make_train_step
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.models.backbones import swin
from rscotr_tpu_torch.models.backbones.resnet import ResNet
from rscotr_tpu_torch.models.layers.common import FFN, Dropout, init_weights
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
HIGHEST = jax.default_matmul_precision("highest")
FULL = {
    "paper MTL": "configs/multi/MTL_swin-t-p4-w7_1x1_resisc_dior_potsdam.py",
    "DINO-R50": "configs/det/dino_4scale_r50_1x1_50e_dior.py",
    "DINO-Swin-T": "configs/det/dino_4scale_swin-t-p4-w7_1x1_50e_dior.py",
    "RSCoTrSeg-R50":
        "configs/seg/RSCoTrSeg_3scale_r50_512x512_80k_potsdam_IRRG_all.py",
    "RSCoTrSeg-Swin-T":
        "configs/seg/RSCoTrSeg_3scale_swin-t-p4-w7_512x512_80k_potsdam_"
        "IRRG_all.py",
}


def tnp(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def randomize_bn(params, stats, rng):
    """Random BN scale / bias and running statistics (flax inits them to
    1 / 0 / 0 / 1, which would hide a mix-up)."""
    def walk(p, s):
        for k in p:
            if k == "bn":
                n = p[k]["scale"].shape
                p[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    walk(params, stats)


def strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_vs_jax(dtype):
    rng = np.random.default_rng(0)
    jm = jresnet.ResNet(depth=50, num_stages=2, out_indices=(0, 1),
                        dtype=jnp.dtype(dtype))
    x = rng.normal(size=(2, 61, 64, 3)).astype(np.float32)
    variables = jax.jit(lambda k: jm.init(k, jnp.asarray(x)))(
        jax.random.key(0))
    params, stats = tnp(variables["params"]), tnp(variables["batch_stats"])
    randomize_bn(params, stats, rng)
    with HIGHEST:
        want = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(
            {"params": params, "batch_stats": stats})
    sd = strip(state_dict_from_jax({"backbone": params},
                                   {"backbone": stats}), "backbone.")
    assert sd["layer1.0.downsample.1.num_batches_tracked"].dtype == \
        torch.int64
    m = ResNet(depth=50, num_stages=2, out_indices=(0, 1),
               dtype=getattr(torch, dtype))
    m.load_state_dict(sd, strict=True)
    assert set(m.state_dict()) == set(sd)
    got = m.eval()(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == \
        [(2, 16, 16, 256), (2, 8, 8, 512)]
    assert m.out_hw((61, 64)) == [(16, 16), (8, 8)]
    for g, w in zip(got, want):
        # flax BatchNorm promotes a bf16 conv output against its f32
        # statistics: float32 out in both packages
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        if dtype == "float32":
            close(g.detach().numpy(), w, 1e-4)
        else:
            w = np.asarray(w)
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=2.0 ** -6 * np.abs(w).max())


def test_resnet_max_pool_pads_with_neg_inf_and_frozen_bn():
    """All-negative stem outputs: a zero pad would win the border max."""
    m = ResNet(depth=50, num_stages=1, out_indices=(0,))
    with torch.no_grad():
        m.conv1.weight.zero_()
        m.bn1.weight.fill_(1.0)
        m.bn1.bias.fill_(-1.0)
        m.bn1.running_mean.zero_()
        m.bn1.running_var.fill_(1.0 - 1e-5)
    stem = torch.relu(m.bn1(m.conv1(torch.zeros(1, 8, 8, 3))))
    pooled = torch.nn.functional.max_pool2d(
        (stem - 1.0).permute(0, 3, 1, 2), 3, 2, 1)
    assert torch.all(pooled == -1.0)
    m.train()
    assert m.bn1(torch.ones(1, 2, 2, 64)).dtype == torch.float32
    m2 = ResNet(depth=50, num_stages=1, norm_eval=False, frozen_stages=-1)
    m2.eval()(torch.zeros(1, 32, 32, 3))          # eval: running stats
    with pytest.raises(NotImplementedError, match="norm_eval=False"):
        m2.train()(torch.zeros(1, 32, 32, 3))


# ---------------------------------------------------------------------------
# tiny standalone DINO and RSCoTrSeg
# ---------------------------------------------------------------------------

def _tiny(kind):
    cfg = load_cfg(TINY)
    m = cfg["model"]
    if kind == "DINO":
        cfg["model"] = dict(
            type="DINO", backbone=m["backbone"], neck=m["neck"],
            encoder=m["shared_encoder"], bbox_head=m["bbox_head"])
    else:
        enc = m["shared_encoder"]
        layers = enc["transformerlayers"]
        cfg["model"] = dict(
            type="RSCoTrSeg", backbone=m["backbone"],
            encoder=dict(enc, transformerlayers=dict(
                layers, attn_cfgs=dict(layers["attn_cfgs"], num_levels=3))),
            decode_head=dict(m["seg_head"], num_transformer_feat_level=3))
    jcfg = Config.fromfile(TINY)
    jcfg.model = cfg["model"]
    return cfg, jcfg


def det_batch(rng, cdn, hw=((128, 128), (100, 120))):
    G = cdn.max_gt
    boxes = np.zeros((2, G, 4), np.float32)
    labels = np.zeros((2, G), np.int32)
    valid = np.zeros((2, G), bool)
    hw = np.array(hw, np.int32)
    for b, n in enumerate((3, 6)):
        xy = rng.uniform(0, 70, (n, 2))
        wh = rng.uniform(8, 40, (n, 2))
        boxes[b, :n] = np.concatenate([xy, np.minimum(xy + wh, hw[b, ::-1])],
                                      1)
        labels[b, :n] = rng.integers(0, 20, n)
        valid[b, :n] = True
    shape = (2, 2 * cdn.num_groups, cdn.single_pad)
    return dict(
        img=rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8),
        img_hw=hw, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
        dn_noise_p=rng.uniform(size=shape).astype(np.float32),
        dn_noise_new_label=rng.integers(0, 20, shape).astype(np.int32),
        dn_noise_sign=(rng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
        dn_noise_part=rng.uniform(size=shape + (4,)).astype(np.float32))


def seg_batch(rng):
    labels = rng.integers(0, 5, (2, 64, 64)).astype(np.uint8)
    labels[:, 30:33] = 255
    return dict(img=rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
                gt_semantic_seg=labels)


def _run(kind):
    """Serve one batch and take train steps (no task mask) in both packages
    from the same weights: DINO a batch with a padded image, then one
    without; RSCoTrSeg one batch."""
    cfg, jcfg = _tiny(kind)
    jm = jax_build_model(cfg["model"])
    task = "det" if kind == "DINO" else "seg"
    step_cfg = make_step_config(cfg)
    jstep_cfg = jax_make_step_config(jcfg)
    rng = np.random.default_rng(3)
    if task == "det":
        batches = [det_batch(rng, step_cfg.cdn),
                   det_batch(rng, step_cfg.cdn, hw=((128, 128),) * 2)]
        batch = batches[0]
        init = lambda k: jm.init(k, jnp.zeros((1, 128, 128, 3)),  # noqa
                                 jnp.array([[128, 128]], jnp.int32))
    else:
        batches = [seg_batch(rng)]
        batch = batches[0]
        init = lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)))    # noqa
    variables = jax.jit(init)(jax.random.key(0))
    if "batch_stats" in variables:
        params, stats = tnp(variables["params"]), tnp(
            variables["batch_stats"])
        randomize_bn(params["backbone"], stats["backbone"],
                     np.random.default_rng(4))
        variables = {"params": params, "batch_stats": stats}
    tree = tnp(variables["params"])
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(state_dict_from_jax(
        tree, tnp(variables.get("batch_stats"))), strict=True)
    jinfer, infer = jax_make_infer_steps(jm), make_infer_steps(model)
    with HIGHEST:
        if task == "det":
            args = (batch["img"], batch["img_hw"], np.ones((2, 4), np.float32))
            want = jinfer["det"](variables, *(jnp.asarray(a) for a in args))
            got = infer["det"](*args)
        else:
            want = jinfer["seg_logits"](variables, jnp.asarray(batch["img"]))
            got = infer["seg_logits"](batch["img"])

    kw = dict(lr_config=cfg["lr_config"],
              grad_clip=cfg["optimizer_config"]["grad_clip"])
    jopt = jax_build_optimizer(jcfg.optimizer, variables["params"], **kw)
    jstep = jax_make_train_step(jm, jopt, task, jstep_cfg, None,
                                donate=False)
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(), **kw)
    step = make_train_step(model, opt, task, step_cfg)
    new, jstate = variables, jopt.init(variables["params"])
    logs = []
    for i, batch in enumerate(batches):
        with HIGHEST:
            new, jstate, jlv = jstep(
                new, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.key(1 + i))
        lv = step(batch, torch.Generator().manual_seed(i))
        logs.append(({k: float(v) for k, v in lv.items()},
                     {k: float(v) for k, v in jlv.items()}))
    return dict(model=model, infer=(got, want), logs=logs,
                final=state_dict_from_jax(tnp(new["params"]),
                                          tnp(new.get("batch_stats"))),
                before=state_dict_from_jax(tree,
                                           tnp(variables.get("batch_stats"))))


@pytest.fixture(scope="module", params=["DINO", "RSCoTrSeg"])
def zoo_run(request):
    return request.param, _run(request.param)


def test_tiny_standalone_infer_matches_jax(zoo_run):
    kind, r = zoo_run
    got, want = r["infer"]
    if kind == "DINO":
        (gdet, glab), (wdet, wlab) = got, want
        assert tuple(gdet.shape) == wdet.shape == (2, 300, 5)
        np.testing.assert_array_equal(glab.numpy(), np.asarray(wlab))
        close(gdet[..., 4].numpy(), np.asarray(wdet)[..., 4], 1e-4)
        np.testing.assert_allclose(gdet[..., :4].numpy(),
                                   np.asarray(wdet)[..., :4], rtol=0,
                                   atol=1e-3)
    else:
        # the pixel decoder's FPN level (stride 4) sets the logits' size
        assert tuple(got.shape) == want.shape == (2, 64, 64, 16)
        close(got.numpy(), want, 1e-4)


def test_tiny_standalone_train_step_matches_jax(zoo_run):
    kind, r = zoo_run
    for got, want in r["logs"]:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3,
                                       atol=2e-4, err_msg=k)
    if kind == "DINO":
        # ROADMAP C8: from this init, the padded image's all-zero tokens
        # make the Swin LayerNorms' gradients overflow the global norm in
        # both packages; the clip scale is then 0 and the step moves
        # nothing but the weight decay. The unpadded batch trains.
        assert r["logs"][0][0]["grad_norm"] == np.inf == \
            r["logs"][0][1]["grad_norm"]
    assert np.isfinite(r["logs"][-1][0]["grad_norm"])
    sd = r["model"].state_dict()
    bad = []
    for name, w in r["final"].items():
        g, w = sd[name].numpy(), w.numpy()
        if (np.abs(g - w) > 2e-4 + 5e-3 * np.abs(w)).any():
            bad.append(name)
    assert not bad, bad[:10]
    # with no task mask the owned encoder trains in both packages
    name = "encoder.layers.0.ffns.0.layers.1.weight"
    assert not torch.equal(sd[name], r["before"][name])
    assert not torch.equal(r["final"][name], r["before"][name])


@pytest.mark.parametrize("kind", ["DINO", "RSCoTrSeg"])
def test_task_masks_skip_a_standalone_encoder_in_both(kind):
    """ROADMAP C6: the masks pick parameters by top-level name, and the
    standalone models name their encoder ``encoder``, which no task lists:
    a masked step never trains it, in either package."""
    cfg, _ = _tiny(kind)
    model = build_model(cfg["model"], device="meta")
    names = [n for n, _ in model.named_parameters()]
    masks = task_param_masks(names)
    shapes = jax.eval_shape(
        lambda k: jax_build_model(cfg["model"]).init(
            k, jnp.zeros((1, 64, 64, 3)),
            *([jnp.array([[64, 64]], jnp.int32)] if kind == "DINO" else [])),
        jax.random.key(0))
    jmasks = jax_task_param_masks(shapes["params"])
    task = "det" if kind == "DINO" else "seg"
    enc = [n for n in names if n.startswith("encoder.")]
    assert enc and all(masks[task][n] == 0.0 for n in enc)
    assert all(float(v) == 0.0 for v in
               jax.tree.leaves(jmasks[task]["encoder"]))
    head = "bbox_head" if kind == "DINO" else "seg_head"
    assert all(masks[task][n] == 1.0 for n in names
               if n.startswith(head + "."))
    assert all(float(v) == 1.0 for v in jax.tree.leaves(jmasks[task][head]))


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_dropout_structure():
    x = torch.ones(1000, 1000)
    d = Dropout(0.3).train()
    y = d(x, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, d(x, torch.Generator().manual_seed(5)))
    assert not torch.equal(y, d(x, torch.Generator().manual_seed(6)))
    assert d.eval()(x) is x
    assert Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="Generator"):
        d.train()(x)


def _train_twice(module, *args, **kw):
    """Train-mode outputs for seeds 0, 0 and 1, and the eval output."""
    module.train()
    outs = [module(*args, generator=torch.Generator().manual_seed(s), **kw)
            for s in (0, 0, 1)]
    module.eval()
    return outs, module(*args, **kw)


def test_modules_run_their_dropout_rates():
    """The rates the port runs: the FFN's ``drop`` and Swin's
    ``drop_rate`` (patch embedding, window-attention output, FFN)."""
    torch.manual_seed(0)
    q = torch.randn(2, 6, 32)
    ffn = FFN(32, 64, drop=0.2)
    model = swin.SwinTransformer(embed_dims=16, depths=(2, 2),
                                 num_heads=(2, 2), out_indices=(0, 1),
                                 drop_rate=0.2)
    plain = swin.SwinTransformer(embed_dims=16, depths=(2, 2),
                                 num_heads=(2, 2), out_indices=(0, 1))
    init_weights(plain, torch.Generator().manual_seed(0))
    model.load_state_dict(plain.state_dict())
    for p in ffn.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(1, 64, 64, 3)
    (a, b, c), ev = _train_twice(ffn, q)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev)
    (a, b, c), ev = _train_twice(model, x)
    assert torch.equal(a[-1], b[-1]) and not torch.equal(a[-1], c[-1])
    for g, w in zip(ev, plain.eval()(x)):  # eval: dropout is the identity
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _set_swin_attn_drop(m):
    m["backbone"]["attn_drop_rate"] = 0.1


def _set_encoder_dropout(m):
    m["shared_encoder"]["transformerlayers"]["attn_cfgs"]["dropout"] = 0.1


def _set_encoder_ffn_drop(m):
    m["shared_encoder"]["transformerlayers"]["ffn_cfgs"]["ffn_drop"] = 0.1


def _set_decoder_dropout(m):
    layers = m["bbox_head"]["transformer"]["decoder"]["transformerlayers"]
    attn = layers["attn_cfgs"]
    for a in (attn if isinstance(attn, (list, tuple)) else [attn]):
        a["dropout"] = 0.1


@pytest.mark.parametrize("setter,rate", [
    (_set_swin_attn_drop, "attn_drop_rate"),
    (_set_encoder_dropout, "dropout"),
    (_set_encoder_ffn_drop, "ffn_drop"),
    (_set_decoder_dropout, "dropout"),
])
def test_build_model_refuses_dropout_rates(setter, rate):
    """No config sets these rates, and the kernels (Swin's K2 / K2b) and
    the transformer layers run no dropout: a non-zero rate is refused, not
    run some other way. Swin's ``drop_rate`` is taken."""
    cfg = load_cfg(TINY)
    m = cfg["model"]
    m["backbone"]["drop_rate"] = 0.1
    assert build_model(m, device="meta").backbone.drop.rate == 0.1
    setter(m)
    with pytest.raises(NotImplementedError, match=rate):
        build_model(m, device="meta")


# ---------------------------------------------------------------------------
# full-width configs on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FULL))
def test_full_config_meta_keys_and_shapes_match_jax(name):
    cfg = load_cfg(os.path.join(ROOT, FULL[name]))
    m = cfg["model"]
    jm = jax_build_model(m)
    t = m.get("type", "MTL")

    def init(k):
        if t == "RSCoTrSeg":
            return jm.init(k, jnp.zeros((1, 128, 128, 3)))
        kw = {}
        if m.get("cls_head"):
            kw["cls_img"] = jnp.zeros((1, 224, 224, 3))
        if m.get("bbox_head"):
            kw.update(det_img=jnp.zeros((1, 256, 256, 3)),
                      det_img_hw=jnp.array([[256, 256]], jnp.int32))
        if m.get("seg_head"):
            kw["seg_img"] = jnp.zeros((1, 128, 128, 3))
        return jm.init(k, **kw)

    shapes = jax.eval_shape(init, jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros["params"], zeros.get("batch_stats"))
    model = build_model(m, device="meta", cls_hw=derive_cls_hw(cfg))
    msd = model.state_dict()
    assert type(model).__name__ == t
    assert set(msd) == set(sd)
    assert {k: tuple(v.shape) for k, v in msd.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
