"""Seg serving of the port against the JAX package (CPU, float32, JAX under
highest matmul precision), with the same weights (``state_dict_from_jax``)
and the same numpy-seeded inputs:

* cross-attention with a (B*heads, Nq, Nk) mask (one row all masked), and
  ``MaskedAttentionDecoderLayer``;
* ``MlvlSegPixelDecoder`` with 4 encoder levels, with 3 (the FPN branch)
  and with 3 plus input convs, through the same plain ``encode_fn``;
* ``Mask2FormerHead``, schemes 1 and 2;
* the tiny config's ``seg_logits`` / ``seg`` through both
  ``make_infer_steps``, whole and slide (one window = whole; two
  overlapping windows);
* the logits resize against ``jax.image.resize(method="linear")``, up and
  down;
* the flagship's seg keys and shapes on ``meta``, against
  ``reverse_mtl_checkpoint`` as well.

Tolerances: layers 1e-5, heads and logits 1e-4 relative + 1e-4 absolute
(float32; sums in another order). The attention mask is a threshold on
resized mask logits, so a logit within the error of 0 would flip a bit: for
the chosen seeds the tests assert that JAX's smallest |logit| entering any
threshold exceeds 10x the tolerance. Labels must equal JAX's wherever its
top-two logits are more than 10x the tolerance apart (at most 1% of the
pixels are closer, and there either label is right).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
from rscotr_tpu.engine.train_step import device_normalize as jax_normalize
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu.models.heads import mask2former_head as jm2f
from rscotr_tpu.models.heads import pixel_decoders as jpd
from rscotr_tpu.models.layers import attention as jattn
from rscotr_tpu.models.layers import transformer as jtr
from rscotr_tpu.utils.torch_convert import reverse_mtl_checkpoint
from rscotr_tpu_torch.engine import make_infer_steps
from rscotr_tpu_torch.engine.infer import resize_linear
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.models.heads.mask2former_head import Mask2FormerHead
from rscotr_tpu_torch.models.heads.pixel_decoders import MlvlSegPixelDecoder
from rscotr_tpu_torch.models.layers.attention import MultiheadAttention
from rscotr_tpu_torch.models.layers.transformer import \
    MaskedAttentionDecoderLayer
from rscotr_tpu_torch.utils import convert
from rscotr_tpu_torch.utils.config import load_model_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
FLAGSHIP = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")
LAYER_TOL = 1e-5
SEG_TOL = 1e-4
HIGHEST = jax.default_matmul_precision("highest")


def tnp(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def jax_encode(tokens, pos, ref, shapes, key_padding_mask=None,
               deterministic=True):
    """A plain stand-in for the shared encoder, the same in both stacks."""
    return tokens * 0.5 + pos * 0.25 + ref[:, :, 0, :1]


def torch_encode(tokens, pos, ref, shapes):
    return tokens * 0.5 + pos * 0.25 + ref[:, :, 0, :1]


def _intermediates(tree, name):
    """Outputs of the submodule ``name`` recorded by capture_intermediates,
    wherever it sits in the tree."""
    if name in tree:
        return tree[name]["__call__"]
    for sub in tree.values():
        if isinstance(sub, dict):
            found = _intermediates(sub, name)
            if found is not None:
                return found
    return None


def jax_mask_logit_margin(intermediates, num_layers, L):
    """JAX's smallest |resized mask logit| entering the attention-mask
    threshold of any decoder layer."""
    mask_feature, ms = _intermediates(intermediates, "pixel_decoder")[0]
    mes = _intermediates(intermediates, "mask_embed")
    margin = np.inf
    with HIGHEST:
        for j in range(num_layers):
            mp = jnp.einsum("bqc,bhwc->bqhw", mes[j], mask_feature)
            am = jpd._resize_bilinear(mp.transpose(0, 2, 3, 1),
                                      ms[j % L].shape[1:3])
            margin = min(margin, float(jnp.abs(am).min()))
    return margin


CAPTURE = dict(capture_intermediates=lambda mdl, _: mdl.name in (
    "mask_embed", "pixel_decoder"), mutable=["intermediates"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_cross_attention_vs_jax():
    rng = np.random.default_rng(0)
    B, Nq, Nk, C, H = 2, 5, 12, 32, 4
    q, qpos = (rng.normal(size=(B, Nq, C)).astype(np.float32)
               for _ in range(2))
    key, kpos = (rng.normal(size=(B, Nk, C)).astype(np.float32)
                 for _ in range(2))
    mask = rng.uniform(size=(B * H, Nq, Nk)) < 0.5
    mask[1, 2] = True                     # all masked: uniform fallback
    jm = jattn.MultiheadAttention(embed_dims=C, num_heads=H)
    args = dict(query=jnp.asarray(q), key=jnp.asarray(key),
                value=jnp.asarray(key), query_pos=jnp.asarray(qpos),
                key_pos=jnp.asarray(kpos), attn_mask=jnp.asarray(mask))
    params = jax.jit(lambda k: jm.init(k, **args))(jax.random.key(0))
    with HIGHEST:
        want = jax.jit(lambda p: jm.apply(p, **args))(params)
    sd = {}
    convert._mha(sd, "attn", tnp(params["params"]))
    m = load(MultiheadAttention(C, H), sd)
    got = m(query=torch.from_numpy(q), key=torch.from_numpy(key),
            value=torch.from_numpy(key), query_pos=torch.from_numpy(qpos),
            key_pos=torch.from_numpy(kpos),
            attn_mask=torch.from_numpy(mask))
    assert got.shape == (B, Nq, C)
    close(got.detach().numpy(), want, LAYER_TOL)


def test_masked_attention_decoder_layer_vs_jax():
    rng = np.random.default_rng(1)
    B, Nq, Nk, C, H = 2, 6, 20, 32, 4
    x, qpos = (rng.normal(size=(B, Nq, C)).astype(np.float32)
               for _ in range(2))
    mem, kpos = (rng.normal(size=(B, Nk, C)).astype(np.float32)
                 for _ in range(2))
    mask = rng.uniform(size=(B * H, Nq, Nk)) < 0.3
    jm = jtr.MaskedAttentionDecoderLayer(embed_dims=C, num_heads=H,
                                         feedforward_channels=64)
    jargs = [jnp.asarray(a) for a in (x, mem, qpos, kpos)]
    params = jax.jit(lambda k: jm.init(
        k, *jargs, cross_attn_mask=jnp.asarray(mask)))(jax.random.key(1))
    with HIGHEST:
        want = jax.jit(lambda p: jm.apply(
            p, *jargs, cross_attn_mask=jnp.asarray(mask)))(params)
    tree = tnp(params["params"])
    sd = {}
    convert._mha(sd, "attentions.0.attn", tree["cross_attn"])
    convert._mha(sd, "attentions.1.attn", tree["self_attn"])
    convert._ffn(sd, "ffns.0", tree["ffn"])
    for n in range(3):
        convert._ln(sd, f"norms.{n}", tree[f"norm{n + 1}"])
    m = load(MaskedAttentionDecoderLayer(C, H, 64), sd)
    got = m(*(torch.from_numpy(a) for a in (x, mem, qpos, kpos)),
            cross_attn_mask=torch.from_numpy(mask))
    close(got.detach().numpy(), want, LAYER_TOL)


def seg_feats(rng, B=2, C=32, in_channels=(8, 16, 24, 40), hw=32):
    """Backbone maps at strides 4..32 and neck maps at strides 8..64 of a
    (hw * 4)^2 image, NHWC float32."""
    bb = [rng.normal(size=(B, hw >> i, hw >> i, c)).astype(np.float32)
          for i, c in enumerate(in_channels)]
    nk = [rng.normal(size=(B, hw >> (i + 1), hw >> (i + 1), C)).astype(
        np.float32) for i in range(4)]
    return bb, nk


@pytest.mark.parametrize("L,input_convs", [(4, False), (3, False),
                                           (3, True)])
def test_pixel_decoder_vs_jax(L, input_convs):
    rng = np.random.default_rng(2)
    in_ch = (8, 16, 24, 40)
    bb, nk = seg_feats(rng, in_channels=in_ch, hw=16)
    if input_convs:
        nk = bb     # the standalone variant projects raw backbone levels
    jm = jpd.MlvlSegPixelDecoder(num_encoder_levels=L, in_channels=in_ch,
                                 feat_channels=32, out_channels=32,
                                 num_outs=L, use_input_convs=input_convs)
    jnk, jbb = [jnp.asarray(a) for a in nk], [jnp.asarray(a) for a in bb]
    params = jax.jit(lambda k: jm.init(k, jax_encode, jnk, jbb))(
        jax.random.key(2))
    with HIGHEST:
        jmask, jms = jax.jit(lambda p: jm.apply(p, jax_encode, jnk, jbb))(
            params)
    m = load(MlvlSegPixelDecoder(L, in_ch, feat_channels=32,
                                 out_channels=32, num_outs=L,
                                 use_input_convs=input_convs),
             convert._seg_pixel_decoder(tnp(params["params"]), ""))
    mask, ms = m(torch_encode, [torch.from_numpy(a) for a in nk],
                 [torch.from_numpy(a) for a in bb])
    assert mask.shape == jmask.shape and len(ms) == len(jms) == L
    close(mask.detach().numpy(), jmask, SEG_TOL)
    for a, b in zip(ms, jms):
        close(a.detach().numpy(), b, SEG_TOL)


@pytest.mark.parametrize("scheme", [1, 2])
def test_mask2former_head_vs_jax(scheme):
    rng = np.random.default_rng(3)
    in_ch = (8, 16, 24, 40)
    bb, nk = seg_feats(rng, in_channels=in_ch, hw=16)
    kw = dict(feat_channels=32, out_channels=32, num_classes=5,
              num_queries=10, scheme=scheme, num_heads=4,
              num_decoder_layers=3, feedforward_channels=64)
    jm = jm2f.Mask2FormerHead(in_channels=in_ch, **kw)
    jnk, jbb = [jnp.asarray(a) for a in nk], [jnp.asarray(a) for a in bb]
    params = jax.jit(lambda k: jm.init(k, jnk, jbb, jax_encode))(
        jax.random.key(3))
    with HIGHEST:
        want, state = jax.jit(lambda p: jm.apply(p, jnk, jbb, jax_encode,
                                                 **CAPTURE))(params)
    margin = jax_mask_logit_margin(state["intermediates"], 3, 4)
    assert margin > 10 * SEG_TOL, margin
    m = load(Mask2FormerHead(in_channels=in_ch, **kw),
             convert._mask2former_head(tnp(params["params"]), ""))
    got = m([torch.from_numpy(a) for a in nk],
            [torch.from_numpy(a) for a in bb], torch_encode)
    assert got.shape == want.shape == (2, 8, 8, 6 if scheme == 1 else 10)
    close(got.detach().numpy(), want, SEG_TOL)


# ---------------------------------------------------------------------------
# the tiny config's seg serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_models():
    cfg = load_model_cfg(TINY)
    jm = jax_build_model(cfg)
    params = jax.jit(lambda k: jm.init(
        k, seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    model = build_model(cfg, tasks=("seg",), device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(tnp(params["params"])),
                          strict=True)
    return cfg, jm, params, model


def _seg_imgs():
    """A 2 x 64^2 batch (whole) and a 1 x 64 x 96 one (slide: two 64^2
    windows at stride 32). Seed 4: JAX's threshold margins are 4.3e-3 and
    4.2e-3 (>= 10x SEG_TOL)."""
    rng = np.random.default_rng(4)
    return (rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            rng.integers(0, 256, (1, 64, 96, 3)).astype(np.uint8))


def _check_margin(cfg, jm, params, imgs):
    """JAX's margin at every attention-mask threshold, over the forwards of
    ``imgs`` (normalized uint8 batches)."""
    hd = cfg["seg_head"]
    run = jax.jit(lambda p, x: jm.apply(p, x, method=jm.forward_seg,
                                        **CAPTURE)[1])
    for img in imgs:
        with HIGHEST:
            state = run(params, jax_normalize(jnp.asarray(img), None))
        margin = jax_mask_logit_margin(
            state["intermediates"],
            hd["transformer_decoder"]["num_layers"],
            hd["num_transformer_feat_level"])
        assert margin > 10 * SEG_TOL, margin


def _check_labels(labels, logits):
    """Labels equal JAX's argmax wherever its top two logits are more than
    10x the tolerance apart."""
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 10 * SEG_TOL
    assert clear.mean() > 0.99, clear.mean()
    np.testing.assert_array_equal(labels.numpy()[clear],
                                  logits.argmax(-1)[clear])


def test_tiny_seg_whole_matches_jax(seg_models):
    cfg, jm, params, model = seg_models
    img = _seg_imgs()[0]
    _check_margin(cfg, jm, params, [img])
    with HIGHEST:
        want = np.asarray(jax_make_infer_steps(jm)["seg_logits"](
            params, jnp.asarray(img)))
    steps = make_infer_steps(model, seg_test_cfg=cfg["test_cfg"]["seg"])
    got = steps["seg_logits"](img)
    assert got.shape == want.shape == (2, 64, 64, 16)
    assert got.dtype == torch.float32
    close(got.numpy(), want, SEG_TOL)
    labels = steps["seg"](img)
    assert labels.shape == (2, 64, 64)
    _check_labels(labels, want)
    # one window covering the image is the whole-image path
    slide1 = make_infer_steps(model, seg_test_cfg=dict(
        mode="slide", crop_size=(64, 64), stride=(64, 64)))
    assert torch.equal(slide1["seg_logits"](img), got)


def test_tiny_seg_slide_matches_jax(seg_models):
    cfg, jm, params, model = seg_models
    img = _seg_imgs()[1]
    stc = dict(mode="slide", crop_size=(64, 64), stride=(32, 32))
    _check_margin(cfg, jm, params, [img[:, :, x:x + 64] for x in (0, 32)])
    with HIGHEST:
        want = np.asarray(jax_make_infer_steps(jm, seg_test_cfg=stc)[
            "seg_logits"](params, jnp.asarray(img)))
    steps = make_infer_steps(model, seg_test_cfg=stc)
    got = steps["seg_logits"](img)
    close(got.numpy(), want, SEG_TOL)
    _check_labels(steps["seg"](img), want)
    with pytest.raises(ValueError, match="crop_size"):
        steps["seg"](img[:, :60])


@pytest.mark.parametrize("src,dst", [((5, 7), (40, 56)), ((4, 6), (13, 9))])
def test_upsample_logits_equals_jax_image_resize(src, dst):
    x = np.random.default_rng(4).normal(size=(2,) + src + (3,)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,),
                            method="linear")
    got = resize_linear(torch.from_numpy(x), dst)
    close(got.numpy(), want, 1e-6)
    # a shrink takes jax.image.resize's antialiased weights too
    small = (src[0] - 1, src[1])
    want = jax.image.resize(jnp.asarray(x), (2,) + small + (3,),
                            method="linear")
    close(resize_linear(torch.from_numpy(x), small).numpy(), want, 1e-6)


def test_flagship_seg_keys_and_shapes_on_meta():
    cfg = load_model_cfg(FLAGSHIP)
    jm = jax_build_model(cfg)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, seg_img=jnp.zeros((1, 64, 64, 3))), jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes["params"])
    sd = convert.state_dict_from_jax(zeros)
    want = reverse_mtl_checkpoint(zeros,
                                  depths=tuple(cfg["backbone"]["depths"]))
    model = build_model(cfg, tasks=("seg",), device="meta")
    msd = model.state_dict()
    assert set(sd) == set(want)
    assert {k: tuple(v.shape) for k, v in msd.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    seg = [k for k in sd if k.startswith("seg_head.")]
    assert len(model.seg_head.transformer_decoder.layers) == 9
    assert tuple(sd["seg_head.query_feat.weight"].shape) == (100, 256)
    assert sum(sd[k].numel() for k in seg) > 0
