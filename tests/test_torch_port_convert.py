"""The port's weight bridge, parameter layout and initialisation.

* ``state_dict_from_jax`` equals the JAX package's
  ``reverse_mtl_checkpoint`` key for key and bit for bit (tiny config, all
  three heads) and the port's MTL loads it with ``strict=True``.
* At full width, the flagship port built on the ``meta`` device has exactly
  the keys and shapes of ``state_dict_from_jax`` applied to the flagship's
  JAX parameter shapes (``jax.eval_shape`` of its init; parameters do not
  depend on the image size, so small images suffice).
* The port's own init (``torch.Generator``) reproduces flax's initialisers:
  constant parameters exactly, random ones in distribution.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu.config import Config
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu.utils.torch_convert import reverse_mtl_checkpoint
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_model_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
FLAGSHIP = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")


def jax_init(model, det_hw=128):
    return lambda key: model.init(
        key, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, det_hw, det_hw, 3)),
        det_img_hw=jnp.array([[det_hw, det_hw]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3)))


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = load_model_cfg(TINY)
    params = jax.jit(jax_init(jax_build_model(cfg)))(jax.random.key(0))
    return cfg, jax.tree.map(lambda x: np.asarray(x).copy(),
                             params["params"])


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(_plain(v) for v in o)
    return o


@pytest.mark.parametrize("path", [TINY, FLAGSHIP],
                         ids=["tiny", "flagship"])
def test_model_cfg_reader_matches_config_loader(path):
    assert load_model_cfg(path) == _plain(Config.fromfile(path).model)


def test_state_dict_equals_reverse_converter(tiny_tree):
    cfg, tree = tiny_tree
    want = reverse_mtl_checkpoint(tree,
                                  depths=tuple(cfg["backbone"]["depths"]))
    got = state_dict_from_jax(tree)
    assert set(got) == set(want)
    # Mask2Former: cross-attention under attentions.0, self under .1
    assert "seg_head.transformer_decoder.layers.2.attentions.1.attn." \
        "in_proj_weight" in got
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_tiny_mtl_loads_strict(tiny_tree):
    cfg, tree = tiny_tree
    model = build_model(cfg, device="cpu")
    sd = state_dict_from_jax(tree)
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_flagship_meta_keys_and_shapes():
    cfg = load_model_cfg(FLAGSHIP)
    shapes = jax.eval_shape(jax_init(jax_build_model(cfg), det_hw=256),
                            jax.random.key(0))
    sd = state_dict_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]))
    model = build_model(cfg, device="meta")
    msd = model.state_dict()
    assert set(msd) == set(sd)
    assert {k: tuple(v.shape) for k, v in msd.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(v.numel() for v in sd.values()) == 62_552_719


def test_build_refuses_unported_parts():
    """Every part and model type of ``configs/`` is ported: RSCoTrSeg,
    MlvlClsHead and ResNet build; a type the JAX package does not know is
    refused, as JAX's builder refuses it."""
    cfg = load_model_cfg(TINY)
    seg = build_model(dict(cfg, type="RSCoTrSeg", encoder=dict(
        cfg["shared_encoder"], transformerlayers=dict(
            cfg["shared_encoder"]["transformerlayers"], attn_cfgs=dict(
                cfg["shared_encoder"]["transformerlayers"]["attn_cfgs"],
                num_levels=3))),
        seg_head=dict(cfg["seg_head"], num_transformer_feat_level=3)),
        device="meta")
    assert type(seg).__name__ == "RSCoTrSeg"
    assert seg.seg_head.pixel_decoder.input_convs is not None
    mlvl = dict(cfg, cls_head=dict(type="MlvlClsHead", num_classes=45,
                                   scheme=1, pixel_decoder=dict(
                                       feat_channels=64)))
    assert build_model(mlvl, tasks=("cls", "det"), device="meta"
                       ).cls_head.out_proj is None
    resnet = dict(cfg, backbone=dict(type="ResNet", depth=50),
                  neck=dict(cfg["neck"], in_channels=[512, 1024, 2048]))
    assert build_model(resnet, tasks=("cls", "det"), device="meta"
                       ).backbone.layer4[2].conv3.weight.shape[0] == 2048
    with pytest.raises(KeyError, match="unknown model type"):
        build_model(dict(cfg, type="MaskRCNN"), device="meta")
    with pytest.raises(KeyError, match="unknown backbone type"):
        build_model(dict(cfg, backbone=dict(type="ViT")), device="meta")
    assert build_model(cfg, device="meta").seg_head is not None
    det_only = build_model(cfg, tasks=("det",), device="meta")
    assert det_only.cls_head is None and det_only.bbox_head is not None


def test_init_matches_flax_initialisers(tiny_tree):
    """Constant leaves (zeros, ones, prior bias, rotational offset grid)
    equal; random leaves of >= 1000 values have the flax std within 10%
    and zero mean within 0.1 std."""
    cfg, tree = tiny_tree
    want = state_dict_from_jax(tree)
    got = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1)
                      ).state_dict()
    n_random = 0
    for k, w in want.items():
        g = got[k]
        if torch.all(w == w.flatten()[0]) or "sampling_offsets.bias" in k:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6,
                                       msg=k)
        elif w.numel() >= 1000:
            n_random += 1
            ratio = (g.std() / w.std()).item()
            assert 0.9 < ratio < 1.1, (k, ratio)
            assert abs(g.mean().item()) < 0.1 * w.std().item(), k
    assert n_random > 50
