"""Build modules from configs (PyTorch counterpart of
rscotr_tpu/models/build.py).

Reads the same reference-shaped ``cfg.model`` dicts and ``type`` names and
builds the model types ``MTL``, ``DINO`` and ``RSCoTrSeg``; a head whose
task is left out of ``tasks`` is not built (MTL only).

Dropout rates follow JAX's build exactly (ROADMAP C18): Swin's
``drop_rate``, ``attn_drop_rate`` and ``drop_path_rate`` and the shared
encoder's ``attn_cfgs.dropout`` and ``ffn_cfgs.ffn_drop`` run in training
mode, at JAX's sites; the DINO decoder's and the Mask2Former head's rates
are accepted and dropped, as rscotr_tpu/models/build.py drops them.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch

from rscotr_tpu_torch.models.backbones.resnet import ResNet
from rscotr_tpu_torch.models.backbones.swin import SwinTransformer
from rscotr_tpu_torch.models.dino import DINO
from rscotr_tpu_torch.models.heads.cls_heads import MlvlClsHead, SlvlClsHead
from rscotr_tpu_torch.models.heads.dino_head import DINOHead
from rscotr_tpu_torch.models.heads.mask2former_head import Mask2FormerHead
from rscotr_tpu_torch.models.layers.common import init_weights
from rscotr_tpu_torch.models.layers.transformer import DeformableEncoder
from rscotr_tpu_torch.models.mtl import MTL
from rscotr_tpu_torch.models.necks.channel_mapper import ChannelMapper
from rscotr_tpu_torch.models.rscotr_seg import RSCoTrSeg

_HEAD_KEYS = {"cls": "cls_head", "det": "bbox_head", "seg": "seg_head"}


def _pop_type(cfg: dict):
    cfg = copy.deepcopy(dict(cfg))
    return cfg.pop("type"), cfg


def build_backbone(cfg: dict, dtype, device):
    t, c = _pop_type(cfg)
    if t == "SwinTransformer":
        return SwinTransformer(
            embed_dims=c.get("embed_dims", 96),
            depths=tuple(c.get("depths", (2, 2, 6, 2))),
            num_heads=tuple(c.get("num_heads", (3, 6, 12, 24))),
            window_size=c.get("window_size", 7),
            mlp_ratio=c.get("mlp_ratio", 4),
            qkv_bias=c.get("qkv_bias", True),
            qk_scale=c.get("qk_scale", None),
            drop_rate=c.get("drop_rate", 0.0),
            attn_drop_rate=c.get("attn_drop_rate", 0.0),
            drop_path_rate=c.get("drop_path_rate", 0.2),
            patch_norm=c.get("patch_norm", True),
            out_indices=tuple(c.get("out_indices", (0, 1, 2, 3))),
            with_cp=bool(c.get("with_cp", False)), dtype=dtype,
            device=device)
    if t == "ResNet":
        return ResNet(depth=c.get("depth", 50),
                      num_stages=c.get("num_stages", 4),
                      out_indices=tuple(c.get("out_indices", (0, 1, 2, 3))),
                      frozen_stages=c.get("frozen_stages", 1),
                      norm_eval=c.get("norm_eval", True),
                      dtype=dtype, device=device)
    raise KeyError(f"unknown backbone type {t}")


def build_neck(cfg: Optional[dict], dtype, device):
    if cfg is None:
        return None
    t, c = _pop_type(cfg)
    if t != "ChannelMapper":
        raise KeyError(f"unknown neck type {t}")
    return ChannelMapper(
        in_channels=tuple(c["in_channels"]),
        out_channels=c.get("out_channels", 256),
        kernel_size=c.get("kernel_size", 1),
        num_outs=c.get("num_outs", 4),
        use_norm=c.get("norm_cfg") is not None,
        norm_groups=(c.get("norm_cfg") or {}).get("num_groups", 32),
        act="relu" if c.get("act_cfg") else None,
        dtype=dtype, device=device)


def build_shared_encoder(cfg: dict, dtype, device):
    t, c = _pop_type(cfg)
    if t != "DetrTransformerEncoder":
        raise KeyError(f"unknown encoder type {t}")
    layers = c.get("transformerlayers", {})
    attn = layers.get("attn_cfgs", {})
    ffn = layers.get("ffn_cfgs", {})
    return DeformableEncoder(
        num_layers=c.get("num_layers", 6),
        embed_dims=attn.get("embed_dims", 256),
        num_heads=attn.get("num_heads", 8),
        num_levels=attn.get("num_levels", 4),
        num_points=attn.get("num_points", 4),
        feedforward_channels=ffn.get("feedforward_channels", 2048),
        ffn_drop=ffn.get("ffn_drop", 0.0), dropout=attn.get("dropout", 0.0),
        with_cp=bool(c.get("with_cp", False)), dtype=dtype, device=device)


def build_cls_head(cfg: dict, dtype, device, token_counts=None):
    """``token_counts``: h * w of each encoder level (low -> high
    resolution) at the cls input size, for an ``MlvlClsHead``."""
    t, c = _pop_type(cfg)
    if t == "SlvlClsHead":
        return SlvlClsHead(num_classes=c.get("num_classes", 45),
                           in_channels=c.get("in_channels", 768),
                           dtype=dtype, device=device)
    if t == "MlvlClsHead":
        pd = c.get("pixel_decoder", {}) or {}
        return MlvlClsHead(num_classes=c.get("num_classes", 45),
                           scheme=c.get("scheme", 5),
                           num_encoder_levels=pd.get("num_encoder_levels", 4),
                           strides=tuple(pd.get("strides", (8, 16, 32, 64))),
                           feat_channels=pd.get("feat_channels", 256),
                           token_counts=token_counts, dtype=dtype,
                           device=device)
    raise KeyError(f"unknown cls head type {t}")


def build_bbox_head(cfg: dict, dtype, device):
    t, c = _pop_type(cfg)
    if t != "DINOHead":
        raise KeyError(f"unknown bbox head type {t}")
    decoder = c.get("transformer", {}).get("decoder", {})
    dec_layers = decoder.get("transformerlayers", {})
    attn_cfgs = dec_layers.get("attn_cfgs", [{}, {}])
    if not isinstance(attn_cfgs, (list, tuple)):
        attn_cfgs = [attn_cfgs, attn_cfgs]
    msda = attn_cfgs[1]
    # as in rscotr_tpu: the decoder runs no dropout, whatever the config
    # (ROADMAP C18)
    return DINOHead(
        num_classes=c.get("num_classes", 20),
        num_query=c.get("num_query", 600),
        embed_dims=msda.get("embed_dims", 256),
        num_decoder_layers=decoder.get("num_layers", 6),
        num_feature_levels=c.get("num_feature_levels", 4),
        num_heads=8,   # as in rscotr_tpu: the decoder always runs 8 heads
        num_points=msda.get("num_points", 4),
        feedforward_channels=dec_layers.get("ffn_cfgs", {}).get(
            "feedforward_channels", 2048),
        pos_temperature=c.get("positional_encoding", {}).get(
            "temperature", 20),
        dtype=dtype, device=device)


def build_seg_head(cfg: dict, dtype, device, input_convs: bool = False):
    """``scheme`` 1 or 2 (the paper's heads) or 3 (Mask2Former's mask
    classification and semantic inference)."""
    t, c = _pop_type(cfg)
    if t != "Mask2FormerHead":
        raise KeyError(f"unknown seg head type {t}")
    td = c.get("transformer_decoder", {})
    tl = td.get("transformerlayers", {})
    attn = tl.get("attn_cfgs", {})
    ffn = tl.get("ffn_cfgs", {})
    # as in rscotr_tpu: the seg head runs no dropout, whatever the config
    # (ROADMAP C18)
    return Mask2FormerHead(
        in_channels=tuple(c.get("in_channels", (96, 192, 384, 768))),
        feat_channels=c.get("feat_channels", 256),
        out_channels=c.get("out_channels", 256),
        num_classes=c.get("num_classes", 5),
        num_queries=c.get("num_queries", 100),
        num_transformer_feat_level=c.get("num_transformer_feat_level", 4),
        scheme=c.get("scheme", 1),
        num_heads=attn.get("num_heads", 8),
        num_decoder_layers=td.get("num_layers", 9),
        feedforward_channels=ffn.get("feedforward_channels", 2048),
        pos_temperature=c.get("positional_encoding", {}).get(
            "temperature", 10000),
        pixel_decoder_input_convs=input_convs, dtype=dtype, device=device)


def _token_counts(cls_cfg, backbone, neck, neck_in_levels, cls_hw):
    """h * w of each encoder level (low -> high resolution) of an
    ``MlvlClsHead`` at the cls input size; None when there is no size."""
    if not cls_cfg or cls_cfg.get("type") != "MlvlClsHead" or cls_hw is None:
        return None
    if isinstance(cls_hw, int):
        cls_hw = (cls_hw, cls_hw)
    hw = backbone.out_hw(cls_hw)
    if neck is not None:
        hw = neck.out_hw(hw[len(hw) - neck_in_levels:])
    L = (cls_cfg.get("pixel_decoder", {}) or {}).get("num_encoder_levels", 4)
    return [h * w for h, w in reversed(hw)][:L]


def build_model(cfg: dict, tasks: Optional[Sequence[str]] = None,
                device="cuda", generator: Optional[torch.Generator] = None,
                cls_hw: Optional[Tuple[int, int]] = None):
    """Build a model (``MTL``, ``DINO`` or ``RSCoTrSeg``) from a
    reference-shaped model config, in eval mode, with weights initialised
    from ``generator`` (seed 0 when None; nothing is initialised on the
    ``meta`` device).

    ``device``: where the model is built, the card by default. Without a
    CUDA device a CUDA build raises; pass ``device="cpu"`` to build on the
    CPU, as the tests do: nothing is built there unasked.

    ``tasks``: the task heads of an MTL to build (default: every head the
    config has); the single-task types build their one head.
    ``cfg['compute_dtype'] = 'bfloat16'`` runs linears and convs in bf16
    with float32 params, norms and task outputs.

    ``cls_hw``: the cls input size (H, W), or one int for a square. An
    ``MlvlClsHead`` of scheme 5, 6 or 7 sizes its ``out_proj`` from the
    token count at that size, as flax does at init from the cls input
    (``apis.derive_cls_hw`` reads it from a composed config's data section,
    as the JAX package's ``derive_shapes`` does); such a head raises without
    it. Other parts ignore it.
    """
    cfg = copy.deepcopy(dict(cfg))
    t = cfg.get("type", "MTL")
    if t not in ("MTL", "DINO", "RSCoTrSeg"):
        raise KeyError(f"unknown model type {t}")
    dtype = {None: torch.float32, "float32": torch.float32,
             "bfloat16": torch.bfloat16}[cfg.get("compute_dtype")]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"build_model: no CUDA device for device={str(device)!r} (the "
            "default is the card); pass device=\"cpu\" to build on the CPU")
    backbone = build_backbone(cfg["backbone"], dtype, device)
    neck_cfg = cfg.get("neck")
    neck = build_neck(neck_cfg, dtype, device)
    neck_in_levels = len(neck_cfg["in_channels"]) if neck_cfg else 0
    if t == "MTL":
        if tasks is None:
            tasks = tuple(k for k, key in _HEAD_KEYS.items() if cfg.get(key))
        unknown = set(tasks) - set(_HEAD_KEYS)
        if unknown:
            raise ValueError(f"unknown tasks {sorted(unknown)}")
        counts = _token_counts(cfg.get("cls_head"), backbone, neck,
                               neck_in_levels, cls_hw)
        model = MTL(
            backbone=backbone, neck=neck,
            shared_encoder=build_shared_encoder(cfg["shared_encoder"], dtype,
                                                device),
            cls_head=(build_cls_head(cfg["cls_head"], dtype, device, counts)
                      if "cls" in tasks else None),
            bbox_head=(build_bbox_head(cfg["bbox_head"], dtype, device)
                       if "det" in tasks else None),
            seg_head=(build_seg_head(cfg["seg_head"], dtype, device)
                      if "seg" in tasks else None),
            neck_in_levels=neck_in_levels)
    else:
        encoder = build_shared_encoder(
            cfg.get("encoder") or cfg.get("shared_encoder"), dtype, device)
        if t == "DINO":
            model = DINO(backbone=backbone, neck=neck,
                         bbox_head=build_bbox_head(cfg["bbox_head"], dtype,
                                                   device),
                         encoder=encoder, neck_in_levels=neck_in_levels)
        else:
            model = RSCoTrSeg(
                backbone=backbone,
                seg_head=build_seg_head(
                    cfg.get("seg_head") or cfg.get("decode_head"), dtype,
                    device, input_convs=True),
                encoder=encoder)
    if device.type != "meta":
        init_weights(model, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    return model.eval()
