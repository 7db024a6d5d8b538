"""The pixel decoders that route neck features through the SHARED encoder
(PyTorch counterpart of rscotr_tpu/models/heads/pixel_decoders.py:
``_flatten_levels_for_encoder``, ``_split_levels``, ``MlvlClsPixelDecoder``,
``MlvlSegPixelDecoder``, ``_resize_bilinear``).

Encoder levels are taken from the LAST (lowest-resolution) neck level on, so
tokens run low -> high resolution; each level gets the sine position
encoding (temperature 10000) plus a learned level embedding and normalized
centre reference points. After the shared encoder (``encode_fn``, the MTL's
one module) the tokens are split back into per-level NHWC maps, the
remaining high-resolution BACKBONE levels are FPN-fused, and a 1x1 conv
gives the mask feature. The cls variant stops after the split. Keys follow
the reference's mm layout:
``level_encoding.weight``, ``lateral_convs.{k}.conv/gn`` and
``output_convs.{k}.conv/gn`` (k counts from the FPN level nearest the
encoder: backbone level ``num_fpn - 1 - k``), ``mask_feature``,
``input_convs.{i}.conv/gn``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rscotr_tpu_torch.models.layers.common import (Conv2d, Embedding,
                                                   GroupNorm)
from rscotr_tpu_torch.ops.point_generator import single_level_grid_points
from rscotr_tpu_torch.ops.pos_encoding import sine_positional_encoding


def _flatten_levels_for_encoder(neck_feats, level_embed, num_encoder_levels,
                                strides, pos_temperature):
    """neck_feats: high -> low resolution NHWC maps. Returns (tokens, pos,
    ref_points (B, sum_hw, num_encoder_levels, 2), spatial_shapes low ->
    high)."""
    n = len(neck_feats)
    B = neck_feats[0].shape[0]
    dev = neck_feats[0].device
    toks, poss, refs, shapes = [], [], [], []
    for i in range(num_encoder_levels):
        level_idx = n - i - 1
        f = neck_feats[level_idx]
        h, w = f.shape[1], f.shape[2]
        mask = torch.zeros((B, h, w), dtype=torch.bool, device=dev)
        pos = sine_positional_encoding(mask, num_feats=f.shape[-1] // 2,
                                       temperature=pos_temperature,
                                       normalize=True)
        pos = pos + level_embed[i]
        s = strides[level_idx]
        pts = single_level_grid_points(h, w, s, device=dev)
        factor = torch.tensor([[w * s, h * s]], dtype=torch.float32,
                              device=dev)
        refs.append(pts / factor)
        toks.append(f.reshape(B, h * w, -1))
        poss.append(pos.reshape(B, h * w, -1))
        shapes.append((h, w))
    ref = torch.cat(refs, 0)
    ref = ref[None, :, None, :].expand(B, -1, num_encoder_levels, 2)
    return torch.cat(toks, 1), torch.cat(poss, 1), ref, tuple(shapes)


def _split_levels(memory, spatial_shapes):
    """(B, sum_hw, C) -> list of (B, h, w, C) in spatial_shapes order."""
    outs, start = [], 0
    for h, w in spatial_shapes:
        outs.append(memory[:, start:start + h * w].reshape(
            memory.shape[0], h, w, -1))
        start += h * w
    return outs


def _interpolate(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear NCHW resize with half-pixel centres and edge clamping, no
    antialiasing (the grid of JAX's ``_interp_matrix``), up or down."""
    hw = (int(hw[0]), int(hw[1]))
    if hw == tuple(x.shape[2:4]):
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                         antialias=False)


def _resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """``_interpolate`` on an NHWC map."""
    return _interpolate(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


class ConvGN(nn.Module):
    """A conv and its GroupNorm(32) (keys ``conv``, ``gn``)."""

    def __init__(self, cin, cout, k, bias, dtype, device):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, bias=bias,
                           dtype=dtype, device=device)
        self.gn = GroupNorm(32, cout, device=device)

    def forward(self, x):
        return self.gn(self.conv(x))


class MlvlClsPixelDecoder(nn.Module):
    """Runs the neck levels through the shared encoder and returns the
    per-level maps, low -> high resolution (the multi-level cls head's
    input). ``strides`` are the neck levels' (8..64 in the MTL)."""

    def __init__(self, num_encoder_levels: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64),
                 feat_channels: int = 256, pos_temperature: float = 10000.0,
                 device=None):
        super().__init__()
        self.num_encoder_levels = num_encoder_levels
        self.strides = tuple(strides)
        self.pos_temperature = pos_temperature
        self.level_encoding = Embedding(num_encoder_levels, feat_channels,
                                        device=device)

    def forward(self, encode_fn: Callable, neck_feats):
        tokens, pos, ref, shapes = _flatten_levels_for_encoder(
            neck_feats, self.level_encoding.weight, self.num_encoder_levels,
            self.strides, self.pos_temperature)
        return _split_levels(encode_fn(tokens, pos, ref, shapes), shapes)


class MlvlSegPixelDecoder(nn.Module):
    """Shared-encoder pixel decoder + FPN fuse of the high-resolution
    backbone levels that the encoder does not take. As the reference, the
    encoder reads NECK features while the FPN laterals read the raw BACKBONE
    levels; ``use_input_convs`` (the standalone segmentor's variant)
    projects the encoder's input levels first."""

    def __init__(self, num_encoder_levels: int = 4,
                 in_channels: Sequence[int] = (96, 192, 384, 768),
                 strides: Sequence[int] = (4, 8, 16, 32),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_outs: int = 4, pos_temperature: float = 10000.0,
                 use_input_convs: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        L, C = num_encoder_levels, feat_channels
        self.num_encoder_levels = L
        self.strides = tuple(strides)
        self.num_outs = num_outs
        self.pos_temperature = pos_temperature
        num_fpn = len(in_channels) - L
        self.level_encoding = Embedding(L, C, device=device)
        self.input_convs = nn.ModuleList(
            ConvGN(in_channels[len(in_channels) - 1 - i], C, 1, True, dtype,
                   device) for i in range(L)) if use_input_convs else None
        self.lateral_convs = nn.ModuleList(
            ConvGN(in_channels[num_fpn - 1 - k], C, 1, False, dtype, device)
            for k in range(num_fpn))
        self.output_convs = nn.ModuleList(
            ConvGN(C, C, 3, False, dtype, device) for _ in range(num_fpn))
        self.mask_feature = Conv2d(C, out_channels, 1, dtype=dtype,
                                   device=device)

    def forward(self, encode_fn: Callable, neck_feats, backbone_feats):
        """neck_feats: the encoder's input levels (strides 8..64 in the
        MTL); backbone_feats: 4 levels (strides 4..32). Returns
        (mask_feature, multi-scale features low -> high resolution)."""
        L = self.num_encoder_levels
        if self.input_convs is not None:
            n = len(neck_feats)
            projected = [conv(neck_feats[n - 1 - i])
                         for i, conv in enumerate(self.input_convs)]
            neck_feats = tuple(list(neck_feats[:n - L]) +
                               list(reversed(projected)))
        # the reference indexes its (backbone) stride table with the neck
        # level's index, so the MTL's stride-8 neck level gets stride 4
        enc_strides = [self.strides[min(i, len(self.strides) - 1)]
                       for i in range(len(neck_feats))]
        tokens, pos, ref, shapes = _flatten_levels_for_encoder(
            neck_feats, self.level_encoding.weight, L, enc_strides,
            self.pos_temperature)
        outs = _split_levels(encode_fn(tokens, pos, ref, shapes), shapes)
        num_fpn = len(backbone_feats) - L
        for k, (lat_conv, out_conv) in enumerate(zip(self.lateral_convs,
                                                     self.output_convs)):
            lat = lat_conv(backbone_feats[num_fpn - 1 - k])
            y = lat + _resize_bilinear(outs[-1], lat.shape[1:3])
            outs.append(F.relu(out_conv(y)))
        return self.mask_feature(outs[-1]), outs[:self.num_outs]
