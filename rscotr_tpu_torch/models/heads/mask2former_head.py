"""Mask2Former-style semantic segmentation head (PyTorch counterpart of
rscotr_tpu/models/heads/mask2former_head.py).

The pixel decoder (``MlvlSegPixelDecoder``) runs the MTL's shared encoder.
Learned ``query_feat`` / ``query_embed`` (100 queries at the flagship) and
``level_embed``; masked-attention decoder layers (cross -> self -> FFN)
cycling over the feature levels, low -> high resolution. Before each layer
the attention mask is the previous mask prediction, bilinearly resized to
the level (no antialiasing), ``sigmoid < 0.5`` = blocked, with all-blocked
rows reset to all-allowed, repeated per head. Outputs:
* scheme 1: seg logits = einsum(cls_embed(q), mask_pred), num_classes + 1
  channels;
* scheme 2: mask_pred itself is the logits, one channel per QUERY (100 at
  the flagship; the serving argmax runs over all of them, as the JAX
  package's: ROADMAP C4).
Returns the last layer's logits NHWC (B, Hm, Wm, channels) at the mask
feature's stride (8 in the MTL). Keys follow the reference's mm layout
(``transformer_decoder.layers.{i}``, ``transformer_decoder.post_norm``,
``mask_embed.{0,2,4}``, ``cls_embed``, ``pixel_decoder.*``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from rscotr_tpu_torch.models.heads.pixel_decoders import (MlvlSegPixelDecoder,
                                                          _interpolate)
from rscotr_tpu_torch.models.layers.common import Embedding, LayerNorm, Linear
from rscotr_tpu_torch.models.layers.transformer import \
    MaskedAttentionDecoderLayer
from rscotr_tpu_torch.ops.pos_encoding import sine_positional_encoding


class Mask2FormerDecoder(nn.Module):
    """Holds the decoder layers and the post norm (mm key names)."""

    def __init__(self, num_layers, embed_dims, num_heads,
                 feedforward_channels, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            MaskedAttentionDecoderLayer(embed_dims, num_heads,
                                        feedforward_channels, dtype=dtype,
                                        device=device)
            for _ in range(num_layers))
        self.post_norm = LayerNorm(embed_dims, device=device)


class Mask2FormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_classes: int = 5, num_queries: int = 100,
                 num_transformer_feat_level: int = 4, scheme: int = 2,
                 num_heads: int = 8, num_decoder_layers: int = 9,
                 feedforward_channels: int = 2048,
                 pos_temperature: float = 10000.0,
                 pixel_decoder_strides: Sequence[int] = (4, 8, 16, 32),
                 pixel_decoder_input_convs: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if scheme not in (1, 2):
            raise NotImplementedError(f"Mask2FormerHead scheme {scheme}")
        C, L = feat_channels, num_transformer_feat_level
        self.scheme = scheme
        self.num_heads = num_heads
        self.num_levels = L
        self.pos_temperature = pos_temperature
        self.pixel_decoder = MlvlSegPixelDecoder(
            num_encoder_levels=L, in_channels=tuple(in_channels),
            strides=tuple(pixel_decoder_strides), feat_channels=C,
            out_channels=out_channels, num_outs=L,
            pos_temperature=pos_temperature,
            use_input_convs=pixel_decoder_input_convs, dtype=dtype,
            device=device)
        self.level_embed = Embedding(L, C, device=device)
        self.query_feat = Embedding(num_queries, C, device=device)
        self.query_embed = Embedding(num_queries, C, device=device)
        self.transformer_decoder = Mask2FormerDecoder(
            num_decoder_layers, C, num_heads, feedforward_channels, dtype,
            device)
        self.mask_embed = nn.Sequential(
            Linear(C, C, dtype=dtype, device=device), nn.ReLU(),
            Linear(C, C, dtype=dtype, device=device), nn.ReLU(),
            Linear(C, out_channels, dtype=dtype, device=device))
        self.cls_embed = (Linear(C, num_classes + 1, dtype=dtype,
                                 device=device) if scheme == 1 else None)

    def _forward_head(self, q, mask_feature, attn_hw):
        """-> (seg logits (B, channels, Hm, Wm), attention mask for the next
        layer (B*heads, Q, h*w) at ``attn_hw``, True = blocked)."""
        d = self.transformer_decoder.post_norm(q)
        me = self.mask_embed(d)                               # (B, Q, C)
        mask_pred = torch.einsum("bqc,bhwc->bqhw", me, mask_feature)
        if self.scheme == 1:
            seg = torch.einsum("bqk,bqhw->bkhw", self.cls_embed(d),
                               mask_pred)
        else:
            seg = mask_pred
        B, Q = mask_pred.shape[:2]
        am = _interpolate(mask_pred, attn_hw).reshape(B, Q, -1)
        am = torch.sigmoid(am) < 0.5
        am = am & ~am.all(-1, keepdim=True)
        am = am[:, None].expand(B, self.num_heads, Q, am.shape[-1])
        return seg, am.reshape(B * self.num_heads, Q, -1)

    def forward(self, neck_feats, backbone_feats, encode_fn: Callable):
        """Returns seg logits (B, Hm, Wm, num_queries | num_classes + 1)."""
        mask_feature, ms_feats = self.pixel_decoder(encode_fn, neck_feats,
                                                    backbone_feats)
        B = backbone_feats[0].shape[0]
        C = self.level_embed.weight.shape[1]
        dec_inputs, dec_pos = [], []
        for i in range(self.num_levels):
            f = ms_feats[i]
            h, w = f.shape[1], f.shape[2]
            dec_inputs.append(f.reshape(B, h * w, C) +
                              self.level_embed.weight[i])
            mask = torch.zeros((B, h, w), dtype=torch.bool, device=f.device)
            dec_pos.append(sine_positional_encoding(
                mask, num_feats=C // 2, temperature=self.pos_temperature,
                normalize=True).reshape(B, h * w, C))
        q = self.query_feat.weight[None].expand(B, -1, -1)
        qp = self.query_embed.weight[None].expand(B, -1, -1)
        seg, attn_mask = self._forward_head(q, mask_feature,
                                            ms_feats[0].shape[1:3])
        for i, layer in enumerate(self.transformer_decoder.layers):
            lvl = i % self.num_levels
            q = layer(q, dec_inputs[lvl], qp, dec_pos[lvl],
                      cross_attn_mask=attn_mask)
            seg, attn_mask = self._forward_head(
                q, mask_feature,
                ms_feats[(i + 1) % self.num_levels].shape[1:3])
        return seg.permute(0, 2, 3, 1)
