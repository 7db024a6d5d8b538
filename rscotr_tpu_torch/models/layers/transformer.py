"""Transformer layer sequences (PyTorch counterpart of
rscotr_tpu/models/layers/transformer.py), in mmcv's BaseTransformerLayer key
layout: ``attentions.{i}``, ``ffns.0``, ``norms.{i}``.

* DeformableEncoderLayer: MSDA self-attn -> norm -> FFN -> norm (the shared
  encoder).
* DinoDecoderLayer: self-attn (MHA) -> norm -> MSDA cross-attn -> norm ->
  FFN -> norm.
* MaskedAttentionDecoderLayer: cross-attn (MHA over the pixel features,
  masked) -> norm -> self-attn (MHA) -> norm -> FFN -> norm (the
  Mask2Former decoder).
"""

from __future__ import annotations

import torch
from torch import nn

from rscotr_tpu_torch.models.layers.attention import MultiheadAttention
from rscotr_tpu_torch.models.layers.common import (FFN, LayerNorm,
                                                   checkpoint_with_generator)
from rscotr_tpu_torch.models.layers.msda import MultiScaleDeformableAttention


class DeformableEncoderLayer(nn.Module):
    """``dropout``: after the MSDA output projection; ``ffn_drop``: after
    each FFN product (mmcv's keys; active in training mode, drawing from the
    ``generator`` given to ``forward``)."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, feedforward_channels=2048, ffn_drop=0.0,
                 dropout=0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.attentions = nn.ModuleList([MultiScaleDeformableAttention(
            embed_dims, num_heads, num_levels, num_points, dropout=dropout,
            dtype=dtype, device=device)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       drop=ffn_drop, dtype=dtype,
                                       device=device)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims, device=device)
                                    for _ in range(2)])

    def forward(self, x, query_pos, reference_points, spatial_shapes,
                key_padding_mask=None, generator=None):
        x = self.attentions[0](query=x, value=x, query_pos=query_pos,
                               key_padding_mask=key_padding_mask,
                               reference_points=reference_points,
                               spatial_shapes=spatial_shapes,
                               generator=generator)
        x = self.norms[0](x)
        x = self.ffns[0](x, generator=generator)
        return self.norms[1](x)


class DeformableEncoder(nn.Module):
    """The shared multi-scale deformable encoder (one module used by every
    task head; the models hand it to the heads with the forward's
    ``generator`` bound). ``with_cp=True`` (JAX's ``nn.remat`` of each
    layer) runs each layer under ``checkpoint_with_generator`` in training:
    the backward keeps the layer's inputs and recomputes the rest with the
    dropout masks of the first pass."""

    def __init__(self, num_layers=6, embed_dims=256, num_heads=8,
                 num_levels=4, num_points=4, feedforward_channels=2048,
                 ffn_drop=0.0, dropout=0.0, with_cp=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.with_cp = with_cp
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(embed_dims, num_heads, num_levels,
                                   num_points, feedforward_channels,
                                   ffn_drop=ffn_drop, dropout=dropout,
                                   dtype=dtype, device=device)
            for _ in range(num_layers))

    def forward(self, x, query_pos, reference_points, spatial_shapes,
                key_padding_mask=None, generator=None):
        cp = self.with_cp and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            if cp:
                x = checkpoint_with_generator(
                    layer, x, generator, query_pos, reference_points,
                    spatial_shapes, key_padding_mask)
            else:
                x = layer(x, query_pos, reference_points, spatial_shapes,
                          key_padding_mask, generator)
        return x


class DinoDecoderLayer(nn.Module):
    def __init__(self, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, feedforward_channels=2048,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dims, num_heads, dtype=dtype,
                               device=device),
            MultiScaleDeformableAttention(embed_dims, num_heads, num_levels,
                                          num_points, dtype=dtype,
                                          device=device)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       dtype=dtype, device=device)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims, device=device)
                                    for _ in range(3)])

    def forward(self, x, query_pos, memory, reference_points, spatial_shapes,
                self_attn_mask=None, key_padding_mask=None):
        x = self.attentions[0](query=x, query_pos=query_pos,
                               attn_mask=self_attn_mask)
        x = self.norms[0](x)
        x = self.attentions[1](query=x, value=memory, query_pos=query_pos,
                               key_padding_mask=key_padding_mask,
                               reference_points=reference_points,
                               spatial_shapes=spatial_shapes)
        x = self.norms[1](x)
        x = self.ffns[0](x)
        return self.norms[2](x)


class MaskedAttentionDecoderLayer(nn.Module):
    """Mask2Former decoder layer: ``attentions.0`` is the cross-attention,
    ``attentions.1`` the self-attention."""

    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=2048,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.attentions = nn.ModuleList(
            MultiheadAttention(embed_dims, num_heads, dtype=dtype,
                               device=device) for _ in range(2))
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       dtype=dtype, device=device)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims, device=device)
                                    for _ in range(3)])

    def forward(self, x, memory, query_pos, key_pos, cross_attn_mask=None):
        x = self.attentions[0](query=x, key=memory, value=memory,
                               query_pos=query_pos, key_pos=key_pos,
                               attn_mask=cross_attn_mask)
        x = self.norms[0](x)
        x = self.attentions[1](query=x, query_pos=query_pos)
        x = self.norms[1](x)
        x = self.ffns[0](x)
        return self.norms[2](x)
