"""DINO detection head (PyTorch counterpart of
rscotr_tpu/models/heads/dino_head.py).

Two-stage deformable DETR: encoder proposals (finite ``BIG`` masking), the
top-``num_query`` selection over max class logits, decoder layers with box
refinement (look forward twice) and per-layer outputs. The encoder is the
MTL's shared encoder, passed in as ``encode_fn``. Parameter names follow the
reference (``transformer.*``, ``cls_branches.{i}``,
``reg_branches.{i}.{0,2,4}``, ``label_embedding``). In training the
contrastive-denoising queries (``models/heads/cdn.py``) are prepended to the
matching queries under the CDN self-attention mask; the top-k proposal
coordinates are detached, and so is the reference passed between decoder
layers, while the per-layer outputs keep the non-detached refinement (look
forward twice). Serving runs the ``num_query`` matching queries only.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from rscotr_tpu_torch.models.layers.common import (LayerNorm, Linear, Mlp,
                                                   constant_, normal_)
from rscotr_tpu_torch.models.layers.transformer import DinoDecoderLayer
from rscotr_tpu_torch.ops.box_ops import inverse_sigmoid
from rscotr_tpu_torch.ops.point_generator import encoder_reference_points
from rscotr_tpu_torch.ops.pos_encoding import (coordinate_sine_embedding,
                                               sine_positional_encoding)

BIG = 1e4  # finite stand-in for the reference's masked_fill(inf)


def mlvl_masks_and_ratios(spatial_shapes, strides, img_hw):
    """Per-level padding masks (True = pad) and valid ratios (B, L, 2) from
    the un-padded content size ``img_hw`` (B, 2) = (h, w)."""
    dev = img_hw.device
    img_h = img_hw[:, 0].float()
    img_w = img_hw[:, 1].float()
    masks, ratios = [], []
    for (h, w), s in zip(spatial_shapes, strides):
        valid_y = (torch.arange(h, dtype=torch.float32, device=dev) * s
                   )[None] < img_h[:, None]
        valid_x = (torch.arange(w, dtype=torch.float32, device=dev) * s
                   )[None] < img_w[:, None]
        masks.append(~(valid_y[:, :, None] & valid_x[:, None, :]))
        ratios.append(torch.stack([valid_x.float().sum(1) / w,
                                   valid_y.float().sum(1) / h], -1))
    return masks, torch.stack(ratios, dim=1)


class Embedding(nn.Module):
    """A ``weight`` table initialised N(0, 1) (flax normal(1.0))."""

    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device))

    def _init_params(self, g):
        normal_(self.weight, 1.0, g)


class DinoTransformerDecoder(nn.Module):
    def __init__(self, num_layers, embed_dims, num_heads, num_levels,
                 num_points, feedforward_channels, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            DinoDecoderLayer(embed_dims, num_heads, num_levels, num_points,
                             feedforward_channels, dtype=dtype, device=device)
            for _ in range(num_layers))
        self.ref_point_head = Mlp(2 * embed_dims, embed_dims, embed_dims,
                                  num_layers=2, dtype=dtype, device=device)
        self.norm = LayerNorm(embed_dims, device=device)


class DinoTransformer(nn.Module):
    def __init__(self, num_query, num_feature_levels, decoder, embed_dims,
                 dtype, device):
        super().__init__()
        self.level_embeds = nn.Parameter(
            torch.empty(num_feature_levels, embed_dims, device=device))
        self.query_embed = Embedding(num_query, embed_dims, device=device)
        self.enc_output = Linear(embed_dims, embed_dims, dtype=dtype,
                                 device=device)
        self.enc_output_norm = LayerNorm(embed_dims, device=device)
        self.decoder = decoder

    def _init_params(self, g):
        normal_(self.level_embeds, 1.0, g)


class DINOHead(nn.Module):
    def __init__(self, num_classes: int = 20, num_query: int = 600,
                 embed_dims: int = 256, num_decoder_layers: int = 6,
                 num_feature_levels: int = 4, num_heads: int = 8,
                 num_points: int = 4, feedforward_channels: int = 2048,
                 pos_temperature: float = 20.0,
                 strides: Sequence[int] = (8, 16, 32, 64),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_classes, self.num_query = num_classes, num_query
        self.embed_dims, self.pos_temperature = embed_dims, pos_temperature
        self.strides = tuple(strides)
        C, L = embed_dims, num_decoder_layers
        self.label_embedding = Embedding(num_classes, C, device=device)
        decoder = DinoTransformerDecoder(L, C, num_heads, num_feature_levels,
                                         num_points, feedforward_channels,
                                         dtype, device)
        self.transformer = DinoTransformer(num_query, num_feature_levels,
                                           decoder, C, dtype, device)
        # L decoder branches + 1 encoder-proposal branch
        self.cls_branches = nn.ModuleList(
            Linear(C, num_classes, dtype=dtype, device=device)
            for _ in range(L + 1))
        self.reg_branches = nn.ModuleList(
            nn.Sequential(Linear(C, C, dtype=dtype, device=device), nn.ReLU(),
                          Linear(C, C, dtype=dtype, device=device), nn.ReLU(),
                          Linear(C, 4, dtype=dtype, device=device))
            for _ in range(L + 1))

    def _init_params(self, g):
        prior = -math.log((1 - 0.01) / 0.01)
        for fc in self.cls_branches:
            constant_(fc.bias, prior)
        for reg in self.reg_branches:
            constant_(reg[4].weight, 0.0)
            constant_(reg[4].bias, 0.0)

    def forward(self, neck_feats, img_hw: torch.Tensor, encode_fn: Callable,
                dn_label_query: Optional[torch.Tensor] = None,
                dn_bbox_query: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None):
        """
        Args:
            neck_feats: NHWC maps, high->low resolution (strides 8..64).
            img_hw: (B, 2) int content size of each padded image.
            encode_fn: the shared encoder.
            dn_label_query (B, P, C), dn_bbox_query (B, P, 4) unsigmoided,
                attn_mask (P + num_query, P + num_query) bool (True = not
                allowed): the CDN queries and their mask, or None.
        Returns:
            all_cls (L, B, N, K), all_coords (L, B, N, 4) with
            N = P + num_query, topk_score (B, num_query, K), topk_anchor
            (B, num_query, 4).
        """
        tr = self.transformer
        B = neck_feats[0].shape[0]
        C = self.embed_dims
        shapes = tuple((f.shape[1], f.shape[2]) for f in neck_feats)
        masks, valid_ratios = mlvl_masks_and_ratios(shapes, self.strides,
                                                    img_hw)
        toks, poss, mflat = [], [], []
        for lvl, f in enumerate(neck_feats):
            h, w = shapes[lvl]
            pos = sine_positional_encoding(
                masks[lvl], num_feats=C // 2,
                temperature=self.pos_temperature, normalize=True)
            toks.append(f.reshape(B, h * w, C))
            poss.append(pos.reshape(B, h * w, C) + tr.level_embeds[lvl])
            mflat.append(masks[lvl].reshape(B, h * w))
        tokens = torch.cat(toks, 1)
        pos_flat = torch.cat(poss, 1)
        mask_flat = torch.cat(mflat, 1)

        enc_ref = encoder_reference_points(shapes, valid_ratios)
        memory = encode_fn(tokens, pos_flat, enc_ref, shapes,
                           key_padding_mask=mask_flat)

        # ---- two-stage proposals and top-k selection ---------------------
        out_memory, out_proposals = self._gen_proposals(
            memory, mask_flat, shapes, valid_ratios)
        enc_cls = self.cls_branches[-1](out_memory)       # (B, S, K)
        enc_coord_unact = self.reg_branches[-1](out_memory) + out_proposals
        topk_idx = enc_cls.max(-1).values.topk(self.num_query, dim=1).indices
        K = enc_cls.shape[-1]
        topk_score = enc_cls.gather(1, topk_idx[..., None].expand(-1, -1, K))
        topk_coords_unact = enc_coord_unact.gather(
            1, topk_idx[..., None].expand(-1, -1, 4))
        topk_anchor = topk_coords_unact.sigmoid()
        topk_coords_unact = topk_coords_unact.detach()

        # ---- decoder queries (CDN first) and box refinement --------------
        x = tr.query_embed.weight[None].expand(B, -1, -1)
        ref_unact = topk_coords_unact
        if dn_label_query is not None:
            x = torch.cat([dn_label_query, x], 1)
            ref_unact = torch.cat([dn_bbox_query, topk_coords_unact], 1)
        ref = ref_unact.sigmoid()
        ratios4 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
        dec = tr.decoder
        inter_states, inter_refs = [], [ref]
        for lid, layer in enumerate(dec.layers):
            ref_input = ref[:, :, None, :] * ratios4      # (B, N, L, 4)
            query_pos = dec.ref_point_head(coordinate_sine_embedding(
                ref_input[:, :, 0, :], num_feats=C // 2))
            x = layer(x, query_pos, memory, ref_input, shapes,
                      self_attn_mask=attn_mask, key_padding_mask=mask_flat)
            new_ref = (self.reg_branches[lid](x) +
                       inverse_sigmoid(ref, eps=1e-3)).sigmoid()
            ref = new_ref.detach()
            inter_states.append(dec.norm(x))
            inter_refs.append(new_ref)

        all_cls, all_coords = [], []
        for lvl, state in enumerate(inter_states):
            all_cls.append(self.cls_branches[lvl](state))
            all_coords.append((self.reg_branches[lvl](state) + inverse_sigmoid(
                inter_refs[lvl], eps=1e-3)).sigmoid())
        return (torch.stack(all_cls), torch.stack(all_coords), topk_score,
                topk_anchor)

    def _gen_proposals(self, memory, mask_flat, shapes, valid_ratios):
        """mmdet gen_encoder_output_proposals with finite masking."""
        tr = self.transformer
        dev = memory.device
        props = []
        for lvl, (h, w) in enumerate(shapes):
            yy, xx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev),
                indexing="ij")
            grid = torch.stack([xx, yy], -1).reshape(-1, 2)
            scale = torch.stack([valid_ratios[:, lvl, 0] * w,
                                 valid_ratios[:, lvl, 1] * h], -1)[:, None]
            grid = (grid[None] + 0.5) / scale
            wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
            props.append(torch.cat([grid, wh], -1))
        props = torch.cat(props, 1)                         # (B, S, 4)
        in_range = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        props_unact = torch.log(props.clamp(min=1e-9) /
                                (1.0 - props).clamp(min=1e-9))
        invalid = mask_flat[..., None] | ~in_range
        props_unact = props_unact.masked_fill(invalid, BIG)
        mem = memory.masked_fill(invalid, 0.0)
        return tr.enc_output_norm(tr.enc_output(mem)), props_unact
