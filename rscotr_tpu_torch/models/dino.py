"""Standalone single-task DINO detector (PyTorch counterpart of
rscotr_tpu/models/dino.py).

Backbone -> ChannelMapper neck over the last ``neck_in_levels`` backbone
levels -> ``DINOHead``, whose encoder the model OWNS as ``encoder`` (the
reference's DINO transformer owns its encoder; the JAX package names it
so). ``forward_det`` is ``MTL.forward_det``'s, so ``make_infer_steps`` and
the det ``make_train_step`` run on it unchanged.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from rscotr_tpu_torch.models.mtl import outputs_f32


class DINO(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, encoder: nn.Module,
                 neck_in_levels: int = 3):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.encoder = encoder
        self.neck_in_levels = neck_in_levels

    def forward_det(self, img, img_hw, dn_label_query=None,
                    dn_bbox_query=None, attn_mask=None,
                    generator: Optional[torch.Generator] = None):
        """-> (all_cls, all_coords, topk_score, topk_anchor), see
        ``DINOHead.forward``."""
        bb = self.backbone(img, generator)
        feats = self.neck(bb[len(bb) - self.neck_in_levels:])
        return outputs_f32(self.bbox_head(
            feats, img_hw,
            encode_fn=functools.partial(self.encoder, generator=generator),
            dn_label_query=dn_label_query, dn_bbox_query=dn_bbox_query,
            attn_mask=attn_mask))
