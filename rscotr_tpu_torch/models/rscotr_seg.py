"""Standalone single-task segmentor (PyTorch counterpart of
rscotr_tpu/models/rscotr_seg.py).

Backbone -> ``Mask2FormerHead`` with ``pixel_decoder_input_convs=True``:
its pixel decoder projects the raw backbone levels with input convs, runs
the model's OWNED encoder over the lowest ``num_transformer_feat_level``
of them (3 in every config) and FPN-fuses the rest. ``forward_seg`` is
``MTL.forward_seg``'s, so ``make_infer_steps`` and the seg
``make_train_step`` run on it unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rscotr_tpu_torch.models.mtl import outputs_f32


class RSCoTrSeg(nn.Module):
    def __init__(self, backbone: nn.Module, seg_head: nn.Module,
                 encoder: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.seg_head = seg_head
        self.encoder = encoder

    def forward_seg(self, img, generator: Optional[torch.Generator] = None):
        """-> seg logits (B, H/4, W/4, channels), see
        ``Mask2FormerHead.forward``."""
        bb = self.backbone(img, generator)
        return outputs_f32(self.seg_head(bb, bb, encode_fn=self.encoder))
