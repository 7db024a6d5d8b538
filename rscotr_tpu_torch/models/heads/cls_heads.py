"""Classification heads (PyTorch counterpart of
rscotr_tpu/models/heads/cls_heads.py). Only ``SlvlClsHead`` is ported;
``MlvlClsHead`` is ROADMAP P3."""

from __future__ import annotations

import torch
from torch import nn

from rscotr_tpu_torch.models.layers.common import Linear


class SlvlClsHead(nn.Module):
    """GAP(backbone[-1]) -> Linear(num_classes); the encoder is unused."""

    def __init__(self, num_classes: int = 45, in_channels: int = 768,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fc = Linear(in_channels, num_classes, dtype=dtype, device=device)

    def forward(self, backbone_feats):
        return self.fc(backbone_feats[-1].mean(dim=(1, 2)))
