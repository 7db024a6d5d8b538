"""ChannelMapper neck (PyTorch counterpart of
rscotr_tpu/models/necks/channel_mapper.py; mmdet keys ``convs.{i}.conv/gn``,
``extra_convs.{j}.conv/gn``).

Per input level a k x k conv (+ GroupNorm, + ReLU when configured); then
extra stride-2 3x3 convs: the first on the last INPUT map, later ones on the
previous extra output.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rscotr_tpu_torch.models.layers.common import Conv2d, GroupNorm


class ConvModule(nn.Module):
    def __init__(self, cin, cout, k, stride, use_norm, norm_groups, dtype,
                 device):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                           bias=not use_norm, dtype=dtype, device=device)
        self.gn = GroupNorm(norm_groups, cout, device=device) if use_norm \
            else None

    def forward(self, x):
        x = self.conv(x)
        return self.gn(x) if self.gn is not None else x


class ChannelMapper(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (192, 384, 768),
                 out_channels: int = 256, kernel_size: int = 1,
                 num_outs: int = 4, use_norm: bool = True,
                 norm_groups: int = 32, act=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.relu = act == "relu"
        self.convs = nn.ModuleList(
            ConvModule(c, out_channels, kernel_size, 1, use_norm, norm_groups,
                       dtype, device) for c in in_channels)
        extra = []
        for j in range(num_outs - len(in_channels)):
            cin = in_channels[-1] if j == 0 else out_channels
            extra.append(ConvModule(cin, out_channels, 3, 2, use_norm,
                                    norm_groups, dtype, device))
        self.extra_convs = nn.ModuleList(extra)

    def out_hw(self, in_hw):
        """The (h, w) of each output for input maps of sizes ``in_hw``: the
        k x k convs keep the size, each stride-2 3x3 extra conv halves it,
        rounding up."""
        outs = [tuple(hw) for hw in in_hw]
        for _ in self.extra_convs:
            h, w = outs[-1]
            outs.append((-(-h // 2), -(-w // 2)))
        return outs

    def forward(self, feats):
        """feats: tuple of NHWC maps, one per input level."""
        if len(feats) != len(self.convs):
            raise ValueError(f"ChannelMapper expects {len(self.convs)} maps")
        act = F.relu if self.relu else (lambda t: t)
        outs = [act(conv(f)) for conv, f in zip(self.convs, feats)]
        src = feats[-1]
        for conv in self.extra_convs:
            src = act(conv(src))
            outs.append(src)
        return tuple(outs)
