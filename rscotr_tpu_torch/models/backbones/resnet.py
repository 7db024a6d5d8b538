"""ResNet backbone (PyTorch counterpart of
rscotr_tpu/models/backbones/resnet.py, NHWC activations).

Pytorch-style Bottleneck (the stride in the 3x3 conv), depths 50 / 101 /
152, ``num_stages`` and ``out_indices``. Parameter and buffer names follow
torchvision / mmcv (``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}`` / ``bn{i}``,
``layer{s}.{b}.downsample.0`` / ``.1``), so the reference's checkpoints and
``utils.convert.state_dict_from_jax`` load without a map.

* Convs are the port's ``Conv2d``: bf16 compute with float32 parameters
  under a bf16 model.
* BatchNorm is frozen: the running statistics are buffers, applied in float32
  in training and eval alike, which is what ``norm_eval=True`` (every
  config) gives; the output is float32, as flax promotes a bf16 input
  against its float32 statistics. Training with ``norm_eval=False`` would
  update the statistics, which the JAX package cannot do either (its loss
  functions apply the model without a mutable ``batch_stats``), so the port
  raises there. Each BN also carries mm's ``num_batches_tracked`` buffer so
  that mm checkpoints load strictly.
* The stem's max-pool is 3x3, stride 2, padding 1, padded with -inf as flax
  pads.
* ``frozen_stages`` is accepted and does nothing, as in the JAX package,
  whose comment says the optimizer masks would apply it and whose masks do
  not (ROADMAP C7).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rscotr_tpu_torch.models.layers.common import Conv2d, constant_


class FrozenBatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True, epsilon=1e-5)`` on NHWC
    maps: ``(x - mean) * (weight * rsqrt(var + eps)) + bias`` in float32."""

    def __init__(self, num_features: int, norm_eval: bool = True,
                 device=None):
        super().__init__()
        self.norm_eval = norm_eval
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def _init_params(self, g):
        constant_(self.weight, 1.0)
        constant_(self.bias, 0.0)

    def forward(self, x):
        if self.training and not self.norm_eval:
            raise NotImplementedError(
                "ResNet with norm_eval=False in training mode would update "
                "the BatchNorm statistics, which neither package does: set "
                "norm_eval=True or run the backbone in eval mode")
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return (x.float() - self.running_mean) * mul + self.bias


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm_eval: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype,
                            device=device)
        self.bn1 = FrozenBatchNorm(planes, norm_eval, device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False, dtype=dtype, device=device)
        self.bn2 = FrozenBatchNorm(planes, norm_eval, device)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype,
                            device=device)
        self.bn3 = FrozenBatchNorm(out, norm_eval, device)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, out, 1, stride=stride, bias=False, dtype=dtype,
                   device=device),
            FrozenBatchNorm(out, norm_eval, device)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = 1, norm_eval: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        if depth not in self.ARCH:
            raise KeyError(f"invalid depth {depth} for resnet")
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            dtype=dtype, device=device)
        self.bn1 = FrozenBatchNorm(64, norm_eval, device)
        self.num_stages = len(self.ARCH[depth][:num_stages])
        inplanes, planes = 64, 64
        for si, nb in enumerate(self.ARCH[depth][:num_stages]):
            blocks = []
            for bi in range(nb):
                blocks.append(Bottleneck(
                    inplanes, planes, stride=(1 if si == 0 or bi else 2),
                    downsample=bi == 0, norm_eval=norm_eval, dtype=dtype,
                    device=device))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
            planes *= 2

    def out_hw(self, hw):
        """The (h, w) of each returned map for an (H, W) input: the stem
        conv, the max-pool and each later stage's first block halve the
        size, rounding up."""
        h, w = -(-int(hw[0]) // 4), -(-int(hw[1]) // 4)
        outs = []
        for si in range(self.num_stages):
            if si:
                h, w = -(-h // 2), -(-w // 2)
            if si in self.out_indices:
                outs.append((h, w))
        return outs

    def forward(self, x, generator=None):
        """x: (B, H, W, 3) -> tuple of (B, h_i, w_i, C_i) float32 maps."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        outs = []
        for si in range(self.num_stages):
            x = getattr(self, f"layer{si + 1}")(x)
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)
