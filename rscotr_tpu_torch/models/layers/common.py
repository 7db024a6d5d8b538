"""Common bricks of the PyTorch port, and their initialisation.

Counterpart of rscotr_tpu/models/layers/common.py, plus the compute-dtype
flow that flax gives the JAX package: a ``Linear`` / ``Conv2d`` built with
``dtype=torch.bfloat16`` casts its input, weight and bias to bf16 (flax
``nn.Dense(dtype=...)``), while ``LayerNorm`` / ``GroupNorm`` always return
float32 (flax norms with no ``dtype`` promote bf16 input to their f32
params). Parameters stay float32. Activations are NHWC / (B, N, C) as in the
JAX package; parameter names follow the reference's mm state-dict layout.

``DropPath`` and ``Dropout`` are active only in training mode
(``module.train()``, JAX's ``deterministic=False``) with a non-zero rate, and
draw their masks from an explicit ``torch.Generator`` passed down through
the forward (on the generator's device, then moved to the input's).

Initialisation mirrors the flax initialisers' distributions from an explicit
``torch.Generator`` (``init_weights``): modules define ``_init_params(g)``,
which runs after their children's, so a parent can override a child's
default (zero-initialised branches, prior-probability biases).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# flax variance_scaling's truncated-normal correction: std of a unit normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fill(p: torch.Tensor, sample: Callable[[torch.Tensor], None]) -> None:
    """Sample on the CPU (where the generator lives) and copy into ``p``."""
    if p.is_meta:
        return
    tmp = torch.empty(p.shape, dtype=torch.float32)
    sample(tmp)
    with torch.no_grad():
        p.copy_(tmp)


def trunc_normal_(p, std: float, g: torch.Generator) -> None:
    """flax initializers.truncated_normal(std): N(0, std) cut at +-2 std."""
    _fill(p, lambda t: nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                             generator=g))


def lecun_normal_(p, fan_in: int, g: torch.Generator) -> None:
    """flax's default kernel init (lecun_normal: fan-in variance scaling,
    truncated normal)."""
    trunc_normal_(p, math.sqrt(1.0 / fan_in) / _TRUNC_STD, g)


def normal_(p, std: float, g: torch.Generator) -> None:
    _fill(p, lambda t: nn.init.normal_(t, 0.0, std, generator=g))


def constant_(p, val: float) -> None:
    if not p.is_meta:
        with torch.no_grad():
            p.fill_(val)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``module``: children first, then the
    module's own ``_init_params`` (which may override its children's)."""
    for child in module.children():
        init_weights(child, generator)
    if hasattr(module, "_init_params"):
        module._init_params(generator)


class Linear(nn.Linear):
    """``nn.Dense(dtype=dtype)``: computes in ``dtype``, params float32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def reset_parameters(self):
        """No-op: ``init_weights`` initialises from an explicit generator."""

    def _init_params(self, g):
        lecun_normal_(self.weight, self.in_features, g)
        if self.bias is not None:
            constant_(self.bias, 0.0)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv(dtype=dtype)`` on NHWC maps; weight in torch (O, I, kh, kw)
    layout."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, device=device)
        self.compute_dtype = dtype

    def reset_parameters(self):
        """No-op: ``init_weights`` initialises from an explicit generator."""

    def _init_params(self, g):
        kh, kw = self.kernel_size
        lecun_normal_(self.weight, self.in_channels * kh * kw, g)
        if self.bias is not None:
            constant_(self.bias, 0.0)

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                     None if self.bias is None else self.bias.to(dt),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm(epsilon=1e-5): float32 statistics and output."""

    def __init__(self, dim: int, device=None):
        super().__init__(dim, eps=1e-5, device=device)

    def reset_parameters(self):
        """No-op: ``init_weights`` initialises from an explicit generator."""

    def _init_params(self, g):
        constant_(self.weight, 1.0)
        constant_(self.bias, 0.0)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """flax GroupNorm over NHWC maps: float32 statistics and output."""

    def __init__(self, num_groups: int, num_channels: int, device=None):
        super().__init__(num_groups, num_channels, eps=1e-5, device=device)

    def reset_parameters(self):
        """No-op: ``init_weights`` initialises from an explicit generator."""

    def _init_params(self, g):
        constant_(self.weight, 1.0)
        constant_(self.bias, 0.0)

    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


def drop_path_rates(drop_path_rate: float,
                    depths: Sequence[int]) -> List[List[float]]:
    """Linearly increasing stochastic-depth rates across all blocks, per
    stage."""
    total = sum(depths)
    rates = [float(drop_path_rate) * i / max(total - 1, 1)
             for i in range(total)]
    out, k = [], 0
    for d in depths:
        out.append(rates[k:k + d])
        k += d
    return out


def _keep_mask(shape, keep: float, g: Optional[torch.Generator],
               like: torch.Tensor) -> torch.Tensor:
    if g is None:
        raise ValueError("a training-mode DropPath / Dropout needs a "
                         "torch.Generator")
    u = torch.rand(shape, generator=g, device=g.device)
    return (u < keep).to(like.device, like.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample (timm semantics): in training, each
    sample's branch is zeroed with probability ``drop_prob`` and the kept
    ones scaled by 1 / (1 - drop_prob)."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = float(drop_prob)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.drop_prob == 0.0:
            return x
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return x * _keep_mask(shape, keep, generator, x) / keep


class Dropout(nn.Module):
    """Elementwise dropout (flax ``nn.Dropout``) drawing from a generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return x * _keep_mask(x.shape, keep, generator, x) / keep


class Embedding(nn.Module):
    """A ``weight`` table initialised N(0, 1) (flax normal(1.0))."""

    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device))

    def _init_params(self, g):
        normal_(self.weight, 1.0, g)


class Mlp(nn.Module):
    """build_MLP: Linear-ReLU x (num_layers - 1) -> Linear."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], dtype=dtype, device=device)
            for i in range(num_layers))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FFN(nn.Module):
    """mmcv FFN with two fcs (keys ``layers.0.0`` and ``layers.1``):
    identity + drop_path(drop(fc1(drop(act(fc0(x)))))). ``drop`` is the
    dropout after the activation and after fc1 (mmcv ``ffn_drop``, Swin's
    ``drop_rate``); ``drop_path`` the Swin block's stochastic depth."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 act: Callable = F.relu, drop: float = 0.0,
                 drop_path: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Linear(embed_dims, feedforward_channels,
                                  dtype=dtype, device=device)]),
            Linear(feedforward_channels, embed_dims, dtype=dtype,
                   device=device)])
        self.act = act
        self.dropout = Dropout(drop)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, identity: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        out = self.dropout(self.act(self.layers[0][0](x)), generator)
        out = self.dropout(self.layers[1](out), generator)
        out = self.drop_path(out, generator)
        return (x if identity is None else identity) + out
