"""Swin Transformer backbone (PyTorch counterpart of
rscotr_tpu/models/backbones/swin.py, NHWC activations).

Parameter names follow mmdet's SwinTransformer (``patch_embed.proj/norm``,
``stages.{s}.blocks.{b}.attn.w_msa.*``, ``ffn.layers.*``,
``stages.{s}.downsample.*``, ``norm{s}``), so the reference's checkpoints and
``rscotr_tpu_torch.utils.convert.state_dict_from_jax`` load without a map.

* The window-attention core goes through ``ops.window_attention`` (kernel K2
  on CUDA).
* PatchMerging keeps mmdet's unfold channel order (column = c * 4 + 2*dy +
  dx), the order its weights are stored in; the JAX module gathers
  [x00; x10; x01; x11] and its converter permutes the weights instead.
* Maps are padded to a multiple of the window; the shift is off when
  min(H, W) <= window. LayerNorm eps 1e-5; exact (erf) GELU.
* In training mode (``model.train()``) the blocks apply stochastic depth
  with the linearly increasing ``drop_path_rate`` schedule, and dropout at
  ``drop_rate``, drawing from the ``generator`` passed to ``forward``.
  Attention dropout (``attn_drop_rate``) is not supported: the K2 kernels
  have none.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rscotr_tpu_torch.models.layers.common import (FFN, Conv2d, DropPath,
                                                   Dropout, LayerNorm, Linear,
                                                   drop_path_rates,
                                                   trunc_normal_)
from rscotr_tpu_torch.ops.window_attention import window_attention


def _rel_pos_index(window_size: int) -> np.ndarray:
    """Relative-position index table, (w*w, w*w) int."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1).astype(np.int64)


def _shift_attn_mask(Hp: int, Wp: int, window: int,
                     shift: int) -> np.ndarray:
    """Additive attention mask for shifted windows, (nW, n, n), -100 fill."""
    img_mask = np.zeros((Hp, Wp), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(Hp // window, window, Wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return (m[:, None, :] != m[:, :, None]).astype(np.float32) * -100.0


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C); H, W divisible by window."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_unpartition(x: torch.Tensor, window: int, H: int, W: int,
                       B: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowMSA(nn.Module):
    """Window multi-head self-attention (mmdet ``WindowMSA`` names)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, qk_scale=None, proj_drop: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, \
            window_size
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window_size - 1) ** 2, num_heads, device=device))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_rel_pos_index(window_size).reshape(-1),
                            device=device), persistent=False)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype,
                          device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)
        self.proj_drop = Dropout(proj_drop)

    def _init_params(self, g):
        trunc_normal_(self.relative_position_bias_table, 0.02, g)

    def forward(self, x, nW: int, mask=None, generator=None):
        """x: (B_, n, C) windows, B_ = images * nW; mask (nW, n, n) or None."""
        B_, n, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B_, n, 3, H, hd).permute(2, 0, 3, 1, 4)
        rel_bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, H).permute(2, 0, 1)
        q, k, v = (t.unflatten(0, (B_ // nW, nW)) for t in qkv.unbind(0))
        out = window_attention(q, k, v, rel_bias.contiguous(), mask,
                               self.scale)                # (B, nW, H, n, hd)
        out = out.reshape(B_, H, n, hd).transpose(1, 2).reshape(B_, n, C)
        return self.proj_drop(self.proj(out), generator)


class ShiftWindowMSA(nn.Module):
    """Holder giving mmdet's ``attn.w_msa`` key prefix."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.w_msa = WindowMSA(*args, **kwargs)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale=None, drop: float = 0.0,
                 drop_path: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, qkv_bias,
                                   qk_scale, proj_drop=drop, dtype=dtype,
                                   device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, device=device)
        self.ffn = FFN(dim, int(dim * mlp_ratio),
                       act=lambda t: F.gelu(t, approximate="none"),
                       drop=drop, drop_path=drop_path, dtype=dtype,
                       device=device)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, Hp, Wp, shift, device):
        key = (Hp, Wp, shift, device)
        if key not in self._masks:
            # a normal tensor even when first made under inference_mode, so
            # that a training step after a request can save it for backward
            with torch.inference_mode(False):
                self._masks[key] = torch.as_tensor(
                    _shift_attn_mask(Hp, Wp, self.window_size, shift),
                    device=device)
        return self._masks[key]

    def forward(self, x, generator=None):
        """x: (B, H, W, C)."""
        B, H, W, C = x.shape
        win = self.window_size
        shift = self.shift if min(H, W) > win else 0

        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (win - H % win) % win, (win - W % win) % win
        Hp, Wp = H + pad_b, W + pad_r
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self._mask(Hp, Wp, shift, x.device)
        else:
            mask = None
        nW = (Hp // win) * (Wp // win)
        xw = self.attn.w_msa(window_partition(x, win), nW, mask, generator)
        x = window_unpartition(xw, win, Hp, Wp, B)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :H, :W], generator)
        return self.ffn(self.norm2(x), identity=x, generator=generator)


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C), mmdet unfold order."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, device=device)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype,
                                device=device)

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        Ho, Wo = x.shape[1] // 2, x.shape[2] // 2
        x = x.reshape(B, Ho, 2, Wo, 2, C).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(B, Ho, Wo, 4 * C)))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dims: int, patch_size: int, patch_norm: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dims, patch_size, stride=patch_size,
                           dtype=dtype, device=device)
        self.norm = LayerNorm(embed_dims, device=device) if patch_norm \
            else None

    def forward(self, x):
        ps = self.patch_size
        H, W = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, (ps - W % ps) % ps, 0, (ps - H % ps) % ps))
        x = self.proj(x)
        return self.norm(x) if self.norm is not None else x


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin backbone returning per-stage NHWC maps for ``out_indices``.
    Dropout and drop-path are identity at inference (eval mode)."""

    def __init__(self, embed_dims: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 4,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale=None, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, patch_norm: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dims, patch_size, patch_norm,
                                      dtype=dtype, device=device)
        self.drop = Dropout(drop_rate)
        dprs = drop_path_rates(drop_path_rate, depths)
        stages = []
        dim = embed_dims
        for si, depth in enumerate(depths):
            blocks = [SwinBlock(dim, num_heads[si], window_size,
                                shift=0 if bi % 2 == 0 else window_size // 2,
                                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                                qk_scale=qk_scale, drop=drop_rate,
                                drop_path=dprs[si][bi], dtype=dtype,
                                device=device)
                      for bi in range(depth)]
            down = (PatchMerging(dim, dtype=dtype, device=device)
                    if si < len(depths) - 1 else None)
            stages.append(SwinStage(blocks, down))
            if si in self.out_indices:
                self.add_module(f"norm{si}", LayerNorm(dim, device=device))
            if down is not None:
                dim *= 2
        self.stages = nn.ModuleList(stages)

    def out_hw(self, hw):
        """The (h, w) of each returned map for an (H, W) input: the patch
        embedding pads to a multiple of the patch, each patch merging to an
        even size."""
        ps = self.patch_embed.patch_size
        h, w = -(-int(hw[0]) // ps), -(-int(hw[1]) // ps)
        outs = []
        for si in range(len(self.stages)):
            if si in self.out_indices:
                outs.append((h, w))
            h, w = -(-h // 2), -(-w // 2)
        return outs

    def forward(self, x, generator=None):
        """x: (B, H, W, 3) -> tuple of (B, H/s, W/s, C_i)."""
        x = self.drop(self.patch_embed(x), generator)
        outs = []
        for si, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x, generator)
            if si in self.out_indices:
                outs.append(getattr(self, f"norm{si}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)
