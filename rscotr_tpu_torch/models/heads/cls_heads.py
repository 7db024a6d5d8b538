"""Classification heads (PyTorch counterpart of
rscotr_tpu/models/heads/cls_heads.py).

* ``SlvlClsHead``: GAP of the last backbone map -> Linear; the neck and the
  encoder are unused.
* ``MlvlClsHead``: the neck levels through the shared encoder
  (``MlvlClsPixelDecoder``), then one of 8 token-pooling schemes -> Linear.
  Schemes 5-7 pool the tokens of level 0, of level 1 or of all levels
  (low -> high resolution) with a learned (n, 1) weight, scheme 8 the
  levels' GAP tokens with an (L, 1) one; flax sizes them from the input at
  init, so the port takes the per-level token counts when it is built
  (``build_model``'s ``cls_hw``). They initialise to 1/n and 0, and are
  the state dict's ``out_proj.weight`` (1, n) and ``out_proj.bias``. The
  pooling runs in float32 (a parameter product, not a Dense).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from rscotr_tpu_torch.models.heads.pixel_decoders import MlvlClsPixelDecoder
from rscotr_tpu_torch.models.layers.common import Linear, constant_


class SlvlClsHead(nn.Module):
    """GAP(backbone[-1]) -> Linear(num_classes); the encoder is unused."""

    def __init__(self, num_classes: int = 45, in_channels: int = 768,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fc = Linear(in_channels, num_classes, dtype=dtype, device=device)

    def forward(self, backbone_feats):
        return self.fc(backbone_feats[-1].mean(dim=(1, 2)))


class _OutProj(nn.Module):
    """The pooling weight over n tokens: ``weight`` (1, n) = 1/n, ``bias``
    (1,) = 0."""

    def __init__(self, n: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, n, device=device))
        self.bias = nn.Parameter(torch.empty(1, device=device))

    def _init_params(self, g):
        constant_(self.weight, 1.0 / self.weight.shape[1])
        constant_(self.bias, 0.0)


class MlvlClsHead(nn.Module):
    """Shared-encoder multi-level head with pooling scheme 1..8.

    ``token_counts``: h * w of each encoder level, low -> high resolution,
    at the cls input size; schemes 5-7 need it to size ``out_proj``."""

    def __init__(self, num_classes: int = 45, scheme: int = 5,
                 num_encoder_levels: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64),
                 feat_channels: int = 256,
                 token_counts: Optional[Sequence[int]] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if scheme not in range(1, 9):
            raise ValueError(f"unknown scheme {scheme}")
        self.scheme = scheme
        self.pixel_decoder = MlvlClsPixelDecoder(
            num_encoder_levels, strides, feat_channels, device=device)
        n = None
        if scheme in (5, 6, 7):
            if token_counts is None:
                raise ValueError(
                    f"MlvlClsHead scheme {scheme} sizes its out_proj from "
                    "the cls input: pass cls_hw to build_model (or leave "
                    "cls out of its tasks)")
            n = {5: token_counts[0], 6: token_counts[1],
                 7: sum(token_counts)}[scheme]
        elif scheme == 8:
            n = num_encoder_levels
        self.out_proj = _OutProj(n, device=device) if n else None
        self.fc = Linear(feat_channels, num_classes, dtype=dtype,
                         device=device)

    def _pool(self, seq):
        """(B, n, C) -> (B, C): the tokens weighted by ``out_proj``."""
        w = self.out_proj.weight
        if seq.shape[1] != w.shape[1]:
            raise ValueError(
                f"MlvlClsHead scheme {self.scheme}: {seq.shape[1]} tokens, "
                f"out_proj was built for {w.shape[1]} (build_model's cls_hw)")
        return torch.einsum("bnc,kn->bkc", seq, w)[:, 0] + self.out_proj.bias

    def _pre_logits(self, mlvl):
        s = self.scheme
        flat = [f.reshape(f.shape[0], -1, f.shape[-1]) for f in mlvl]
        if s == 1:
            return mlvl[0].mean(dim=(1, 2))
        if s == 2:
            return mlvl[1].mean(dim=(1, 2))
        if s == 3:
            return torch.cat(flat, 1).mean(1)
        if s == 4:
            return sum(f.mean(dim=(1, 2)) for f in mlvl) / len(mlvl)
        if s in (5, 6):
            return self._pool(flat[0 if s == 5 else 1])
        if s == 7:
            return self._pool(torch.cat(flat, 1))
        toks = torch.stack([f.mean(dim=(1, 2)) for f in mlvl], -1)
        return torch.matmul(toks, self.out_proj.weight[0]) + \
            self.out_proj.bias

    def forward(self, neck_feats, encode_fn: Callable):
        return self.fc(self._pre_logits(self.pixel_decoder(encode_fn,
                                                           neck_feats)))
