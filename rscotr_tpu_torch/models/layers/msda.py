"""MultiScaleDeformableAttention module (PyTorch counterpart of
rscotr_tpu/models/layers/msda.py; mmcv key layout ``sampling_offsets``,
``attention_weights``, ``value_proj``, ``output_proj``).

The sampling core is rscotr_tpu_torch.ops.ms_deform_attn (kernel K1 on
CUDA). Init: sampling_offsets weight zero with the rotational grid bias,
attention_weights zero, value/output projections flax-default. In training
mode a non-zero ``dropout`` drops entries of ``output_proj``'s output before
the residual add, as JAX's layer does, drawing from the ``generator`` given
to ``forward``. Under
tensor parallelism (``parallel/tp.py``) ``value_proj`` is column-sharded:
the layer runs the kernel on this rank's heads and ``output_proj``
(row-sharded) sums them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rscotr_tpu_torch.models.layers.common import Dropout, Linear, constant_
from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn


def sampling_offsets_bias(num_heads: int, num_levels: int,
                          num_points: int) -> torch.Tensor:
    """Rotational grid (mmcv MultiScaleDeformableAttention.init_weights)."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (
        2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    grid = grid * torch.arange(1, num_points + 1,
                               dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


class MultiScaleDeformableAttention(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 dropout: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        C, H, L, P = embed_dims, num_heads, num_levels, num_points
        self.num_heads, self.num_levels, self.num_points = H, L, P
        self.sampling_offsets = Linear(C, H * L * P * 2, dtype=dtype,
                                       device=device)
        self.attention_weights = Linear(C, H * L * P, dtype=dtype,
                                        device=device)
        self.value_proj = Linear(C, C, dtype=dtype, device=device)
        self.output_proj = Linear(C, C, dtype=dtype, device=device)
        self.dropout = Dropout(dropout)

    def _init_params(self, g):
        constant_(self.sampling_offsets.weight, 0.0)
        b = self.sampling_offsets.bias
        if not b.is_meta:
            with torch.no_grad():
                b.copy_(sampling_offsets_bias(self.num_heads, self.num_levels,
                                              self.num_points))
        constant_(self.attention_weights.weight, 0.0)
        constant_(self.attention_weights.bias, 0.0)

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                query_pos: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                reference_points: Optional[torch.Tensor] = None,
                spatial_shapes: Sequence[Tuple[int, int]] = (),
                generator: Optional[torch.Generator] = None):
        """
        Args:
            query: (B, Nq, C). value: (B, Nv, C).
            reference_points: (B, Nq, num_levels, 2) normalized centres or
                (B, Nq, num_levels, 4) normalized cxcywh boxes.
            key_padding_mask: (B, Nv) bool, True = padded.
            spatial_shapes: per-level (H, W).
            generator: the dropout's draws (training mode only).
        """
        identity = query
        if query_pos is not None:
            query = query + query_pos
        B, Nq, C = query.shape
        Nv = value.shape[1]
        H, L, P = self.num_heads, self.num_levels, self.num_points
        if len(spatial_shapes) != L or \
                sum(h * w for h, w in spatial_shapes) != Nv:
            raise ValueError(f"spatial_shapes {spatial_shapes} do not match "
                             f"{L} levels / {Nv} value rows")

        v = self.value_proj(value)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        offsets = self.sampling_offsets(query).reshape(B, Nq, H, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Nq, H, L * P)
        attn = attn.softmax(-1).reshape(B, Nq, H, L, P)
        if v.shape[-1] != C:
            # tensor parallelism (parallel/tp.py): value_proj gave this
            # rank's heads [h0, h0 + H); the offsets and weights of every
            # head are sliced to them, their gradients summed over the ranks
            from rscotr_tpu_torch.parallel.tp import sum_grad_over_tp
            mesh = self.value_proj.weight.device_mesh
            Hl = v.shape[-1] // (C // H)
            h0 = mesh.get_local_rank() * Hl
            offsets = sum_grad_over_tp(offsets, mesh)[:, :, h0:h0 + Hl]
            attn = sum_grad_over_tp(attn, mesh)[:, :, h0:h0 + Hl]
            H = Hl
        v = v.reshape(B, Nv, H, C // self.num_heads)

        ref = reference_points[:, :, None, :, None, :]
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                      dtype=torch.float32,
                                      device=query.device)
            locs = ref + offsets / normalizer[None, None, None, :, None, :]
        elif reference_points.shape[-1] == 4:
            locs = ref[..., :2] + offsets / P * ref[..., 2:] * 0.5
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(v, spatial_shapes, locs, attn)
        return identity + self.dropout(self.output_proj(out), generator)
