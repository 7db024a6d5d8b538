"""Operation counts of the port's four model-path kernels, in one place.

The functions below are what ``chip_smoke.py`` divides by the card's peak
rate for each kernel's bound, and what the FLOP formulas registered here
for ``torch.utils.flop_counter.FlopCounterMode`` count, so that a
``FlopCounterMode`` over a step (``tools/benchmark.py``) sees the kernels
that it otherwise cannot: the operators are opaque to it, and their bodies
are not counted a second time.

* K2 (``rscotr_torch::window_attn_fwd``): ``4 n^2 hd`` per (image, window,
  head) tile, the two products q k^T and P v;
* K2b (``rscotr_torch::window_attn_bwd``): ``10 n^2 hd`` per tile, five
  products (S, dP, dV, dQ, dK);
* K1 (``rscotr_torch::msda_fwd``): ``2 D`` per corner sample, a
  multiply-add per channel;
* K1b (``rscotr_torch::msda_bwd``): ``4 D`` per corner sample, the
  multiply-add of <V_c, d_out> and the product and add into d_value.

An operator cannot know which bilinear corners fall on the map, so its
formula counts all 4 corners of every (image, query, head, level, point);
``chip_smoke.py``'s bounds count the corners that this run's locations put
on the map (``corners`` is the caller's).

Importing ``rscotr_tpu_torch.ops`` registers the formulas, once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from rscotr_tpu_torch.ops import ms_deform_attn as _msda  # noqa: F401
from rscotr_tpu_torch.ops import window_attention as _wa  # noqa: F401


def window_attn_flops(tiles: int, n: int, hd: int) -> int:
    """K2: q k^T and P v, ``2 n^2 hd`` each, per tile."""
    return 4 * n * n * hd * tiles


def window_attn_bwd_flops(tiles: int, n: int, hd: int) -> int:
    """K2b: five ``n x n x hd`` products per tile."""
    return 10 * n * n * hd * tiles


def msda_fwd_flops(corners: int, head_dim: int) -> int:
    """K1: one multiply-add per channel of each corner sample."""
    return 2 * head_dim * corners


def msda_bwd_flops(corners: int, head_dim: int) -> int:
    """K1b: per corner sample and channel, the multiply-add of
    <V_c, d_out> and the product and add into d_value."""
    return 4 * head_dim * corners


def msda_corners(loc_shape) -> int:
    """All 4 bilinear corners of each (b, q, h, level, point) of a
    ``(B, Q, H, L, P, 2)`` sampling-location shape."""
    B, Q, H, L, P, _ = loc_shape
    return 4 * B * Q * H * L * P


def _tiles(q_shape):
    B, nW, H, n, hd = q_shape
    return B * nW * H, n, hd


@register_flop_formula(torch.ops.rscotr_torch.window_attn_fwd)
def _window_attn_fwd_formula(q_shape, *args, out_shape=None, **kwargs):
    return window_attn_flops(*_tiles(q_shape))


@register_flop_formula(torch.ops.rscotr_torch.window_attn_bwd)
def _window_attn_bwd_formula(q_shape, *args, out_shape=None, **kwargs):
    return window_attn_bwd_flops(*_tiles(q_shape))


@register_flop_formula(torch.ops.rscotr_torch.msda_fwd)
def _msda_fwd_formula(value_shape, spatial_shapes, loc_shape, *args,
                      out_shape=None, **kwargs):
    return msda_fwd_flops(msda_corners(loc_shape), value_shape[-1])


@register_flop_formula(torch.ops.rscotr_torch.msda_bwd)
def _msda_bwd_formula(value_shape, spatial_shapes, loc_shape, *args,
                      out_shape=None, **kwargs):
    return msda_bwd_flops(msda_corners(loc_shape), value_shape[-1])
