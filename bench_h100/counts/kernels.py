"""Operations and bytes of one call of each hand-written kernel on the
model path, from its shapes.

* K1, multi-scale deformable attention forward: a multiply-add per channel
  of each of the 4 bilinear corners of every (image, query, head, level,
  point); reads value (B, Nv, H, D), locations (B, Q, H, L, P, 2) in
  float32 and weights (B, Q, H, L, P), writes (B, Q, H*D).
* K2, window attention forward: q k^T and P v, ``2 n^2 hd`` each, per
  (image, window, head) tile; reads q, k, v, the relative bias (H, n, n)
  in float32 and, in a shifted block, the mask (nW, n, n) in float32;
  writes (B, nW, H, n, hd).

``act`` is the byte width of the compute dtype (2 for bfloat16).
"""

from __future__ import annotations


def msda_fwd(B, Q, Nv, H, D, L, P, act=2):
    corners = 4 * B * Q * H * L * P
    flops = 2 * D * corners
    nbytes = (B * Nv * H * D * act + B * Q * H * L * P * 2 * 4 +
              B * Q * H * L * P * act + B * Q * H * D * act)
    return flops, nbytes


def window_attn_fwd(B, nW, H, n, hd, masked, act=2):
    tiles = B * nW * H
    flops = 4 * n * n * hd * tiles
    nbytes = (4 * tiles * n * hd * act + H * n * n * 4 +
              (nW * n * n * 4 if masked else 0))
    return flops, nbytes


def bound_s(flops, nbytes, peak_flops, peak_bytes_s):
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes_s)
