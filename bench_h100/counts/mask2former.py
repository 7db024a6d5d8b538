"""Model FLOPs of Mask2Former's semantic segmentation request, from the
configuration's widths and the tiles' shapes: every matrix product
(linears, convolutions, attention products, the mask and class products)
and the deformable sampling, as 2 operations per multiply-add; norms,
softmaxes, resizes and elementwise work are not counted, as in
``counts/mtl.py``. Also the kernel calls the forward makes, with their
shapes, for the rooflines.

What is counted is what the served label map needs: the Swin blocks over
their padded windows (``counts/mtl.py``'s ``swin``), the pixel decoder's
input projections, encoder and FPN, the decoder's queries through every
masked-attention layer with the mask prediction before each layer and
after the last, the last layer's class head, and the semantic product of
class probabilities and upsampled masks at the tile size.
"""

from __future__ import annotations

from bench_h100.counts import kernels
from bench_h100.counts.mtl import swin


def seg(mcfg, B, H, W):
    """-> (flops, {"msda_fwd": [...], "window_attn_fwd": [...]}) of one
    call of the seg serving forward on B tiles of H x W."""
    flops, k2, outs = swin(mcfg["backbone"], B, H, W)
    hcfg = mcfg.get("decode_head") or mcfg["seg_head"]
    ecfg = mcfg.get("encoder") or mcfg["shared_encoder"]
    L, C = hcfg["num_transformer_feat_level"], hcfg["feat_channels"]
    Q, K = hcfg["num_queries"], hcfg["num_classes"]
    # the encoder's levels, low -> high resolution
    enc = list(reversed(outs[len(outs) - L:]))
    for h, w, Cin in enc:
        flops += 2 * B * h * w * Cin * C                  # input conv
    S = sum(h * w for h, w, _ in enc)
    attn = ecfg["transformerlayers"]["attn_cfgs"]
    He, Le, Pn = attn.get("num_heads", 8), attn.get("num_levels", 4), \
        attn.get("num_points", 4)
    F_ = ecfg["transformerlayers"]["ffn_cfgs"]["feedforward_channels"]
    k1 = []
    for _ in range(ecfg["num_layers"]):
        flops += 2 * 2 * B * S * C * C                    # value, output
        flops += 2 * B * S * C * He * Le * Pn * 3         # offsets, weights
        flops += kernels.msda_fwd(B, S, S, He, C // He, Le, Pn)[0]
        flops += 2 * 2 * B * S * C * F_                   # FFN
        k1.append(dict(B=B, Q=S, Nv=S, H=He, D=C // He, L=Le, P=Pn))
    fine = outs[:len(outs) - L]
    for h, w, Cin in reversed(fine):
        flops += 2 * B * h * w * Cin * C                  # lateral 1x1
        flops += 2 * B * h * w * C * C * 9                # output 3x3
    hm, wm, _ = outs[0]
    flops += 2 * B * hm * wm * C * hcfg["out_channels"]   # mask feature
    td = hcfg["transformer_decoder"]
    Fd = td["transformerlayers"]["ffn_cfgs"]["feedforward_channels"]
    Cm = hcfg["out_channels"]

    def prediction():
        return 2 * B * Q * C * (2 * C + Cm) + 2 * B * Q * Cm * hm * wm

    flops += prediction()
    for i in range(td["num_layers"]):
        h, w, _ = enc[i % L]
        Sl = h * w
        flops += 2 * B * (2 * Q + 2 * Sl) * C * C         # cross q, k, v, out
        flops += 2 * 2 * B * Q * Sl * C                   # q k^T, P v
        flops += 2 * 4 * B * Q * C * C + 2 * 2 * B * Q * Q * C  # self-attn
        flops += 2 * 2 * B * Q * C * Fd                   # FFN
        flops += prediction()
    flops += 2 * B * Q * C * (K + 1)                      # class head
    flops += 2 * B * H * W * Q * K                        # semantic product
    return flops, {"msda_fwd": k1, "window_attn_fwd": k2}
