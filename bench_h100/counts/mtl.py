"""Model FLOPs of the multi-task model's serving forwards, from the
configuration's widths and the request's shapes: every matrix product
(linears, convolutions, attention products) and the deformable sampling,
as 2 operations per multiply-add; norms, softmaxes and elementwise work are
not counted. Also the kernel calls a forward makes, with their shapes, for
the rooflines.

What is counted is what the serving output needs: the Swin blocks over
their padded windows (the model pads), the neck, the encoder, the
two-stage proposals, every decoder layer with its box refinement and the
last layer's class and box branches.
"""

from __future__ import annotations

from bench_h100.counts import kernels


def _ceil_to(x, m):
    return -(-x // m) * m


def swin(bcfg, B, H, W):
    """-> (flops, [K2 call shapes], [(h, w, C)] of the stage outputs)."""
    C0 = bcfg.get("embed_dims", 96)
    win = bcfg.get("window_size", 7)
    mlp = bcfg.get("mlp_ratio", 4)
    h, w = -(-H // 4), -(-W // 4)
    flops = 2 * B * h * w * C0 * 3 * 16
    calls, outs = [], []
    C = C0
    for si, depth in enumerate(bcfg["depths"]):
        heads = bcfg["num_heads"][si]
        hd = C // heads
        Hp, Wp = _ceil_to(h, win), _ceil_to(w, win)
        nW, n = (Hp // win) * (Wp // win), win * win
        for bi in range(depth):
            masked = bi % 2 == 1 and min(h, w) > win
            flops += 2 * B * Hp * Wp * C * 3 * C          # qkv
            flops += 4 * B * nW * heads * n * n * hd      # q k^T, P v
            flops += 2 * B * Hp * Wp * C * C              # proj
            flops += 2 * 2 * B * h * w * C * mlp * C      # mlp
            calls.append(dict(B=B, nW=nW, H=heads, n=n, hd=hd,
                              masked=masked))
        outs.append((h, w, C))
        if si < len(bcfg["depths"]) - 1:
            h, w = -(-h // 2), -(-w // 2)
            flops += 2 * B * h * w * 4 * C * 2 * C        # patch merging
            C *= 2
    return flops, calls, outs


def resnet(bcfg, B, H, W):
    """-> (flops, [], [(h, w, C)] of the ``out_indices`` maps): pytorch-style
    bottlenecks, the stride in the 3x3 conv."""
    depth = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[bcfg.get("depth", 50)]
    h, w = -(-H // 2), -(-W // 2)
    flops = 2 * B * h * w * 64 * 3 * 49
    h, w = -(-h // 2), -(-w // 2)
    cin, outs = 64, []
    for si, nb in enumerate(depth[:bcfg.get("num_stages", 4)]):
        p = 64 * 2 ** si
        for bi in range(nb):
            s = 1 if si == 0 or bi else 2
            ho, wo = -(-h // s), -(-w // s)
            flops += 2 * B * h * w * cin * p            # conv1 1x1
            flops += 2 * B * ho * wo * p * p * 9        # conv2 3x3
            flops += 2 * B * ho * wo * p * 4 * p        # conv3 1x1
            if bi == 0:
                flops += 2 * B * ho * wo * cin * 4 * p  # downsample
            h, w, cin = ho, wo, 4 * p
        if si in bcfg.get("out_indices", (0, 1, 2, 3)):
            outs.append((h, w, cin))
    return flops, [], outs


def backbone(bcfg, B, H, W):
    fn = resnet if bcfg["type"] == "ResNet" else swin
    return fn(bcfg, B, H, W)


def det(mcfg, B, H, W):
    """-> (flops, {"msda_fwd": [...], "window_attn_fwd": [...]}) of one
    call of the det serving forward on B tiles of H x W."""
    flops, k2, outs = backbone(mcfg["backbone"], B, H, W)
    ncfg = mcfg["neck"]
    Cn = ncfg["out_channels"]
    lv = []
    for (h, w, C) in outs[len(outs) - len(ncfg["in_channels"]):]:
        flops += 2 * B * h * w * C * Cn
        lv.append((h, w))
    h, w, C = outs[-1]
    for j in range(ncfg["num_outs"] - len(ncfg["in_channels"])):
        h, w = -(-h // 2), -(-w // 2)
        flops += 2 * B * h * w * (C if j == 0 else Cn) * 9 * Cn
        lv.append((h, w))
    S = sum(h * w for h, w in lv)
    ecfg = mcfg["shared_encoder"]
    attn = ecfg["transformerlayers"]["attn_cfgs"]
    F_ = ecfg["transformerlayers"]["ffn_cfgs"].get("feedforward_channels",
                                                   2048)
    He, L, Pn = attn.get("num_heads", 8), attn.get("num_levels", 4), \
        attn.get("num_points", 4)
    k1 = []

    def msda_layer(Q, heads):
        f = 2 * B * S * Cn * Cn                            # value_proj
        f += 2 * B * Q * Cn * heads * L * Pn * 3           # offsets, weights
        k, _ = kernels.msda_fwd(B, Q, S, heads, Cn // heads, L, Pn)
        f += k + 2 * B * Q * Cn * Cn                       # sample, out_proj
        k1.append(dict(B=B, Q=Q, Nv=S, H=heads, D=Cn // heads, L=L, P=Pn))
        return f

    for _ in range(ecfg["num_layers"]):
        flops += msda_layer(S, He) + 4 * B * S * Cn * F_
    hcfg = mcfg["bbox_head"]
    K, Nq = hcfg["num_classes"], hcfg["num_query"]
    reg = 2 * (2 * Cn * Cn + 4 * Cn)
    flops += 2 * B * S * Cn * Cn + 2 * B * S * Cn * K + B * S * reg
    dcfg = hcfg["transformer"]["decoder"]
    Fd = dcfg["transformerlayers"]["ffn_cfgs"].get("feedforward_channels",
                                                   2048)
    for _ in range(dcfg.get("num_layers", 6)):
        flops += 2 * B * Nq * (2 * Cn * Cn + Cn * Cn)      # ref_point_head
        flops += 2 * B * Nq * Cn * 4 * Cn + 4 * B * Nq * Nq * Cn  # self-attn
        flops += msda_layer(Nq, 8) + 4 * B * Nq * Cn * Fd
        flops += B * Nq * reg                              # refinement
    flops += 2 * B * Nq * Cn * K + B * Nq * reg            # last branches
    return flops, {"msda_fwd": k1, "window_attn_fwd": k2}


def cls(mcfg, B, H, W):
    flops, k2, outs = backbone(mcfg["backbone"], B, H, W)
    C = outs[-1][2]
    flops += 2 * B * C * mcfg["cls_head"]["num_classes"]
    return flops, {"msda_fwd": [], "window_attn_fwd": k2}
