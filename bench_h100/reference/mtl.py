"""Plain PyTorch reference of the multi-task model's serving forwards.

Written from the published architecture (Swin Transformer, arXiv:2103.14030;
ResNet, arXiv:1512.03385;
ChannelMapper and the two-stage, box-refining DINO head, arXiv:2203.03605,
with deformable attention from Deformable DETR, arXiv:2010.04159) over a
flat state dict in the mmdet key layout. It imports nothing of the program:
every table (relative positions, shift masks, sine encodings, proposals) is
worked out here again, the deformable sampling is ``grid_sample``, and every
matrix product runs in float32 with TF32 off.

``Precision`` decides what the matrix products see. ``"f32"`` is the
reference. ``"fp8"`` is the control: each operand of a linear, a convolution
and an attention product is rounded to float8 e4m3 with one scale per tensor
(its absolute maximum over 448) before the product, which is then taken in
float32: the step below the program's stated bfloat16 compute. Norms,
softmaxes and the sampling stay in float32 in both modes.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
FP8_MAX = 448.0


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, rounded as the mode says, in float32."""
        x = x.float()
        if self.mode == "fp8":
            scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x

    def linear(self, x, w, b=None):
        y = F.linear(self.q(x), self.q(w))
        return y if b is None else y + b.float()

    def conv(self, x, w, b=None, stride=1, padding=0):
        """x NHWC -> NHWC."""
        y = F.conv2d(self.q(x).permute(0, 3, 1, 2), self.q(w), None, stride,
                     padding).permute(0, 2, 3, 1)
        return y if b is None else y + b.float()

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def layer_norm(x, P, name, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), P[name + ".weight"],
                        P[name + ".bias"], eps)


def group_norm(x, P, name, groups, eps=1e-5):
    y = F.group_norm(x.float().permute(0, 3, 1, 2), groups,
                     P[name + ".weight"], P[name + ".bias"], eps)
    return y.permute(0, 2, 3, 1)


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=img_u8.device)
    std = torch.tensor(IMAGENET_STD, device=img_u8.device)
    return (img_u8.float() - mean) / std


# ---------------------------------------------------------------------------
# Swin Transformer
# ---------------------------------------------------------------------------

def rel_pos_index(w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    c = torch.stack([ys.reshape(-1), xs.reshape(-1)])          # (2, n)
    rel = c[:, :, None] - c[:, None, :]                          # (2, n, n)
    idx = (rel[0] + w - 1) * (2 * w - 1) + (rel[1] + w - 1)
    return idx.reshape(-1).to(device)


def shift_mask(Hp: int, Wp: int, w: int, s: int, device) -> torch.Tensor:
    """(nW, n, n) additive mask of the shifted windows, -100 across
    regions."""
    region = torch.zeros(Hp, Wp, dtype=torch.long)
    cnt = 0
    for hs in (slice(0, Hp - w), slice(Hp - w, Hp - s), slice(Hp - s, Hp)):
        for ws in (slice(0, Wp - w), slice(Wp - w, Wp - s),
                   slice(Wp - s, Wp)):
            region[hs, ws] = cnt
            cnt += 1
    m = region.reshape(Hp // w, w, Wp // w, w).permute(0, 2, 1, 3)
    m = m.reshape(-1, w * w)
    return ((m[:, None, :] != m[:, :, None]).float() * -100.0).to(device)


def swin_block(x, P, pre, heads, w, shift, pr: Precision):
    B, H, W, C = x.shape
    if min(H, W) <= w:
        shift = 0
    shortcut = x
    y = layer_norm(x, P, pre + ".norm1")
    pb, pr_ = (w - H % w) % w, (w - W % w) % w
    y = F.pad(y, (0, 0, 0, pr_, 0, pb))
    Hp, Wp = H + pb, W + pr_
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    nh, nw = Hp // w, Wp // w
    win = y.reshape(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(B * nh * nw, w * w, C)
    a = pre + ".attn.w_msa"
    n, hd = w * w, C // heads
    qkv = pr.linear(win, P[a + ".qkv.weight"], P[a + ".qkv.bias"])
    q, k, v = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    logits = pr.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    bias = P[a + ".relative_position_bias_table"][rel_pos_index(w, x.device)]
    logits = logits + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
    if shift:
        m = shift_mask(Hp, Wp, w, shift, x.device)
        logits = (logits.reshape(B, nh * nw, heads, n, n) +
                  m[None, :, None]).reshape(-1, heads, n, n)
    out = pr.matmul(logits.softmax(-1), v).transpose(1, 2).reshape(-1, n, C)
    out = pr.linear(out, P[a + ".proj.weight"], P[a + ".proj.bias"])
    out = out.reshape(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(B, Hp, Wp, C)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    x = shortcut + out[:, :H, :W]
    f = pre + ".ffn.layers"
    h = layer_norm(x, P, pre + ".norm2")
    h = F.gelu(pr.linear(h, P[f + ".0.0.weight"], P[f + ".0.0.bias"]))
    return x + pr.linear(h, P[f + ".1.weight"], P[f + ".1.bias"])


def swin(img, P, cfg, pr: Precision, pre="backbone") -> List[torch.Tensor]:
    """Normalised NHWC images -> the normed map of each stage."""
    ps, w = 4, cfg.get("window_size", 7)
    depths, heads = cfg["depths"], cfg["num_heads"]
    H, W = img.shape[1:3]
    x = F.pad(img, (0, 0, 0, (ps - W % ps) % ps, 0, (ps - H % ps) % ps))
    x = pr.conv(x, P[pre + ".patch_embed.proj.weight"],
                P[pre + ".patch_embed.proj.bias"], stride=ps)
    x = layer_norm(x, P, pre + ".patch_embed.norm")
    outs = []
    for si, depth in enumerate(depths):
        for bi in range(depth):
            x = swin_block(x, P, f"{pre}.stages.{si}.blocks.{bi}", heads[si],
                           w, 0 if bi % 2 == 0 else w // 2, pr)
        outs.append(layer_norm(x, P, f"{pre}.norm{si}"))
        if si < len(depths) - 1:
            B, H, W, C = x.shape
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            Ho, Wo = x.shape[1] // 2, x.shape[2] // 2
            x = x.reshape(B, Ho, 2, Wo, 2, C).permute(0, 1, 3, 5, 2, 4)
            x = layer_norm(x.reshape(B, Ho, Wo, 4 * C), P,
                           f"{pre}.stages.{si}.downsample.norm")
            x = pr.linear(x, P[f"{pre}.stages.{si}.downsample.reduction."
                               "weight"])
    return outs


def frozen_bn(x, P, name, B):
    """BatchNorm with running statistics ``B`` (mean, var), eps 1e-5."""
    mul = torch.rsqrt(torch.as_tensor(B[name + ".running_var"] + 1e-5)) * \
        P[name + ".weight"]
    return (x.float() - B[name + ".running_mean"]) * mul + P[name + ".bias"]


def resnet(img, P, B, cfg, pr: Precision, pre="backbone"):
    """Normalised NHWC images -> the maps of ``out_indices`` (pytorch-style
    bottlenecks, the stride in the 3x3 conv; frozen BatchNorm)."""
    depth = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[cfg.get("depth", 50)]
    x = pr.conv(img, P[pre + ".conv1.weight"], stride=2, padding=3)
    x = F.relu(frozen_bn(x, P, pre + ".bn1", B))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    outs = []
    for si, nb in enumerate(depth[:cfg.get("num_stages", 4)]):
        for bi in range(nb):
            p = f"{pre}.layer{si + 1}.{bi}"
            stride = 1 if si == 0 or bi else 2
            h = F.relu(frozen_bn(pr.conv(x, P[p + ".conv1.weight"]), P,
                                 p + ".bn1", B))
            h = F.relu(frozen_bn(pr.conv(h, P[p + ".conv2.weight"],
                                         stride=stride, padding=1), P,
                                 p + ".bn2", B))
            h = frozen_bn(pr.conv(h, P[p + ".conv3.weight"]), P, p + ".bn3",
                          B)
            if bi == 0:
                x = frozen_bn(pr.conv(x, P[p + ".downsample.0.weight"],
                                      stride=stride), P, p + ".downsample.1",
                              B)
            x = F.relu(h + x)
        if si in cfg.get("out_indices", (0, 1, 2, 3)):
            outs.append(x)
    return outs


def channel_mapper(feats, P, cfg, pr: Precision, pre="neck"):
    groups = cfg["norm_cfg"]["num_groups"]
    outs = []
    for i, f in enumerate(feats):
        y = pr.conv(f, P[f"{pre}.convs.{i}.conv.weight"])
        outs.append(group_norm(y, P, f"{pre}.convs.{i}.gn", groups))
    src = feats[-1]
    for j in range(cfg["num_outs"] - len(feats)):
        src = pr.conv(src, P[f"{pre}.extra_convs.{j}.conv.weight"], stride=2,
                      padding=1)
        src = group_norm(src, P, f"{pre}.extra_convs.{j}.gn", groups)
        outs.append(src)
    return outs


# ---------------------------------------------------------------------------
# multi-scale deformable attention and the shared encoder
# ---------------------------------------------------------------------------

def msda_sample(v, shapes, loc, attn):
    """v (B, Nv, H, D), loc (B, Q, H, L, P, 2) in [0, 1], attn (B, Q, H, L,
    P) -> (B, Q, H*D): bilinear samples, zero outside, weighted sum."""
    B, Nv, H, D = v.shape
    Q, L, Pn = loc.shape[1], loc.shape[3], loc.shape[4]
    out = 0.0
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        vl = v[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
            B * H, D, h, w)
        grid = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
            B * H, Q, Pn, 2) * 2 - 1
        s = F.grid_sample(vl, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)
        wl = attn[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * H, 1, Q, Pn)
        out = out + (s * wl).sum(-1)
        start += h * w
    return out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)


def msda(query, value, pos, ref, shapes, P, pre, heads, levels, points,
         pr: Precision):
    B, Q, C = query.shape
    q = query + pos
    v = pr.linear(value, P[pre + ".value_proj.weight"],
                  P[pre + ".value_proj.bias"])
    v = v.reshape(B, -1, heads, C // heads)
    off = pr.linear(q, P[pre + ".sampling_offsets.weight"],
                    P[pre + ".sampling_offsets.bias"]).reshape(
        B, Q, heads, levels, points, 2)
    attn = pr.linear(q, P[pre + ".attention_weights.weight"],
                     P[pre + ".attention_weights.bias"])
    attn = attn.reshape(B, Q, heads, levels * points).softmax(-1).reshape(
        B, Q, heads, levels, points)
    r = ref[:, :, None, :, None, :]
    if ref.shape[-1] == 2:
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=query.device)
        loc = r + off / norm[None, None, None, :, None, :]
    else:
        loc = r[..., :2] + off / points * r[..., 2:] * 0.5
    out = msda_sample(v, shapes, loc, attn)
    return query + pr.linear(out, P[pre + ".output_proj.weight"],
                             P[pre + ".output_proj.bias"])


def ffn(x, P, pre, pr: Precision):
    h = F.relu(pr.linear(x, P[pre + ".layers.0.0.weight"],
                         P[pre + ".layers.0.0.bias"]))
    return x + pr.linear(h, P[pre + ".layers.1.weight"],
                         P[pre + ".layers.1.bias"])


def sine_pos(h, w, B, num_feats, temperature, device):
    """Normalised sine encoding of an unpadded (h, w) map, (B, h*w, 2F)."""
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    d = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2.0 * torch.floor(d / 2.0) / num_feats)

    def enc(t):
        e = t[:, None] / dim_t
        return torch.stack([e[:, 0::2].sin(), e[:, 1::2].cos()],
                           -1).flatten(-2)
    py = enc(y)[:, None, :].expand(h, w, num_feats)
    px = enc(x)[None, :, :].expand(h, w, num_feats)
    return torch.cat([py, px], -1).reshape(1, h * w, 2 * num_feats).expand(
        B, -1, -1)


def coord_sine(pos, num_feats, temperature=10000.0):
    d = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(d / 2.0) / num_feats)

    def enc(c):
        e = (c * 2 * math.pi)[..., None] / dim_t
        return torch.stack([e[..., 0::2].sin(), e[..., 1::2].cos()],
                           -1).flatten(-2)
    parts = [enc(pos[..., 1]), enc(pos[..., 0])]
    if pos.shape[-1] == 4:
        parts += [enc(pos[..., 2]), enc(pos[..., 3])]
    return torch.cat(parts, -1)


def encoder(tokens, pos, ref, shapes, P, cfg, pr: Precision,
            pre="shared_encoder"):
    layer_cfg = cfg["transformerlayers"]["attn_cfgs"]
    heads = layer_cfg.get("num_heads", 8)
    levels = layer_cfg.get("num_levels", 4)
    points = layer_cfg.get("num_points", 4)
    x = tokens
    for i in range(cfg["num_layers"]):
        lp = f"{pre}.layers.{i}"
        x = msda(x, x, pos, ref, shapes, P, lp + ".attentions.0", heads,
                 levels, points, pr)
        x = layer_norm(x, P, lp + ".norms.0")
        x = ffn(x, P, lp + ".ffns.0", pr)
        x = layer_norm(x, P, lp + ".norms.1")
    return x


# ---------------------------------------------------------------------------
# DINO head (serving)
# ---------------------------------------------------------------------------

def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))


def mha(x, pos, P, pre, heads, pr: Precision):
    B, N, C = x.shape
    hd = C // heads
    w, b = P[pre + ".attn.in_proj_weight"], P[pre + ".attn.in_proj_bias"]
    qk = x + pos
    q = pr.linear(qk, w[:C], b[:C]).reshape(B, N, heads, hd).transpose(1, 2)
    k = pr.linear(qk, w[C:2 * C], b[C:2 * C]).reshape(B, N, heads,
                                                      hd).transpose(1, 2)
    v = pr.linear(x, w[2 * C:], b[2 * C:]).reshape(B, N, heads,
                                                   hd).transpose(1, 2)
    a = (pr.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)).softmax(-1)
    out = pr.matmul(a, v).transpose(1, 2).reshape(B, N, C)
    return x + pr.linear(out, P[pre + ".attn.out_proj.weight"],
                         P[pre + ".attn.out_proj.bias"])


def reg_branch(x, P, pre, pr: Precision):
    h = F.relu(pr.linear(x, P[pre + ".0.weight"], P[pre + ".0.bias"]))
    h = F.relu(pr.linear(h, P[pre + ".2.weight"], P[pre + ".2.bias"]))
    return pr.linear(h, P[pre + ".4.weight"], P[pre + ".4.bias"])


def det_encode(feats, P, mcfg, pr: Precision) -> dict:
    """Neck maps of full (unpadded) images -> the encoder's memory and the
    two-stage proposals: every proposal's class logits ``enc_cls`` (B, S,
    K) and unactivated box ``enc_coord`` (B, S, 4)."""
    hcfg = mcfg["bbox_head"]
    B, C = feats[0].shape[0], feats[0].shape[-1]
    dev = feats[0].device
    temp = hcfg.get("positional_encoding", {}).get("temperature", 20)
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    toks = torch.cat([f.reshape(B, -1, C) for f in feats], 1)
    pos = torch.cat([sine_pos(h, w, B, C // 2, temp, dev) +
                     P["bbox_head.transformer.level_embeds"][lvl]
                     for lvl, (h, w) in enumerate(shapes)], 1)
    refs, props = [], []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, device=dev, dtype=torch.float32) + 0.5,
            torch.arange(w, device=dev, dtype=torch.float32) + 0.5,
            indexing="ij")
        grid = torch.stack([gx.reshape(-1) / w, gy.reshape(-1) / h], -1)
        refs.append(grid)
        props.append(torch.cat(
            [grid, torch.full_like(grid, 0.05 * 2.0 ** lvl)], -1))
    ref = torch.cat(refs, 0)[None, :, None, :].expand(B, -1, len(shapes), 2)
    memory = encoder(toks, pos, ref, shapes, P, mcfg["shared_encoder"], pr)
    props = torch.cat(props, 0)[None].expand(B, -1, -1)
    valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
    props_unact = torch.log(props / (1.0 - props)).masked_fill(~valid, 1e4)
    mem = memory.masked_fill(~valid, 0.0)
    tr = "bbox_head.transformer"
    out_mem = layer_norm(pr.linear(mem, P[tr + ".enc_output.weight"],
                                   P[tr + ".enc_output.bias"]),
                         P, tr + ".enc_output_norm")
    L = hcfg["transformer"]["decoder"].get("num_layers", 6)
    enc_cls = pr.linear(out_mem, P[f"bbox_head.cls_branches.{L}.weight"],
                        P[f"bbox_head.cls_branches.{L}.bias"])
    enc_coord = reg_branch(out_mem, P, f"bbox_head.reg_branches.{L}", pr) + \
        props_unact
    return dict(memory=memory, shapes=shapes, enc_cls=enc_cls,
                enc_coord=enc_coord)


def det_select(enc: dict, mcfg) -> torch.Tensor:
    """The top ``num_query`` proposals by their largest class logit, in
    descending order, (B, Nq)."""
    nq = mcfg["bbox_head"]["num_query"]
    return enc["enc_cls"].max(-1).values.topk(nq, dim=1).indices


def det_decode(enc: dict, idx: torch.Tensor, P, mcfg, pr: Precision):
    """The decoder over the proposals ``idx`` (B, Nq), slot by slot in that
    order -> the last layer's class logits (B, Nq, K) and boxes (B, Nq, 4),
    normalised cxcywh."""
    hcfg = mcfg["bbox_head"]
    memory, shapes = enc["memory"], enc["shapes"]
    B, C = memory.shape[0], memory.shape[-1]
    L = hcfg["transformer"]["decoder"].get("num_layers", 6)
    ref_unact = enc["enc_coord"].gather(1, idx[..., None].expand(-1, -1, 4))
    msda_cfg = hcfg["transformer"]["decoder"]["transformerlayers"][
        "attn_cfgs"][1]
    levels = hcfg.get("num_feature_levels", 4)
    points = msda_cfg.get("num_points", 4)
    tr = "bbox_head.transformer"
    x = P[tr + ".query_embed.weight"][None].expand(B, -1, -1)
    r = ref_unact.sigmoid()
    dec = tr + ".decoder"
    for lid in range(L):
        lp = f"{dec}.layers.{lid}"
        ref_in = r[:, :, None, :].expand(-1, -1, levels, 4)
        qpos = pr.linear(F.relu(pr.linear(
            coord_sine(r, C // 2), P[dec + ".ref_point_head.layers.0.weight"],
            P[dec + ".ref_point_head.layers.0.bias"])),
            P[dec + ".ref_point_head.layers.1.weight"],
            P[dec + ".ref_point_head.layers.1.bias"])
        # the decoder always runs 8 heads, whatever its attention config
        x = mha(x, qpos, P, lp + ".attentions.0", 8, pr)
        x = layer_norm(x, P, lp + ".norms.0")
        x = msda(x, memory, qpos, ref_in, shapes, P, lp + ".attentions.1", 8,
                 levels, points, pr)
        x = layer_norm(x, P, lp + ".norms.1")
        x = ffn(x, P, lp + ".ffns.0", pr)
        x = layer_norm(x, P, lp + ".norms.2")
        r_prev = r
        r = (reg_branch(x, P, f"bbox_head.reg_branches.{lid}", pr) +
             inverse_sigmoid(r)).sigmoid()
    state = layer_norm(x, P, dec + ".norm")
    cls = pr.linear(state, P[f"bbox_head.cls_branches.{L - 1}.weight"],
                    P[f"bbox_head.cls_branches.{L - 1}.bias"])
    boxes = (reg_branch(state, P, f"bbox_head.reg_branches.{L - 1}", pr) +
             inverse_sigmoid(r_prev)).sigmoid()
    return cls, boxes


def backbone(img, P, mcfg, pr: Precision):
    """The configuration's backbone. ResNet's frozen BatchNorm statistics
    are mean 0 and variance 1, which the benchmark loads into the program
    too (``weights.load``)."""
    cfg = mcfg["backbone"]
    if cfg["type"] == "ResNet":
        return resnet(img, P, BNStats(), cfg, pr)
    return swin(img, P, cfg, pr)


class BNStats(dict):
    """Running statistics of every frozen BatchNorm: mean 0, variance 1."""

    def __missing__(self, key):
        return 0.0 if key.endswith("running_mean") else 1.0


def neck_feats(img_u8, P, mcfg, pr: Precision):
    bb = backbone(normalize(img_u8), P, mcfg, pr)
    n_in = len(mcfg["neck"]["in_channels"])
    return channel_mapper(bb[len(bb) - n_in:], P, mcfg["neck"], pr)


def det_encode_images(img_u8, P, mcfg, pr: Precision) -> dict:
    return det_encode(neck_feats(img_u8, P, mcfg, pr), P, mcfg, pr)


def to_pixels(boxes, H, W):
    """Normalised cxcywh -> xyxy pixels clipped to the (H, W) tile."""
    cx, cy, w, h = boxes.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    f = torch.tensor([W, H, W, H], dtype=torch.float32, device=xyxy.device)
    return torch.minimum((xyxy * f).clamp(min=0), f)


def det_serve(img_u8, P, mcfg, pr: Precision, max_per_img: int) -> dict:
    """The whole serving forward with its own selection, the program's
    outputs in kind: ``bboxes`` (B, M, 5) xyxy + score, ``labels`` (B, M),
    and the selected proposals' logits ``topk_score`` (B, Nq, K) and
    boxes ``topk_anchor`` (B, Nq, 4)."""
    enc = det_encode_images(img_u8, P, mcfg, pr)
    idx = det_select(enc, mcfg)
    cls, boxes = det_decode(enc, idx, P, mcfg, pr)
    B, Nq, K = cls.shape
    scores, top = cls.sigmoid().reshape(B, -1).topk(max_per_img, dim=1)
    q = torch.div(top, K, rounding_mode="floor")
    px = to_pixels(boxes, *img_u8.shape[1:3]).gather(
        1, q[..., None].expand(-1, -1, 4))
    K_ = enc["enc_cls"].shape[-1]
    return dict(
        bboxes=torch.cat([px, scores[..., None]], -1), labels=top % K,
        last_cls=cls, last_box=boxes,
        topk_score=enc["enc_cls"].gather(1, idx[..., None].expand(-1, -1, K_)),
        topk_anchor=enc["enc_coord"].gather(
            1, idx[..., None].expand(-1, -1, 4)).sigmoid())


def cls_probs(img_u8, P, mcfg, pr: Precision):
    bb = backbone(normalize(img_u8), P, mcfg, pr)
    logits = pr.linear(bb[-1].mean(dim=(1, 2)), P["cls_head.fc.weight"],
                       P["cls_head.fc.bias"])
    return logits.softmax(-1)
