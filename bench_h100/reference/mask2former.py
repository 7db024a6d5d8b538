"""Plain PyTorch reference of Mask2Former's semantic segmentation forward.

Written from the published model (Cheng et al., "Masked-attention Mask
Transformer for Universal Image Segmentation", CVPR 2022, arXiv:2112.01527;
facebookresearch/Mask2Former's ``MSDeformAttnPixelDecoder``,
``MultiScaleMaskedTransformerDecoder`` and ``semantic_inference``) with the
Swin Transformer backbone (arXiv:2103.14030), over a flat state dict in the
mm key layout that the program uses. It imports nothing of the program: the
Swin blocks (window attention by matmul and softmax), deformable attention
(``grid_sample``), the encoder, the sine encodings and ``Precision`` are
``reference/mtl.py``'s, and everything else is written here: the pixel
decoder, the masked-attention decoder as an explicit masked softmax with
Mask2Former's reset of all-blocked rows, and the semantic inference in its
published order (bilinear upsampling of the mask logits to the image, their
sigmoid, the product with the softmax of the class logits without the
no-object class, summed over the queries). Every product runs in float32
with TF32 off; ``Precision("fp8")`` is the control, as in ``mtl.py``.

Departures from the published code, none of which changes the function:

* Swin pads each stage's map to a multiple of the window and masks only the
  shifted blocks, as the official Swin and mmdet do; the program does the
  same.
* Mask2Former's class head runs after every decoder layer for its auxiliary
  losses; serving reads only the last, so only the last is computed.
* nn.MultiheadAttention's packed projection is applied as three linears of
  its rows [q; k; v]; blocked keys get -inf before the softmax.
* ``sem_seg_postprocess`` (crop and resize to the original image) is the
  identity on whole 640^2 tiles, and is left out.
* Dropout and drop path are off (inference).

``forward`` can be driven by given attention masks (the program's): each
decoder layer then attends under the given mask, and the masks the
reference would have made itself are returned beside them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench_h100.reference.mtl import (Precision, encoder, ffn, group_norm,
                                      layer_norm, mha, normalize, sine_pos,
                                      swin)

__all__ = ["Precision", "forward", "semantic", "serve", "parameter_shapes"]

HEAD = "seg_head"
PIX = HEAD + ".pixel_decoder"
DEC = HEAD + ".transformer_decoder"
GN_GROUPS = 32
POS_TEMPERATURE = 10000.0


def _head_cfg(mcfg):
    return mcfg.get("decode_head") or mcfg["seg_head"]


def pixel_decoder(bb, P, mcfg, pr: Precision):
    """Swin's four normed maps (strides 4..32, NHWC) -> the mask feature
    (stride 4) and the encoder's levels, low -> high resolution.

    Input projections (1x1 conv + GN) of the lowest-resolution
    ``num_transformer_feat_level`` maps, each with a sine encoding plus its
    level embedding, normalised centre reference points, the deformable
    encoder; then FPN over the remaining maps: a lateral 1x1 conv + GN, the
    coarser output bilinearly upsampled and added, a 3x3 conv + GN + ReLU;
    the mask feature a 1x1 conv of the finest."""
    hcfg = _head_cfg(mcfg)
    L, C = hcfg["num_transformer_feat_level"], hcfg["feat_channels"]
    n, B, dev = len(bb), bb[0].shape[0], bb[0].device
    levels = []
    for i in range(L):
        x = pr.conv(bb[n - 1 - i], P[f"{PIX}.input_convs.{i}.conv.weight"],
                    P[f"{PIX}.input_convs.{i}.conv.bias"])
        levels.append(group_norm(x, P, f"{PIX}.input_convs.{i}.gn",
                                 GN_GROUPS))
    shapes = [(f.shape[1], f.shape[2]) for f in levels]
    toks = torch.cat([f.reshape(B, -1, C) for f in levels], 1)
    pos = torch.cat([sine_pos(h, w, B, C // 2, POS_TEMPERATURE, dev) +
                     P[f"{PIX}.level_encoding.weight"][i]
                     for i, (h, w) in enumerate(shapes)], 1)
    refs = []
    for h, w in shapes:
        gy, gx = torch.meshgrid(
            torch.arange(h, device=dev, dtype=torch.float32) + 0.5,
            torch.arange(w, device=dev, dtype=torch.float32) + 0.5,
            indexing="ij")
        refs.append(torch.stack([gx.reshape(-1) / w, gy.reshape(-1) / h], -1))
    ref = torch.cat(refs, 0)[None, :, None, :].expand(B, -1, L, 2)
    memory = encoder(toks, pos, ref, shapes, P,
                     mcfg.get("encoder") or mcfg["shared_encoder"], pr,
                     pre="encoder")
    outs, start = [], 0
    for h, w in shapes:
        outs.append(memory[:, start:start + h * w].reshape(B, h, w, C))
        start += h * w
    num_fpn = n - L
    for k in range(num_fpn):
        lat = group_norm(pr.conv(bb[num_fpn - 1 - k],
                                 P[f"{PIX}.lateral_convs.{k}.conv.weight"]),
                         P, f"{PIX}.lateral_convs.{k}.gn", GN_GROUPS)
        up = F.interpolate(outs[-1].permute(0, 3, 1, 2), size=lat.shape[1:3],
                           mode="bilinear", align_corners=False)
        y = pr.conv(lat + up.permute(0, 2, 3, 1),
                    P[f"{PIX}.output_convs.{k}.conv.weight"], padding=1)
        outs.append(F.relu(group_norm(y, P, f"{PIX}.output_convs.{k}.gn",
                                      GN_GROUPS)))
    feature = pr.conv(outs[-1], P[f"{PIX}.mask_feature.weight"],
                      P[f"{PIX}.mask_feature.bias"])
    return feature, outs[:L]


def cross_attention(x, mem, qpos, kpos, P, pre, heads, blocked,
                    pr: Precision):
    """Queries x (B, Q, C) over memory (B, S, C) with ``blocked`` (B, Q, S)
    True = not attended, the same for every head; + x."""
    B, N, C = x.shape
    hd = C // heads
    w, b = P[pre + ".attn.in_proj_weight"], P[pre + ".attn.in_proj_bias"]
    q = pr.linear(x + qpos, w[:C], b[:C]).reshape(B, N, heads, hd)
    k = pr.linear(mem + kpos, w[C:2 * C], b[C:2 * C]).reshape(B, -1, heads,
                                                            hd)
    v = pr.linear(mem, w[2 * C:], b[2 * C:]).reshape(B, -1, heads, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    logits = pr.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    logits = logits.masked_fill(blocked[:, None], float("-inf"))
    out = pr.matmul(logits.softmax(-1), v).transpose(1, 2).reshape(B, N, C)
    return x + pr.linear(out, P[pre + ".attn.out_proj.weight"],
                         P[pre + ".attn.out_proj.bias"])


def prediction(q, feature, hw, P, pr: Precision):
    """Mask2Former's ``forward_prediction_heads`` without the class head:
    the mask logits (B, Q, h, w) at the mask feature's stride, and the
    attention mask of the next layer at ``hw``: the logits bilinearly
    resized, sigmoid < 0.5 blocked, a row blocked everywhere reset to
    attend everywhere."""
    d = layer_norm(q, P, DEC + ".post_norm")
    for i in (0, 2):
        d = F.relu(pr.linear(d, P[f"{HEAD}.mask_embed.{i}.weight"],
                             P[f"{HEAD}.mask_embed.{i}.bias"]))
    emb = pr.linear(d, P[f"{HEAD}.mask_embed.4.weight"],
                    P[f"{HEAD}.mask_embed.4.bias"])
    B, hm, wm, C = feature.shape
    masks = pr.matmul(emb, feature.reshape(B, -1, C).transpose(1, 2))
    masks = masks.reshape(B, -1, hm, wm)
    am = F.interpolate(masks, size=tuple(hw), mode="bilinear",
                       align_corners=False)
    am = am.reshape(B, masks.shape[1], -1).sigmoid() < 0.5
    return masks, am & ~am.all(-1, keepdim=True)


def forward(img_u8, P, mcfg, pr: Precision,
            masks: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """uint8 NHWC tiles -> ``cls_logits`` (B, Q, K + 1) and ``mask_logits``
    (B, Q, H/4, W/4) of the last layer, ``layer_logits``: the mask logits
    of every prediction (before the first layer and after each), and
    ``own_masks``: the attention mask (B, Q, h*w) the reference makes
    before each decoder layer. With ``masks`` each layer attends under
    ``masks[i]`` instead."""
    hcfg = _head_cfg(mcfg)
    L, C = hcfg["num_transformer_feat_level"], hcfg["feat_channels"]
    heads = hcfg["transformer_decoder"]["transformerlayers"]["attn_cfgs"].get(
        "num_heads", 8)
    layers = hcfg["transformer_decoder"]["num_layers"]
    bb = swin(normalize(img_u8), P, mcfg["backbone"], pr)
    feature, feats = pixel_decoder(bb, P, mcfg, pr)
    B, dev = feature.shape[0], feature.device
    src = [f.reshape(B, -1, C) + P[HEAD + ".level_embed.weight"][i]
           for i, f in enumerate(feats)]
    pos = [sine_pos(f.shape[1], f.shape[2], B, C // 2, POS_TEMPERATURE, dev)
           for f in feats]
    q = P[HEAD + ".query_feat.weight"][None].expand(B, -1, -1)
    qpos = P[HEAD + ".query_embed.weight"][None].expand(B, -1, -1)
    mask_logits, am = prediction(q, feature, feats[0].shape[1:3], P, pr)
    own: List[torch.Tensor] = []
    logits = [mask_logits]
    for i in range(layers):
        lvl = i % L
        own.append(am)
        lp = f"{DEC}.layers.{i}"
        blocked = am if masks is None else masks[i].to(dev)
        q = cross_attention(q, src[lvl], qpos, pos[lvl], P,
                            lp + ".attentions.0", heads, blocked, pr)
        q = layer_norm(q, P, lp + ".norms.0")
        q = mha(q, qpos, P, lp + ".attentions.1", heads, pr)
        q = layer_norm(q, P, lp + ".norms.1")
        q = layer_norm(ffn(q, P, lp + ".ffns.0", pr), P, lp + ".norms.2")
        mask_logits, am = prediction(q, feature, feats[(i + 1) % L].shape[1:3],
                                     P, pr)
        logits.append(mask_logits)
    cls = pr.linear(layer_norm(q, P, DEC + ".post_norm"),
                    P[HEAD + ".cls_embed.weight"], P[HEAD + ".cls_embed.bias"])
    return dict(cls_logits=cls, mask_logits=mask_logits, layer_logits=logits,
                own_masks=own)


def semantic(cls_logits, mask_logits, hw, pr: Precision) -> torch.Tensor:
    """Mask2Former's ``semantic_inference`` in its published order: the
    mask logits upsampled to ``hw`` (bilinear, align_corners False), their
    sigmoid, then einsum("qc,qhw->chw") with softmax(class)[..., :-1].
    Returns the scores NHWC (B, H, W, K)."""
    m = F.interpolate(mask_logits.float(), size=tuple(hw), mode="bilinear",
                      align_corners=False).sigmoid()
    p = cls_logits.float().softmax(-1)[..., :-1]
    return torch.einsum("bqk,bqhw->bhwk", pr.q(p), pr.q(m))


def serve(img_u8, P, mcfg, pr: Precision, step: int) -> Dict[str, torch.Tensor]:
    """The reference's own serving forward in the program's output format
    (``checks/seg.py``): the label map, the head's outputs, its own
    attention masks ``attn_mask.{i}``, the scores at every ``step``-th row
    and column (``sem_sub``) and the two largest scores of every pixel with
    their classes (``top_val``, ``top_idx``)."""
    out = forward(img_u8, P, mcfg, pr)
    scores = semantic(out["cls_logits"], out["mask_logits"],
                      img_u8.shape[1:3], pr)
    top = scores.topk(2, dim=-1)
    res = dict(labels=scores.argmax(-1), cls_logits=out["cls_logits"],
               mask_logits=out["mask_logits"],
               sem_sub=scores[:, ::step, ::step],
               top_val=top.values, top_idx=top.indices)
    res.update({f"attn_mask.{i}": m for i, m in enumerate(out["own_masks"])})
    return res


def parameter_shapes(mcfg) -> Dict[str, tuple]:
    """Every parameter this reference reads, with its shape, from the
    configuration's widths (the weights' names and the count follow)."""
    bcfg, hcfg = mcfg["backbone"], _head_cfg(mcfg)
    ecfg = mcfg.get("encoder") or mcfg["shared_encoder"]
    out: Dict[str, tuple] = {}

    def lin(name, cout, cin, bias=True):
        out[name + ".weight"] = (cout, cin)
        if bias:
            out[name + ".bias"] = (cout,)

    def norm(name, c):
        out[name + ".weight"] = (c,)
        out[name + ".bias"] = (c,)

    def conv(name, cout, cin, k, bias=True):
        out[name + ".weight"] = (cout, cin, k, k)
        if bias:
            out[name + ".bias"] = (cout,)

    C, w = bcfg["embed_dims"], bcfg["window_size"]
    mlp = bcfg.get("mlp_ratio", 4)
    conv("backbone.patch_embed.proj", C, 3, 4)
    norm("backbone.patch_embed.norm", C)
    dims = []
    for si, depth in enumerate(bcfg["depths"]):
        H = bcfg["num_heads"][si]
        for bi in range(depth):
            p = f"backbone.stages.{si}.blocks.{bi}"
            norm(p + ".norm1", C)
            out[p + ".attn.w_msa.relative_position_bias_table"] = (
                (2 * w - 1) ** 2, H)
            lin(p + ".attn.w_msa.qkv", 3 * C, C)
            lin(p + ".attn.w_msa.proj", C, C)
            norm(p + ".norm2", C)
            lin(p + ".ffn.layers.0.0", mlp * C, C)
            lin(p + ".ffn.layers.1", C, mlp * C)
        dims.append(C)
        if si < len(bcfg["depths"]) - 1:
            norm(f"backbone.stages.{si}.downsample.norm", 4 * C)
            lin(f"backbone.stages.{si}.downsample.reduction", 2 * C, 4 * C,
                bias=False)
            C *= 2
    for si, c in enumerate(dims):
        norm(f"backbone.norm{si}", c)
    L, F_ = hcfg["num_transformer_feat_level"], hcfg["feat_channels"]
    attn = ecfg["transformerlayers"]["attn_cfgs"]
    He, Le, Pe = attn.get("num_heads", 8), attn.get("num_levels", 4), \
        attn.get("num_points", 4)
    for i in range(ecfg["num_layers"]):
        p = f"encoder.layers.{i}"
        a = p + ".attentions.0"
        lin(a + ".sampling_offsets", He * Le * Pe * 2, F_)
        lin(a + ".attention_weights", He * Le * Pe, F_)
        lin(a + ".value_proj", F_, F_)
        lin(a + ".output_proj", F_, F_)
        ff = ecfg["transformerlayers"]["ffn_cfgs"]["feedforward_channels"]
        lin(p + ".ffns.0.layers.0.0", ff, F_)
        lin(p + ".ffns.0.layers.1", F_, ff)
        norm(p + ".norms.0", F_)
        norm(p + ".norms.1", F_)
    out[PIX + ".level_encoding.weight"] = (L, F_)
    for i in range(L):
        conv(f"{PIX}.input_convs.{i}.conv", F_, dims[len(dims) - 1 - i], 1)
        norm(f"{PIX}.input_convs.{i}.gn", F_)
    for k in range(len(dims) - L):
        conv(f"{PIX}.lateral_convs.{k}.conv", F_, dims[len(dims) - L - 1 - k],
             1, bias=False)
        norm(f"{PIX}.lateral_convs.{k}.gn", F_)
        conv(f"{PIX}.output_convs.{k}.conv", F_, F_, 3, bias=False)
        norm(f"{PIX}.output_convs.{k}.gn", F_)
    conv(PIX + ".mask_feature", hcfg["out_channels"], F_, 1)
    Q = hcfg["num_queries"]
    out[HEAD + ".level_embed.weight"] = (L, F_)
    out[HEAD + ".query_feat.weight"] = (Q, F_)
    out[HEAD + ".query_embed.weight"] = (Q, F_)
    td = hcfg["transformer_decoder"]
    fd = td["transformerlayers"]["ffn_cfgs"]["feedforward_channels"]
    for i in range(td["num_layers"]):
        p = f"{DEC}.layers.{i}"
        for a in (0, 1):
            out[f"{p}.attentions.{a}.attn.in_proj_weight"] = (3 * F_, F_)
            out[f"{p}.attentions.{a}.attn.in_proj_bias"] = (3 * F_,)
            lin(f"{p}.attentions.{a}.attn.out_proj", F_, F_)
        lin(p + ".ffns.0.layers.0.0", fd, F_)
        lin(p + ".ffns.0.layers.1", F_, fd)
        for j in range(3):
            norm(f"{p}.norms.{j}", F_)
    norm(DEC + ".post_norm", F_)
    lin(HEAD + ".mask_embed.0", F_, F_)
    lin(HEAD + ".mask_embed.2", F_, F_)
    lin(HEAD + ".mask_embed.4", hcfg["out_channels"], F_)
    lin(HEAD + ".cls_embed", hcfg["num_classes"] + 1, F_)
    return out
