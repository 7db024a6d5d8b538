"""Weight bridge: JAX (flax) model params -> the port's state dict.

``state_dict_from_jax(tree, batch_stats)`` takes the JAX
``params["params"]`` tree (numpy or array leaves), and for a ResNet
backbone the ``params["batch_stats"]`` collection, and returns the
reference's mm-layout state dict, which is the port's own, so
``model.load_state_dict(..., strict=True)`` takes it as it is (and so will
the reference's published ``.pth`` files). The mapping is the one of
rscotr_tpu/utils/torch_convert.py::reverse_mtl_checkpoint (reverse_swin_mm,
reverse_resnet, reverse_channel_mapper, reverse_deformable_encoder,
reverse_cls_head, reverse_dino_head, reverse_mask2former_head), written out
again here because importing that package pulls in jax. The standalone
``DINO`` and ``RSCoTrSeg`` trees map part by part the same way, with their
owned encoder at the top-level ``encoder.`` where the JAX tree has it; the
JAX package defines no mm layout of its own for these two types
(``reverse_mtl_checkpoint`` covers the MTL only).

* flax Dense kernel (in, out) -> Linear weight (out, in); Conv kernel
  (kh, kw, I, O) -> (O, I, kh, kw); norm scale/bias -> weight/bias.
* q/k/v Dense -> one ``in_proj_weight`` / ``in_proj_bias`` [q; k; v].
* Swin PatchMerging: the JAX block order [x00; x10; x01; x11] -> mmdet's
  unfold order on ``reduction`` columns and the ``norm`` (inverse of
  ``_unfold_perm``).
* ResNet (torchvision / mm layout): ``layer{s}_block{b}`` ->
  ``layer{s}.{b}``, ``downsample_conv`` / ``downsample_bn`` ->
  ``downsample.0`` / ``.1``; BN ``running_mean`` / ``running_var`` from
  ``batch_stats`` and mm's ``num_batches_tracked`` (int64 0).
* MlvlClsHead: ``out_proj_w`` (n, 1) -> ``out_proj.weight`` (1, n),
  ``pixel_decoder.level_encoding`` -> ``pixel_decoder.level_encoding.weight``.
* Mask2Former: ``decoder_layers_{i}`` cross / self attention ->
  ``attentions.0`` / ``.1``; ``mask_embed`` layers -> ``mask_embed.{0,2,4}``;
  the pixel decoder's FPN level ``lvl`` -> ``lateral_convs`` /
  ``output_convs`` index ``num_fpn - 1 - lvl``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _t_lin(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _unfold_perm(C: int) -> np.ndarray:
    """mm unfold column (c * 4 + pos) for each JAX column (block * C + c);
    blocks (0,0), (1,0), (0,1), (1,1) take unfold positions 0, 2, 1, 3."""
    block_pos = np.array([0, 2, 1, 3])
    b, c = np.divmod(np.arange(4 * C), C)
    return c * 4 + block_pos[b]


def _ln(out, key, sub):
    out[f"{key}.weight"] = np.asarray(sub["scale"])
    out[f"{key}.bias"] = np.asarray(sub["bias"])


def _dense(out, key, sub):
    out[f"{key}.weight"] = _t_lin(sub["kernel"])
    if "bias" in sub:
        out[f"{key}.bias"] = np.asarray(sub["bias"])


def _conv(out, key, sub):
    out[f"{key}.weight"] = np.ascontiguousarray(
        np.asarray(sub["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in sub:
        out[f"{key}.bias"] = np.asarray(sub["bias"])


def _mha(out, key, sub):
    names = ("q_proj", "k_proj", "v_proj")
    out[f"{key}.in_proj_weight"] = np.concatenate(
        [_t_lin(sub[nm]["kernel"]) for nm in names], axis=0)
    if "bias" in sub["q_proj"]:
        out[f"{key}.in_proj_bias"] = np.concatenate(
            [np.asarray(sub[nm]["bias"]) for nm in names])
    _dense(out, f"{key}.out_proj", sub["out_proj"])


def _msda(out, key, sub):
    for nm in ("sampling_offsets", "attention_weights", "value_proj",
               "output_proj"):
        _dense(out, f"{key}.{nm}", sub[nm])


def _ffn(out, key, sub):
    _dense(out, f"{key}.layers.0.0", sub["fc0"])
    _dense(out, f"{key}.layers.1", sub["fc1"])


def _swin(tree, prefix="backbone.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _conv(out, f"{prefix}patch_embed.proj", tree["patch_embed"])
    if "patch_norm" in tree:
        _ln(out, f"{prefix}patch_embed.norm", tree["patch_norm"])
    s = 0
    while f"stage{s}_block0" in tree:
        b = 0
        while f"stage{s}_block{b}" in tree:
            blk = tree[f"stage{s}_block{b}"]
            dst = f"{prefix}stages.{s}.blocks.{b}"
            _ln(out, f"{dst}.norm1", blk["norm1"])
            _ln(out, f"{dst}.norm2", blk["norm2"])
            _dense(out, f"{dst}.attn.w_msa.qkv", blk["attn"]["qkv"])
            out[f"{dst}.attn.w_msa.relative_position_bias_table"] = \
                np.asarray(blk["attn"]["relative_position_bias_table"])
            _dense(out, f"{dst}.attn.w_msa.proj", blk["attn"]["proj"])
            _dense(out, f"{dst}.ffn.layers.0.0", blk["mlp_fc1"])
            _dense(out, f"{dst}.ffn.layers.1", blk["mlp_fc2"])
            b += 1
        if f"downsample{s}" in tree:
            ds = tree[f"downsample{s}"]
            dst = f"{prefix}stages.{s}.downsample"
            w = _t_lin(ds["reduction"]["kernel"])
            inv = np.argsort(_unfold_perm(w.shape[1] // 4))
            out[f"{dst}.norm.weight"] = np.asarray(ds["norm"]["scale"])[inv]
            out[f"{dst}.norm.bias"] = np.asarray(ds["norm"]["bias"])[inv]
            out[f"{dst}.reduction.weight"] = np.ascontiguousarray(w[:, inv])
        if f"out_norm{s}" in tree:
            _ln(out, f"{prefix}norm{s}", tree[f"out_norm{s}"])
        s += 1
    return out


def _channel_mapper(tree, prefix="neck.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for src, dst in (("convs", "convs"), ("extra_convs", "extra_convs")):
        gn = "gn" if src == "convs" else "extra_gn"
        i = 0
        while f"{src}_{i}" in tree:
            _conv(out, f"{prefix}{dst}.{i}.conv", tree[f"{src}_{i}"])
            if f"{gn}_{i}" in tree:
                _ln(out, f"{prefix}{dst}.{i}.gn", tree[f"{gn}_{i}"])
            i += 1
    return out


def _encoder(tree, prefix="shared_encoder.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    i = 0
    while f"layers_{i}" in tree:
        lyr = tree[f"layers_{i}"]
        src = f"{prefix}layers.{i}"
        _msda(out, f"{src}.attentions.0", lyr["self_attn"])
        _ffn(out, f"{src}.ffns.0", lyr["ffn"])
        _ln(out, f"{src}.norms.0", lyr["norm1"])
        _ln(out, f"{src}.norms.1", lyr["norm2"])
        i += 1
    return out


def _resnet(tree, stats, prefix="backbone.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def bn(sub, st, key):
        _ln(out, key, sub["bn"])
        out[f"{key}.running_mean"] = np.asarray(st["bn"]["mean"])
        out[f"{key}.running_var"] = np.asarray(st["bn"]["var"])
        out[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)

    _conv(out, f"{prefix}conv1", tree["conv1"])
    bn(tree["bn1"], stats["bn1"], f"{prefix}bn1")
    s = 1
    while f"layer{s}_block0" in tree:
        b = 0
        while f"layer{s}_block{b}" in tree:
            blk, st = tree[f"layer{s}_block{b}"], stats[f"layer{s}_block{b}"]
            dst = f"{prefix}layer{s}.{b}"
            for i in (1, 2, 3):
                _conv(out, f"{dst}.conv{i}", blk[f"conv{i}"])
                bn(blk[f"bn{i}"], st[f"bn{i}"], f"{dst}.bn{i}")
            if "downsample_conv" in blk:
                _conv(out, f"{dst}.downsample.0", blk["downsample_conv"])
                bn(blk["downsample_bn"], st["downsample_bn"],
                   f"{dst}.downsample.1")
            b += 1
        s += 1
    return out


def _backbone(tree, stats, prefix="backbone.") -> Dict[str, np.ndarray]:
    """Swin or ResNet, told apart by the tree's keys."""
    if "patch_embed" in tree:
        return _swin(tree, prefix)
    if stats is None:
        raise ValueError("a ResNet backbone needs its batch_stats (the "
                         "running BatchNorm statistics)")
    return _resnet(tree, stats, prefix)


def _cls_head(tree, prefix="cls_head.") -> Dict[str, np.ndarray]:
    """SlvlClsHead (``fc``) or MlvlClsHead (``fc``, ``pixel_decoder``,
    ``out_proj_w`` / ``out_proj_b`` for schemes 5-8)."""
    out: Dict[str, np.ndarray] = {}
    _dense(out, f"{prefix}fc", tree["fc"])
    if "pixel_decoder" in tree:
        out[f"{prefix}pixel_decoder.level_encoding.weight"] = np.asarray(
            tree["pixel_decoder"]["level_encoding"])
    if "out_proj_w" in tree:
        out[f"{prefix}out_proj.weight"] = _t_lin(tree["out_proj_w"])
        out[f"{prefix}out_proj.bias"] = np.asarray(tree["out_proj_b"])
    return out


def _dino_head(tree, prefix="bbox_head.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}label_embedding.weight"] = np.asarray(
        tree["label_embedding"])
    out[f"{prefix}transformer.level_embeds"] = np.asarray(
        tree["level_embeds"])
    out[f"{prefix}transformer.query_embed.weight"] = np.asarray(
        tree["query_embed"])
    _dense(out, f"{prefix}transformer.enc_output", tree["enc_output"])
    _ln(out, f"{prefix}transformer.enc_output_norm", tree["enc_output_norm"])
    i = 0
    while f"cls_branches_{i}" in tree:
        _dense(out, f"{prefix}cls_branches.{i}", tree[f"cls_branches_{i}"])
        for j, fc in enumerate((0, 2, 4)):
            _dense(out, f"{prefix}reg_branches.{i}.{fc}",
                   tree[f"reg_branches_{i}"][f"fc{j}"])
        i += 1
    dec = f"{prefix}transformer.decoder"
    j = 0
    while f"layers_{j}" in tree["ref_point_head"]:
        _dense(out, f"{dec}.ref_point_head.layers.{j}",
               tree["ref_point_head"][f"layers_{j}"])
        j += 1
    _ln(out, f"{dec}.norm", tree["decoder_norm"])
    i = 0
    while f"decoder_layers_{i}" in tree:
        lyr = tree[f"decoder_layers_{i}"]
        src = f"{dec}.layers.{i}"
        _mha(out, f"{src}.attentions.0.attn", lyr["self_attn"])
        _msda(out, f"{src}.attentions.1", lyr["cross_attn"])
        _ffn(out, f"{src}.ffns.0", lyr["ffn"])
        for n in range(3):
            _ln(out, f"{src}.norms.{n}", lyr[f"norm{n + 1}"])
        i += 1
    return out


def _mask2former_head(tree, prefix="seg_head.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name in ("query_embed", "query_feat", "level_embed"):
        out[f"{prefix}{name}.weight"] = np.asarray(tree[name])
    for j, seq in enumerate((0, 2, 4)):
        _dense(out, f"{prefix}mask_embed.{seq}",
               tree["mask_embed"][f"layers_{j}"])
    if "cls_embed" in tree:
        _dense(out, f"{prefix}cls_embed", tree["cls_embed"])
    dec = f"{prefix}transformer_decoder"
    _ln(out, f"{dec}.post_norm", tree["post_norm"])
    i = 0
    while f"decoder_layers_{i}" in tree:
        lyr = tree[f"decoder_layers_{i}"]
        src = f"{dec}.layers.{i}"
        _mha(out, f"{src}.attentions.0.attn", lyr["cross_attn"])
        _mha(out, f"{src}.attentions.1.attn", lyr["self_attn"])
        _ffn(out, f"{src}.ffns.0", lyr["ffn"])
        for n in range(3):
            _ln(out, f"{src}.norms.{n}", lyr[f"norm{n + 1}"])
        i += 1
    out.update(_seg_pixel_decoder(tree["pixel_decoder"],
                                  f"{prefix}pixel_decoder."))
    return out


def _seg_pixel_decoder(pd_tree, pd) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    out[f"{pd}level_encoding.weight"] = np.asarray(pd_tree["level_encoding"])
    _conv(out, f"{pd}mask_feature", pd_tree["mask_feature"])
    lvls = sorted(int(k.split("_")[-1]) for k in pd_tree
                  if k.startswith("lateral_conv_"))
    for lvl in lvls:
        k = len(lvls) - 1 - lvl
        for src, dst in (("lateral", "lateral_convs"),
                         ("output", "output_convs")):
            _conv(out, f"{pd}{dst}.{k}.conv", pd_tree[f"{src}_conv_{lvl}"])
            _ln(out, f"{pd}{dst}.{k}.gn",
                pd_tree[f"{src}_gn_{lvl}"]["GroupNorm_0"])
    i = 0
    while f"input_conv_{i}" in pd_tree:
        _conv(out, f"{pd}input_convs.{i}.conv", pd_tree[f"input_conv_{i}"])
        _ln(out, f"{pd}input_convs.{i}.gn",
            pd_tree[f"input_gn_{i}"]["GroupNorm_0"])
        i += 1
    return out


_PARTS = {"neck": _channel_mapper, "shared_encoder": _encoder,
          "encoder": _encoder, "cls_head": _cls_head,
          "bbox_head": _dino_head, "seg_head": _mask2former_head}


def state_dict_from_jax(tree: dict, batch_stats: Optional[dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``params["params"]`` tree of an MTL, DINO or RSCoTrSeg (and its
    ``params["batch_stats"]`` when the backbone is a ResNet) -> the port's
    (mm-layout) state dict of CPU tensors that own their memory: float32,
    and int64 for ``num_batches_tracked``."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        if name == "backbone":
            out.update(_backbone(sub, (batch_stats or {}).get("backbone")))
        elif name in _PARTS:
            out.update(_PARTS[name](sub, f"{name}."))
        else:
            raise KeyError(f"unknown model part {name!r}")
    return {k: torch.from_numpy(np.array(
        v, dtype=np.int64 if k.endswith("num_batches_tracked")
        else np.float32, copy=True)) for k, v in out.items()}
