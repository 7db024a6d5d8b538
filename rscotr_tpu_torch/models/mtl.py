"""MTL — the multi-task model and its cls, det and seg tasks (PyTorch
counterpart of rscotr_tpu/models/mtl.py).

Shared backbone -> ChannelMapper neck over the last ``neck_in_levels``
backbone levels -> shared deformable encoder, passed to the heads that run
it (det, seg, and cls with an ``MlvlClsHead``) as ``encode_fn`` (one
module, so its parameters appear once). Task outputs are cast to float32 at
the model boundary (``outputs_f32``). JAX's ``deterministic`` flag is the
module mode: ``model.train()`` turns on drop path and dropout, which draw
from the ``generator`` given to the forward.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from rscotr_tpu_torch.models.heads.cls_heads import MlvlClsHead


def outputs_f32(out):
    """Cast every floating tensor of a task output (nested tuples) to f32."""
    if isinstance(out, (tuple, list)):
        return type(out)(outputs_f32(o) for o in out)
    if isinstance(out, torch.Tensor) and out.is_floating_point():
        return out.float()
    return out


class MTL(nn.Module):
    def __init__(self, backbone: nn.Module, neck: Optional[nn.Module],
                 shared_encoder: nn.Module,
                 cls_head: Optional[nn.Module] = None,
                 bbox_head: Optional[nn.Module] = None,
                 seg_head: Optional[nn.Module] = None,
                 neck_in_levels: int = 3):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.shared_encoder = shared_encoder
        self.cls_head = cls_head
        self.bbox_head = bbox_head
        self.seg_head = seg_head
        self.neck_in_levels = neck_in_levels

    def _encoder(self, generator):
        """The shared encoder as the heads call it (JAX's ``_encode_fn``),
        drawing its dropout from ``generator``."""
        return functools.partial(self.shared_encoder, generator=generator)

    def extract_feat(self, img, generator=None):
        """img (B, H, W, 3) -> (neck_feats, backbone_feats)."""
        bb = self.backbone(img, generator)
        if self.neck is None:
            return bb, bb
        return self.neck(bb[len(bb) - self.neck_in_levels:]), bb

    def forward_cls(self, img, generator: Optional[torch.Generator] = None):
        if isinstance(self.cls_head, MlvlClsHead):
            nk, _ = self.extract_feat(img, generator)
            return outputs_f32(self.cls_head(nk, self._encoder(generator)))
        # SlvlClsHead reads only the last backbone map. Under jit XLA drops
        # the unused neck of the JAX forward; eagerly it would run, so the
        # backbone is called alone.
        return outputs_f32(self.cls_head(self.backbone(img, generator)))

    def forward_det(self, img, img_hw, dn_label_query=None,
                    dn_bbox_query=None, attn_mask=None,
                    generator: Optional[torch.Generator] = None):
        """-> (all_cls, all_coords, topk_score, topk_anchor), see
        ``DINOHead.forward``; the CDN queries and mask are for training."""
        nk, _ = self.extract_feat(img, generator)
        return outputs_f32(self.bbox_head(
            nk, img_hw, encode_fn=self._encoder(generator),
            dn_label_query=dn_label_query, dn_bbox_query=dn_bbox_query,
            attn_mask=attn_mask))

    def forward_seg(self, img, generator: Optional[torch.Generator] = None):
        """-> seg logits (B, H/8, W/8, channels), see
        ``Mask2FormerHead.forward``; the head reads the neck levels and the
        backbone maps."""
        nk, bb = self.extract_feat(img, generator)
        return outputs_f32(self.seg_head(nk, bb,
                                         encode_fn=self._encoder(generator)))
