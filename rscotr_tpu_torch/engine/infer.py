"""Per-task inference steps (PyTorch counterpart of
rscotr_tpu/engine/train_step.py::make_infer_steps, _slide_origins and
device_normalize).

The steps take the JAX steps' arguments minus ``params`` (an ``nn.Module``
carries its weights), move numpy or tensor inputs to the model's device and
run under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rscotr_tpu_torch.models.heads.dino_loss import dino_get_bboxes
from rscotr_tpu_torch.models.heads.pixel_decoders import _resize_bilinear
from rscotr_tpu_torch.ops import resize
from rscotr_tpu_torch.utils import trace

_DEFAULT_NORM = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375))


def device_normalize(img: torch.Tensor, img_norm=None,
                     img_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalize uint8 images on the device and re-zero the padded region
    (the reference pads after normalizing). Float inputs pass unchanged."""
    if img.dtype != torch.uint8:
        return img
    return normalize(img, img_norm, img_hw)


def normalize(img: torch.Tensor, img_norm=None,
              img_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(img - mean) / std in float32 (ImageNet stats unless ``img_norm``
    gives them), the region past ``img_hw`` zeroed after. The train step
    calls it on the float 0..255 output of an augment stage."""
    mean, std = img_norm if img_norm is not None else _DEFAULT_NORM
    mean = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(std, dtype=torch.float32, device=img.device)
    x = (img.float() - mean) / std
    if img_hw is not None:
        B, H, W, _ = x.shape
        row = torch.arange(H, device=x.device)[None] < img_hw[:, 0][:, None]
        col = torch.arange(W, device=x.device)[None] < img_hw[:, 1][:, None]
        keep = (row[:, :, None] & col[:, None, :])[..., None]
        x = torch.where(keep, x, 0.0)
    return x


def _slide_origins(size: int, crop: int, stride: int):
    """mmseg slide_inference window origins along one axis."""
    n = max(size - crop + stride - 1, 0) // stride + 1
    return sorted({min(i * stride, size - crop) for i in range(n)})


def resize_linear(x: torch.Tensor, hw) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C) float32, ``jax.image.resize(x, ...,
    method="linear")``, for any size: the triangle kernel at half-pixel
    centres, widened by in/out on an axis that shrinks and normalised per
    output. That is ``F.interpolate``'s bilinear mode with antialiasing,
    which is taken when an axis shrinks; when none does, the widening is
    void and the plain bilinear grid (``_resize_bilinear``) is the same.
    Under ``torch.use_deterministic_algorithms(True)`` the same function
    as two products (``ops.resize.resize_matmul``), whose backward has no
    atomics."""
    H, W = int(hw[0]), int(hw[1])
    x = x.float()
    if H >= x.shape[1] and W >= x.shape[2]:
        return _resize_bilinear(x, (H, W))
    if torch.are_deterministic_algorithms_enabled():
        return resize.resize_matmul(x.permute(0, 3, 1, 2), (H, W)
                                    ).permute(0, 2, 3, 1)
    return F.interpolate(x.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                         align_corners=False, antialias=True
                         ).permute(0, 2, 3, 1)


def make_infer_steps(model, max_per_img: int = 300, img_norm=None,
                     device=None, seg_test_cfg=None):
    """{"cls": infer_cls(img) -> probabilities (B, num_classes),
        "det": infer_det(img, img_hw, scale_factor) -> (det_bboxes
        (B, max_per_img, 5), det_labels (B, max_per_img)),
        "seg": infer_seg(img) -> label map (B, H, W) int64,
        "seg_logits": infer_seg_logits(img) -> f32 logits (B, H, W, C) at
        the input resolution}.

    ``seg_test_cfg`` is the config's ``model.test_cfg.seg``: ``mode``
    ``"whole"`` (default) upsamples the logits of the whole image;
    ``"slide"`` runs overlapping ``crop_size`` windows at ``stride`` (mmseg
    ``slide_inference``), adds each window's upsampled logits into a canvas
    and divides by the per-pixel window count before the argmax."""
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device

    def to_dev(x):
        return None if x is None else torch.as_tensor(x).to(device)

    @torch.inference_mode()
    def infer_cls(img):
        with trace.span(trace.REQUEST_CLS):
            with trace.span(trace.INPUT):
                img = device_normalize(to_dev(img), img_norm)
            return model.forward_cls(img).softmax(-1)

    @torch.inference_mode()
    def infer_det(img, img_hw, scale_factor=None):
        with trace.span(trace.REQUEST_DET):
            with trace.span(trace.INPUT):
                img_hw = to_dev(img_hw)
                img = device_normalize(to_dev(img), img_norm, img_hw)
            all_cls, all_coords, _, _ = model.forward_det(img, img_hw)
            with trace.span(trace.DET_BOXES):
                return dino_get_bboxes(all_cls[-1], all_coords[-1], img_hw,
                                       to_dev(scale_factor),
                                       max_per_img=max_per_img, rescale=True)

    stc = dict(seg_test_cfg or {})
    if stc.get("mode", "whole") == "slide":
        hc, wc = (int(v) for v in stc["crop_size"])
        hs, ws = (int(v) for v in stc["stride"])

        def seg_logits(img):
            B, H, W, _ = img.shape
            if H < hc or W < wc:
                raise ValueError(
                    f"slide inference needs image >= crop_size; got "
                    f"({H},{W}) < ({hc},{wc}): pad in the test pipeline")
            pred = cnt = None
            for y in _slide_origins(H, hc, hs):
                for x in _slide_origins(W, wc, ws):
                    logits = resize_linear(model.forward_seg(
                        img[:, y:y + hc, x:x + wc]), (hc, wc))
                    if pred is None:
                        pred = logits.new_zeros((B, H, W, logits.shape[-1]))
                        cnt = logits.new_zeros((H, W))
                    pred[:, y:y + hc, x:x + wc] += logits
                    cnt[y:y + hc, x:x + wc] += 1.0
            return pred / cnt[None, :, :, None]
    else:
        def seg_logits(img):
            return resize_linear(model.forward_seg(img), img.shape[1:3])

    @torch.inference_mode()
    def infer_seg_logits(img):
        with trace.span(trace.INPUT):
            img = device_normalize(to_dev(img), img_norm)
        return seg_logits(img)

    @torch.inference_mode()
    def infer_seg(img):
        return infer_seg_logits(img).argmax(-1)

    return {"cls": infer_cls, "det": infer_det, "seg": infer_seg,
            "seg_logits": infer_seg_logits}
