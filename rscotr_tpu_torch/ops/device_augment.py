"""On-device training augmentation, batched (PyTorch counterpart of
rscotr_tpu/ops/device_augment.py).

The host draws only the random parameters of each sample (the planners of
``data/pipelines.py``, through the host transforms' own ``draw_*``
methods) and ships the raw uint8 image with small ``aug_*`` records; these
functions do the pixel work on the batch's device, inside the train step:

* cls: RandomResizedCrop (PIL's antialiased bicubic resize as a pair of
  per-image interpolation matrices), RandomFlip, the RandAugment slots and
  RandomErasing;
* det: a flip, then resize -> crop -> resize in the static bucket (PIL
  bilinear matrices);
* seg: ratio resize and crop as one bilinear matrix pair, the flip folded
  in, then PhotoMetricDistortion with PIL's integer HSV round trip.

Each function computes the JAX module's function, op for op: uint8 rounding
(round half to even, then clip) at every PIL boundary, the three-pass shear
warp for the geometric RandAugment ops, PIL's integer semantics for the
pointwise ones, and compute-all-and-select over the ops of a slot. Where
the TPU formulation avoided per-pixel gathers (a dynamic slice per row,
histograms and LUTs as one-hot products) this one gathers, which computes
the same values. The resample products run in full float32 whatever the
TF32 flags say (``_full_f32``): every resample is rounded to uint8, and a
TF32 product moves pixels by a level.

Everything takes and returns (B, H, W, 3) tensors of 0..255 values;
Normalize and the pad mask stay with the caller (``engine/train_step.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rscotr_tpu_torch.utils.rng import per_sample

# canonical op table order: data/pipelines.py RAND_AUG_OPS
RAND_AUG_OP_NAMES = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
    "Solarize", "SolarizeAdd", "ColorTransform", "Contrast", "Brightness",
    "Sharpness", "Shear", "ShearY", "Translate", "TranslateY",
)

_F32 = torch.float32
# PIL's SMOOTH filter, its weights rounded to float32 as the JAX module's
_SMOOTH = (np.array([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                    np.float32) / np.float32(13.0)).tolist()
_INV255 = float(np.float32(1.0 / 255.0))
_SIX_255 = float(np.float32(6.0 / 255.0))


@dataclasses.dataclass(frozen=True)
class DeviceAugmentConfig:
    src_size: int = 256                 # decoded image size (RESISC: 256)
    out_size: int = 224
    fill: Tuple[float, float, float] = (124.0, 116.0, 104.0)   # RGB
    erase_fill: Tuple[float, float, float] = (104.0, 116.0, 124.0)
    erase_fill_std: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    num_policies: int = 2


@dataclasses.dataclass(frozen=True)
class SegDeviceAugmentConfig:
    src_size: int = 512          # static source tile size (Potsdam: 512)
    out_size: int = 512          # crop_size, the padded output


@dataclasses.dataclass(frozen=True)
class DetDeviceAugmentConfig:
    src_hw: Tuple[int, int] = (800, 800)   # static source bucket (DIOR)


@contextlib.contextmanager
def _full_f32():
    """cuBLAS float32 products without TF32 inside the block; the flag is
    restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0)


def _b4(x: torch.Tensor) -> torch.Tensor:
    return x[:, None, None, None]


# ---------------------------------------------------------------------------
# separable resize as matrices
# ---------------------------------------------------------------------------

def _cubic(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """PIL's bicubic kernel, support 2 (a = -0.5 for resize, -1.0 for its
    geometry transforms)."""
    ax = torch.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w1 = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    w2 = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax < 1.0, w1, torch.where(ax < 2.0, w2, 0.0))


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """PIL's BILINEAR kernel, support 1."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {"bicubic": _cubic, "bilinear": _triangle}


def pil_resample_matrix(n_rows: int, src_size: int, win_start, win_size,
                        row0, out_len, n_valid, kernel: str = "bicubic",
                        mirror_out=None, mirror_src=None):
    """(B, n_rows, src_size) weight rows of PIL's ``Image.resize`` on one
    axis: output rows [row0, row0 + n_rows) of the antialiased resize of
    the source window [win_start, win_start + win_size) to ``out_len``
    rows. Every window parameter is a (B,) tensor; the device is theirs.

    PIL: scale = win_size / out_len, filterscale = max(scale, 1), centre_i
    = win_start + (row0 + i + 0.5) * scale, tap j weighted kernel((j + 0.5
    - centre) / filterscale), the window clipped to the source window and
    renormalised. Rows >= ``n_valid`` are zero; ``mirror_out`` (B,) bool
    reads resized row n_valid - 1 - i (a flip after the resize);
    ``mirror_src`` (B,) bool evaluates the taps on the source mirrored over
    the window's end win_start + win_size (a flip before the resize)."""
    win_start = win_start.to(_F32)
    win_size = win_size.to(_F32)
    row0 = row0.to(_F32)
    out_len = out_len.to(_F32)
    n_valid_f = n_valid.to(_F32)
    dev = win_start.device
    scale = win_size / torch.clamp(out_len, min=1.0)           # (B,)
    fscale = torch.clamp(scale, min=1.0)
    i = torch.arange(n_rows, dtype=_F32, device=dev)[None, :]   # (1, R)
    if mirror_out is not None:
        i = torch.where(mirror_out.bool()[:, None],
                        n_valid_f[:, None] - 1.0 - i, i)         # (B, R)
    center = win_start[:, None] + (row0[:, None] + i + 0.5) * \
        scale[:, None]                                           # (B, R)
    j = torch.arange(src_size, dtype=_F32, device=dev)
    pos = j[None, None, :]                                       # tap coord
    if mirror_src is not None:
        mpos = (win_start + win_size)[:, None, None] - 1.0 - \
            j[None, None, :]
        pos = torch.where(mirror_src.bool()[:, None, None], mpos, pos)
    x = (pos + 0.5 - center[:, :, None]) / fscale[:, None, None]
    w = _KERNELS[kernel](x)                                      # (B, R, S)
    inside = (pos >= win_start[:, None, None]) & \
        (pos < (win_start + win_size)[:, None, None])
    w = torch.where(inside, w, 0.0)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    valid_row = torch.arange(n_rows, dtype=_F32, device=dev)[None, :] < \
        n_valid_f[:, None]                                       # (B, R)
    return torch.where(valid_row[:, :, None], w, 0.0)


def apply_resample(img: torch.Tensor, my: torch.Tensor,
                   mx: torch.Tensor) -> torch.Tensor:
    """my @ img @ mx^T per image and channel, in full float32."""
    with _full_f32():
        out = torch.einsum("bys,bswc->bywc", my, img)
        return torch.einsum("bxw,bywc->byxc", mx, out)


def random_resized_crop(img, crop_y, crop_x, crop_h, crop_w, out_size: int):
    """Batched ``img.crop(box).resize((out, out), BICUBIC)`` of PIL,
    rounded to uint8 values. img (B, S, S, 3) float 0..255; the crop boxes
    (B,) integer tensors."""
    S = img.shape[1]
    full = torch.full_like(crop_y, out_size)
    zeros = torch.zeros_like(crop_y)
    my = pil_resample_matrix(out_size, S, crop_y, crop_h, zeros, full, full)
    mx = pil_resample_matrix(out_size, S, crop_x, crop_w, zeros, full, full)
    return _u8(apply_resample(img, my, mx))


# ---------------------------------------------------------------------------
# the three-pass shear warp (Rotate, Shear, Translate)
# ---------------------------------------------------------------------------

def _shift_rows(img: torch.Tensor, shift: torch.Tensor, fill,
                pad: int) -> torch.Tensor:
    """out[b, y, x] = in[b, y, x + shift[b, y]]: PIL's geometry bicubic
    (a = -1) over 4 taps, ``fill`` outside. img (B, H, W, C), shift (B, H)."""
    B, H, W, C = img.shape
    fill_row = torch.as_tensor(fill, dtype=img.dtype,
                               device=img.device).expand(B, H, pad, C)
    padded = torch.cat([fill_row, img, fill_row], dim=2)
    i0 = torch.floor(shift)
    frac = shift - i0
    start = torch.clamp(i0.long() + pad - 1, 0, 2 * pad - 4)   # (B, H)
    idx = start[:, :, None] + torch.arange(W + 4, device=img.device)
    rows = torch.gather(padded, 2, idx[..., None].expand(B, H, W + 4, C))
    taps = torch.arange(-1.0, 3.0, device=img.device)
    w = _cubic(taps - frac[..., None], a=-1.0)                 # (B, H, 4)
    out = torch.zeros_like(img)
    for k in range(4):
        out = out + w[:, :, k, None, None] * rows[:, :, k:k + W, :]
    return out


def _warp_pass_x(img, k, t, fill, pad, cy):
    """Horizontal pass: src_x = x + k * (y - cy) + t."""
    H = img.shape[1]
    y = torch.arange(H, dtype=_F32, device=img.device)[None, :] - cy
    return _shift_rows(img, k[:, None] * y + t[:, None], fill, pad)


def _warp_pass_y(img, k, t, fill, pad, cx):
    out = _warp_pass_x(img.transpose(1, 2), k, t, fill, pad, cx)
    return out.transpose(1, 2)


def three_pass_warp(img, k1, t1, k2, t2, k3, t3, fill, c):
    """shear_x(k1, t1) -> shear_y(k2, t2) -> shear_x(k3, t3) about the
    centre ``c``, rounded to uint8 values; the identity when every
    parameter is 0."""
    pad = img.shape[2] // 2 + 4
    out = _warp_pass_x(img, k1, t1, fill, pad, c)
    out = _warp_pass_y(out, k2, t2, fill, pad, c)
    out = _warp_pass_x(out, k3, t3, fill, pad, c)
    return _u8(out)


def geometric_params(op_id: torch.Tensor, m: torch.Tensor, size: int):
    """(canonical op id, signed magnitude) -> the warp's (k1, t1, k2, t2,
    k3, t3, c). Rotate: PIL ``rotate(m * 30, BICUBIC)`` as Paeth's three
    centred shears; Shear(Y): PIL's AFFINE (1, 0.3m, 0 | 0, 1, 0) at pixel
    centres; Translate(Y): a shift of 0.45 m size. Other ids: zeros."""
    z = torch.zeros_like(m)
    c = (size - 1) / 2.0
    theta = -m * (30.0 * np.pi / 180.0)
    tan_h = torch.tan(theta / 2.0)
    sin_t = torch.sin(theta)
    rot = (tan_h, z, -sin_t, z, tan_h, z)
    sx = (m * 0.3, z, z, z, z, z)
    sy = (z, z, m * 0.3, z, z, z)
    tx = (z, m * 0.45 * size, z, z, z, z)
    ty = (z, z, z, m * 0.45 * size, z, z)

    def pick(idx):
        out = z
        for oid, par in ((14, ty), (13, tx), (12, sy), (11, sx), (3, rot)):
            out = torch.where(op_id == oid, par[idx], out)
        return out

    k1, t1, k2, t2, k3, t3 = (pick(i) for i in range(6))
    # PIL evaluates the affine at pixel centres: the shear's shift is
    # k * (y + 0.5) in top-left coordinates = k * (y - c) + k * (c + 0.5)
    t1 = t1 + torch.where(op_id == 11, k1 * (c + 0.5), 0.0)
    t2 = t2 + torch.where(op_id == 12, k2 * (c + 0.5), 0.0)
    return k1, t1, k2, t2, k3, t3, c


# ---------------------------------------------------------------------------
# pointwise PIL ops
# ---------------------------------------------------------------------------

def _histogram256(img_u8: torch.Tensor) -> torch.Tensor:
    """(B, C, 256) per-image, per-channel histogram of uint8 values (a
    scatter-add of ones: unlike ``bincount`` it sizes its output without
    reading the data, so the step does not wait on the card here)."""
    B, H, W, C = img_u8.shape
    v = img_u8.long().permute(0, 3, 1, 2).reshape(B * C, H * W)
    v = (v + 256 * torch.arange(B * C, device=v.device)[:, None]).reshape(-1)
    h = torch.zeros(B * C * 256, dtype=_F32, device=v.device)
    return h.scatter_add_(0, v, torch.ones_like(v, dtype=_F32)).reshape(
        B, C, 256)


def op_autocontrast(img, _m):
    """ImageOps.autocontrast(cutoff=0): each channel stretched from its
    min..max to 0..255 by PIL's truncating LUT; flat channels unchanged."""
    x = _u8(img)
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-8)
    out = torch.where(hi > lo, torch.floor((x - lo) * scale + 1e-5), x)
    return torch.clamp(out, 0.0, 255.0)


def op_equalize(img, _m):
    """ImageOps.equalize: per channel step = (npix - h[last]) // 255 with
    'last' the highest occupied bin, lut[i] = (cumsum(h)[i - 1] + step // 2)
    // step; unchanged where step is 0."""
    x = _u8(img)
    B, H, W, C = x.shape
    h = _histogram256(x)                                       # (B, C, 256)
    idx = torch.arange(256, dtype=_F32, device=x.device)
    last_bin = torch.where(h > 0, idx, -1.0).amax(-1)          # (B, C)
    h_last = torch.gather(h, -1, torch.clamp(last_bin, min=0).long()
                          [..., None])[..., 0]
    step = torch.floor((float(H * W) - h_last) / 255.0)        # (B, C)
    cum_before = torch.cumsum(h, -1) - h
    lut = torch.floor((cum_before + torch.floor(step / 2.0)[..., None]) /
                      torch.clamp(step, min=1.0)[..., None])
    lut = torch.clamp(lut, 0.0, 255.0)                         # (B, C, 256)
    xi = x.long().permute(0, 3, 1, 2).reshape(B, C, H * W)
    out = torch.gather(lut, -1, xi).reshape(B, C, H, W).permute(0, 2, 3, 1)
    out = torch.where(step[:, None, None, :] > 0, out, x)
    return _u8(out)


def op_invert(img, _m):
    return 255.0 - img


def op_posterize(img, m):
    """bits = max(1, round(8 - 4|m|)); keeps the top ``bits`` bits."""
    bits = torch.clamp(torch.round(8.0 - torch.abs(m) * 4.0), min=1.0)
    q = _b4(torch.pow(2.0, 8.0 - bits))
    return torch.floor(_u8(img) / q) * q


def op_solarize(img, m):
    thr = _b4(torch.floor(256.0 - torch.abs(m) * 256.0))
    x = _u8(img)
    return torch.where(x >= thr, 255.0 - x, x)


def op_solarize_add(img, m):
    add = _b4(torch.floor(torch.abs(m) * 110.0))
    return torch.where(img < 128.0, torch.clamp(img + add, 0.0, 255.0), img)


def _pil_gray(img_u8):
    """PIL's 'L' conversion: (R 299 + G 587 + B 114) / 1000, truncated."""
    r, g, b = img_u8[..., 0], img_u8[..., 1], img_u8[..., 2]
    return torch.floor((r * 299.0 + g * 587.0 + b * 114.0) / 1000.0)


def op_color(img, m):
    """ImageEnhance.Color(1 + m): blend(gray, img, 1 + m)."""
    x = _u8(img)
    gray = _pil_gray(x)[..., None]
    return _u8(gray + (x - gray) * _b4(1.0 + m))


def op_contrast(img, m):
    """ImageEnhance.Contrast(1 + m): blend(mean gray, img, 1 + m), the mean
    int(L.mean() + 0.5)."""
    x = _u8(img)
    mean = _b4(torch.floor(_pil_gray(x).mean(dim=(1, 2)) + 0.5))
    return _u8(mean + (x - mean) * _b4(1.0 + m))


def op_brightness(img, m):
    return _u8(_u8(img) * _b4(1.0 + m))


def op_sharpness(img, m):
    """ImageEnhance.Sharpness(1 + m): blend(SMOOTH-filtered, img, 1 + m);
    the 1-pixel border stays unfiltered, as PIL's filters leave it."""
    x = _u8(img)
    B, H, W, C = x.shape
    xpad = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                   mode="replicate").permute(0, 2, 3, 1)
    sm = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            sm = sm + _SMOOTH[dy][dx] * xpad[:, dy:dy + H, dx:dx + W, :]
    sm = _u8(sm)
    border = torch.ones((H, W), dtype=torch.bool, device=x.device)
    border[1:-1, 1:-1] = False
    sm = torch.where(border[None, :, :, None], x, sm)
    return _u8(sm + (x - sm) * _b4(1.0 + m))


_POINTWISE = {
    0: op_autocontrast, 1: op_equalize, 2: op_invert, 4: op_posterize,
    5: op_solarize, 6: op_solarize_add, 7: op_color, 8: op_contrast,
    9: op_brightness, 10: op_sharpness,
}


def apply_rand_augment_slot(img, op_id, m, fill):
    """One RandAugment policy slot over the batch: every image pays the
    warp and every pointwise candidate, and keeps the one its op id names.
    img (B, H, W, 3) uint8-valued floats; op_id (B,) integer ids of
    ``RAND_AUG_OP_NAMES``; m (B,) signed magnitudes in [-1, 1]."""
    size = img.shape[1]
    k1, t1, k2, t2, k3, t3, c = geometric_params(op_id, m, size)
    out = three_pass_warp(img, k1, t1, k2, t2, k3, t3, fill, c)
    for oid, fn in _POINTWISE.items():
        out = torch.where(_b4(op_id == oid), fn(img, m), out)
    return out


def random_erase(img, on, y, x, eh, ew, fill, fill_std,
                 generator: Optional[torch.Generator] = None):
    """mmcls RandomErasing(mode='rand'): the box filled with fill + std *
    N(0, 1), drawn from ``generator`` (on its own device, then moved); with
    every std 0 the fill is constant and nothing is drawn. Under data
    parallelism the noise is the global batch's, this rank's rows kept."""
    B, H, W, C = img.shape
    ys = torch.arange(H, device=img.device)[None, :, None]
    xs = torch.arange(W, device=img.device)[None, None, :]
    in_box = ((ys >= y[:, None, None]) & (ys < (y + eh)[:, None, None]) &
              (xs >= x[:, None, None]) & (xs < (x + ew)[:, None, None]))
    mask = (in_box & on.bool()[:, None, None])[..., None]
    fill_t = torch.as_tensor(fill, dtype=_F32, device=img.device)
    if max(fill_std) > 0.0:
        dev = generator.device if generator is not None else "cpu"
        noise = per_sample(lambda n: torch.randn(
            (n,) + tuple(img.shape[1:]), generator=generator, device=dev), B)
        std = torch.as_tensor(fill_std, dtype=_F32, device=img.device)
        patch = fill_t + std * noise.to(img.device)
    else:
        patch = fill_t.expand(img.shape)
    return torch.where(mask, torch.clamp(patch, 0.0, 255.0), img)


# ---------------------------------------------------------------------------
# PIL's HSV round trip (seg PhotoMetricDistortion)
# ---------------------------------------------------------------------------

def pil_rgb_to_hsv(img_u8: torch.Tensor):
    """PIL ``convert('HSV')`` of uint8-valued floats -> (h, s, v) float32
    in 0..255, by the JAX module's integer formula: S and V exact, H the
    sixths decomposition (within one level of Pillow)."""
    r, g, b = (img_u8[..., k].to(torch.int32) for k in range(3))
    uv = torch.maximum(r, torch.maximum(g, b))
    lv = torch.minimum(r, torch.minimum(g, b))
    cr = uv - lv
    crs = torch.clamp(cr, min=1)
    s = torch.div(255 * cr, torch.clamp(uv, min=1), rounding_mode="floor")
    rc = torch.div(255 * (uv - r), crs, rounding_mode="floor")
    gc = torch.div(255 * (uv - g), crs, rounding_mode="floor")
    bc = torch.div(255 * (uv - b), crs, rounding_mode="floor")
    h = torch.where(r == uv, bc - gc,
                    torch.where(g == uv, 2 * 255 + rc - bc,
                                4 * 255 + gc - rc))
    h = torch.div(torch.where(h < 0, h + 6 * 255, h), 6,
                  rounding_mode="floor")
    flat = cr == 0
    h = torch.where(flat, 0, h)
    s = torch.where(flat, 0, s)
    return h.to(_F32), s.to(_F32), uv.to(_F32)


def pil_hsv_to_rgb(h, s, v):
    """PIL HSV -> RGB on float32 0..255 channels -> (..., 3)."""
    h6 = h * _SIX_255
    i = torch.floor(h6)
    f = h6 - i
    p = torch.round(v * (255.0 - s) * _INV255)
    q = torch.round(v * (255.0 - s * f) * _INV255)
    t = torch.round(v * (255.0 - s * (1.0 - f)) * _INV255)
    i = torch.remainder(i, 6.0)
    sel = [i == k for k in range(6)]

    def pick(opts):
        out = opts[5]
        for k in range(4, -1, -1):
            out = torch.where(sel[k], opts[k], out)
        return out

    r = pick([v, q, p, p, t, v])
    g = pick([t, v, v, q, p, p])
    b = pick([p, p, t, v, v, q])
    gray = s == 0
    return torch.stack([torch.where(gray, v, r), torch.where(gray, v, g),
                        torch.where(gray, v, b)], dim=-1)


def photometric_distortion(img, pm):
    """Batched mmseg PhotoMetricDistortion on host-drawn parameters (the
    neutral value where a sub-op's coin landed off). pm (B,) each:
    ``bright`` (add), ``c_pre`` / ``c_post`` (contrast multipliers),
    ``hsv_on`` (the HSV round trip happened: lossy even at neutral sat and
    hue), ``sat`` (multiplier), ``hue`` (add). The host op's value chain:
    float adds and products, clip and truncate to uint8 at the HSV
    boundary, a last clip without rounding."""
    x = img + _b4(pm["bright"])
    x = x * _b4(pm["c_pre"])
    xu = torch.floor(torch.clamp(x, 0.0, 255.0))
    h, s, v = pil_rgb_to_hsv(xu)
    s = torch.floor(torch.clamp(s * pm["sat"][:, None, None], 0.0, 255.0))
    h = torch.floor(torch.remainder(h + pm["hue"][:, None, None], 256.0))
    x = torch.where(_b4(pm["hsv_on"].bool()), pil_hsv_to_rgb(h, s, v), x)
    x = x * _b4(pm["c_post"])
    return torch.clamp(x, 0.0, 255.0)


# ---------------------------------------------------------------------------
# the three task stages
# ---------------------------------------------------------------------------

def _source(img: torch.Tensor, hw, stage: str) -> torch.Tensor:
    """The uint8 source as float32, once its (H, W) is the static source
    size of the stage's config (the size the planner padded it to)."""
    if tuple(img.shape[1:3]) != tuple(hw):
        raise ValueError(f"{stage} device augment: source "
                         f"{tuple(img.shape[1:3])}, its config's "
                         f"{tuple(hw)}")
    return img.to(_F32)


def seg_device_augment(img, aug, cfg: SegDeviceAugmentConfig):
    """The seg train pipeline's pixel work: ratio-range Resize and
    RandomCrop as one PIL-bilinear matrix pair (only the cropped rows of the
    resized image are computed), RandomFlip folded into it, uint8 rounding,
    PhotoMetricDistortion. img (B, S, S, 3) uint8; aug (B,) each:
    resize_h / resize_w, crop_y / crop_x (in resized coordinates), crop_h /
    crop_w, flip, pm_*. Returns (B, out, out, 3) float32 0..255. The region
    past crop_h / crop_w picks up the photometric adds: the caller masks it
    by img_hw after normalizing (the host's Normalize-then-Pad(0) zeros)."""
    S = cfg.src_size
    x = _source(img, (S, S), "seg")
    src = torch.full_like(aug["crop_y"], S)
    zeros = torch.zeros_like(aug["crop_y"])
    my = pil_resample_matrix(
        cfg.out_size, S, zeros, src, aug["crop_y"], aug["resize_h"],
        aug["crop_h"], kernel="bilinear")
    mx = pil_resample_matrix(
        cfg.out_size, S, zeros, src, aug["crop_x"], aug["resize_w"],
        aug["crop_w"], kernel="bilinear", mirror_out=aug["flip"])
    out = _u8(apply_resample(x, my, mx))
    pm = {k[len("pm_"):]: v for k, v in aug.items() if k.startswith("pm_")}
    return photometric_distortion(out, pm)


def det_device_augment(img, aug, out_hw, cfg: DetDeviceAugmentConfig):
    """The det train pipeline's pixel work as the planner's two-stage
    program: a PIL-bilinear resize of the valid source (a flip before it
    folded in as a source mirror), uint8 rounding, then the resize of a
    crop window of that result (a flip after it folded in as an output
    mirror), rounded. img (B, srcH, srcW, 3) uint8, valid in [0, src_h) x
    [0, src_w); aug (B,) each: src_h / src_w, flip_src, flip_out, s1_h /
    s1_w, crop_y / crop_x / crop_h / crop_w, s2_h / s2_w; out_hw the static
    output bucket. Returns (B, outH, outW, 3) float32 0..255, zero outside
    the valid region."""
    srcH, srcW = cfg.src_hw
    outH, outW = out_hw
    x = _source(img, cfg.src_hw, "det")
    zeros = torch.zeros_like(aug["src_h"])
    my1 = pil_resample_matrix(
        srcH, srcH, zeros, aug["src_h"], zeros, aug["s1_h"], aug["s1_h"],
        kernel="bilinear")
    mx1 = pil_resample_matrix(
        srcW, srcW, zeros, aug["src_w"], zeros, aug["s1_w"], aug["s1_w"],
        kernel="bilinear", mirror_src=aug["flip_src"])
    x = _u8(apply_resample(x, my1, mx1))
    my2 = pil_resample_matrix(
        outH, srcH, aug["crop_y"], aug["crop_h"], zeros, aug["s2_h"],
        aug["s2_h"], kernel="bilinear")
    mx2 = pil_resample_matrix(
        outW, srcW, aug["crop_x"], aug["crop_w"], zeros, aug["s2_w"],
        aug["s2_w"], kernel="bilinear", mirror_out=aug["flip_out"])
    return _u8(apply_resample(x, my2, mx2))


def cls_device_augment(img, aug, cfg: DeviceAugmentConfig,
                       generator: Optional[torch.Generator] = None):
    """The cls train augment tail: RandomResizedCrop, RandomFlip, the
    RandAugment slots, RandomErasing. img (B, S, S, 3) uint8 0..255; aug
    (B,) each: crop_y / crop_x / crop_h / crop_w, flip, op_id (B, P), op_m
    (B, P), erase_on, erase_y / erase_x / erase_h / erase_w. Returns (B,
    out, out, 3) float32 0..255 (the caller normalizes, the host pipeline's
    Normalize-last order). ``generator`` draws the erase noise, and only
    when ``cfg.erase_fill_std`` is not all 0."""
    x = random_resized_crop(_source(img, (cfg.src_size,) * 2, "cls"),
                            aug["crop_y"], aug["crop_x"],
                            aug["crop_h"], aug["crop_w"], cfg.out_size)
    x = torch.where(_b4(aug["flip"].bool()), x.flip(2), x)
    for p in range(cfg.num_policies):
        x = apply_rand_augment_slot(x, aug["op_id"][:, p],
                                    aug["op_m"][:, p], cfg.fill)
    return random_erase(x, aug["erase_on"], aug["erase_y"], aug["erase_x"],
                        aug["erase_h"], aug["erase_w"], cfg.erase_fill,
                        cfg.erase_fill_std, generator)


# per task: the step config's field that holds its stage's config, and the
# record that marks a batch drawn by its planner
STAGES = {"cls": ("device_aug", "aug_op_id"),
          "det": ("det_device_aug", "aug_s2_h"),
          "seg": ("seg_device_aug", "aug_resize_h")}


def run_stage(task: str, batch: dict, step_cfg,
              generator: Optional[torch.Generator] = None):
    """``task``'s stage on ``batch`` when ``step_cfg`` (a
    ``TrainStepConfig``) sets one and the batch carries its planner's
    ``aug_*`` records, else None. det's output bucket is the shape of the
    batch's zero-width ``out_template``. Returns float32 0..255, not
    normalized."""
    field, marker = STAGES[task]
    cfg = getattr(step_cfg, field)
    if cfg is None or marker not in batch:
        return None
    aug = {k[len("aug_"):]: v for k, v in batch.items()
           if k.startswith("aug_")}
    if task == "cls":
        return cls_device_augment(batch["img"], aug, cfg, generator)
    if task == "det":
        return det_device_augment(batch["img"], aug,
                                  batch["out_template"].shape[1:3], cfg)
    return seg_device_augment(batch["img"], aug, cfg)
