"""The port's on-device augmentation (rscotr_tpu_torch/ops/device_augment.py)
against the JAX package's on the CPU, on the same records (each JAX
function jitted, as JAX's own tests/test_device_augment.py runs its stages
in a step: one compile in place of eager op-by-op dispatch):

* every RandAugment op of a slot (one batch, each image its own op),
  ``random_resized_crop``, ``pil_resample_matrix`` (resize-then-crop with
  the flip folded in, a source mirror), the PIL HSV round trip,
  ``photometric_distortion`` and ``random_erase``;
* the planners' records and the three aug collates array for array, for
  the cls tail, the seg tail and both det tails (MTL: resize, flip;
  standalone DINO: flip, AutoAugment resize / crop / resize);
* the three task stages on those records;
* the splitters and ``derive_*_device_aug`` of every config of configs/
  that asks for device augmentation.

Tolerances, as (uint8 levels, the share of values allowed to differ at
all): the integer pointwise ops (all but AutoContrast), the HSV
conversions, the photometric distortion, the erase and the seg stage are
exactly equal (``EXACT``, 0 levels). Where a float sum or product is
rounded or truncated to a level, XLA may contract it into fused
multiply-adds and sums in another order than torch: AutoContrast, the
warp of Rotate / Shear / ShearY / Translate / TranslateY, and the float32
resample products (random_resized_crop, so the cls stage, and the det
stage) are held to at most 1 level on at most 0.5% of the values
(``ONE_LEVEL``). Records and collates are exactly
equal. The erase noise (fill_std > 0) comes from another generator in each
package, so it matches only in distribution.

"""

import dataclasses
import functools
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu import apis as jax_apis
from rscotr_tpu.config import Config
from rscotr_tpu.data import load_data_cfg as jax_load_data_cfg
from rscotr_tpu.data import loader as JL
from rscotr_tpu.data import pipelines as JP
from rscotr_tpu.ops import device_augment as JD
from rscotr_tpu_torch import apis
from rscotr_tpu_torch.data import load_data_cfg
from rscotr_tpu_torch.data import loader as TL
from rscotr_tpu_torch.data import pipelines as TP
from rscotr_tpu_torch.ops import device_augment as TD
from rscotr_tpu_torch.utils.config import load_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILL = (124.0, 116.0, 104.0)
# (max uint8 levels, share of values allowed to differ at all)
EXACT = (0.0, 0.0)
ONE_LEVEL = (1.0, 0.005)
B_CLS, S_CLS, O_CLS = 16, 48, 32
# the slot ops that round or truncate a float sum or product (ONE_LEVEL)
FLOAT_ROUNDED = ("AutoContrast", "Rotate", "Shear", "ShearY", "Translate",
                 "TranslateY")
AUG_KEYS = ("cls_device_augment", "det_device_augment",
            "seg_device_augment")
AUG_CONFIGS = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "configs", "**", "*.py"), recursive=True)
    if any(isinstance(e, dict) and any(
        (e.get("loader") or {}).get(k) for k in AUG_KEYS)
        for e in (load_cfg(p).get("data") or {}).values()))


def jit(fn, *static, **kw):
    """JAX's ``fn`` with its leading ``static`` arguments and ``kw``
    bound, jitted."""
    return jax.jit(functools.partial(fn, *static, **kw))


def _smooth(b, size, seed):
    """uint8-valued float images, box-blurred twice (as JAX's tests make
    them, so interpolation differences are signal, not noise)."""
    img = np.random.default_rng(seed).uniform(
        0, 255, (b, size, size, 3)).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 1) + np.roll(img, -1, 1) +
               np.roll(img, 1, 2) + np.roll(img, -1, 2)) / 5.0
    return np.round(np.clip(img, 0, 255))


def within(got, want, tol, what=""):
    """``got`` (tensor) and ``want`` (JAX or numpy) differ by at most
    tol[0] levels, on at most a tol[1] share of the values."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got.astype(np.float64) - want)
    assert d.max() <= tol[0], (what, d.max())
    assert (d > 0).mean() <= tol[1], (what, (d > 0).mean())


def same_batch(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def records(batch):
    """The batch's aug_* records for each package."""
    aug = {k[len("aug_"):]: v for k, v in batch.items()
           if k.startswith("aug_")}
    return ({k: jnp.asarray(v) for k, v in aug.items()},
            {k: torch.as_tensor(v) for k, v in aug.items()})


# ---------------------------------------------------------------------------
# single ops
# ---------------------------------------------------------------------------

def test_every_slot_op_matches_jax():
    """One slot over 16 images, each with its own op id (the 15 of
    RAND_AUG_OP_NAMES and Invert again, the magnitudes alternating in
    sign), so every warp and every pointwise candidate is selected
    somewhere."""
    ids = np.arange(B_CLS, dtype=np.int32) % 15
    m = np.float32([0.8, -0.6] * (B_CLS // 2))
    base = _smooth(B_CLS, O_CLS, 0)
    want = jit(JD.apply_rand_augment_slot, fill=FILL)(base, ids, m)
    got = TD.apply_rand_augment_slot(torch.as_tensor(base),
                                     torch.as_tensor(ids),
                                     torch.as_tensor(m), FILL)
    for i, oid in enumerate(ids):
        name = TD.RAND_AUG_OP_NAMES[oid]
        within(got[i], want[i], ONE_LEVEL if name in FLOAT_ROUNDED
               else EXACT, name)
        assert not torch.equal(got[i], torch.as_tensor(base[i])), name


def test_random_resized_crop_matches_jax():
    base = _smooth(B_CLS, S_CLS, 1)
    rng = np.random.default_rng(1)
    box = [rng.integers(0, 16, B_CLS), rng.integers(0, 16, B_CLS),
           rng.integers(12, 33, B_CLS), rng.integers(12, 33, B_CLS)]
    want = jit(JD.random_resized_crop, out_size=O_CLS)(base, *box)
    got = TD.random_resized_crop(torch.as_tensor(base),
                                 *[torch.as_tensor(b) for b in box], O_CLS)
    within(got, want, ONE_LEVEL)


def test_resample_matrix_matches_jax():
    """The seg use (resize-then-crop, the flip folded in as an output
    mirror, rows past the crop zero) and the det use (a source mirror of
    the valid length)."""
    B, S = 3, 40
    z = np.zeros(B, np.int32)
    src = np.full(B, S, np.int32)
    row0, out_len = np.int32([4, 9, 0]), np.int32([60, 30, 40])
    n_valid = np.int32([24, 20, 32])
    flip = np.array([True, False, True])
    args = (z, src, row0, out_len, n_valid)
    want = jit(JD.pil_resample_matrix, 32, S, kernel="bilinear")(
        *args, mirror_out=flip)
    got = TD.pil_resample_matrix(32, S, *map(torch.as_tensor, args),
                                 kernel="bilinear",
                                 mirror_out=torch.as_tensor(flip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got[0, 24:].abs().max() == 0
    valid = np.int32([30, 40, 21])
    args = (z, valid, z, out_len, out_len)
    want = jit(JD.pil_resample_matrix, 64, S)(*args, mirror_src=flip)
    got = TD.pil_resample_matrix(64, S, *map(torch.as_tensor, args),
                                 mirror_src=torch.as_tensor(flip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_hsv_round_trip_matches_jax():
    """24,576 random (r, g, b) triples, and the same values read as HSV:
    JAX's formulas, not Pillow's (which JAX's own test allows one H level
    from)."""
    rgb = np.random.default_rng(0).integers(0, 256, (6, 64, 64, 3))
    rgb = rgb.astype(np.float32)
    want = jit(JD.pil_rgb_to_hsv)(rgb)
    got = TD.pil_rgb_to_hsv(torch.as_tensor(rgb))
    for g, w in zip(got, want):
        within(g, w, EXACT)
    hsv = [torch.as_tensor(rgb[..., k]) for k in range(3)]
    within(TD.pil_hsv_to_rgb(*hsv),
           jit(JD.pil_hsv_to_rgb)(*[x.numpy() for x in hsv]), EXACT)


def test_photometric_distortion_matches_jax():
    """The host transform's draws of 6 seeds as records (the HSV round
    trip on and off, saturation, hue, contrast before and after it)."""
    base = _smooth(6, 64, 5)
    pm = TP.PhotoMetricDistortion(brightness_delta=60)
    ps = [pm.draw_params(np.random.default_rng(243 + i)) for i in range(6)]
    rec = {k: np.asarray([p[k] for p in ps],
                         bool if k == "hsv_on" else np.float32)
           for k in ps[0]}
    assert 0 < rec["hsv_on"].sum() < 6
    assert (rec["c_pre"] != 1).any() and (rec["c_post"] != 1).any() and \
        (rec["sat"] != 1).any() and (rec["hue"] != 0).any()
    want = jit(JD.photometric_distortion)(base, rec)
    got = TD.photometric_distortion(
        torch.as_tensor(base), {k: torch.as_tensor(v) for k, v in rec.items()})
    within(got, want, EXACT)


def test_random_erase_constant_fill_matches_jax():
    rng = np.random.default_rng(3)
    H = O_CLS
    args = (rng.random(B_CLS) < 0.75, rng.integers(0, H // 2, B_CLS),
            rng.integers(0, H // 2, B_CLS), rng.integers(1, H // 2, B_CLS),
            rng.integers(1, H // 2, B_CLS))
    base = _smooth(B_CLS, H, 6)
    fill, std = (104.0, 116.0, 124.0), (0.0, 0.0, 0.0)
    want = jit(JD.random_erase, fill=fill, fill_std=std)(
        base, *args, noise_key=jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    got = TD.random_erase(torch.as_tensor(base),
                          *map(torch.as_tensor, args), fill, std, gen)
    within(got, want, EXACT)
    assert not torch.equal(got, torch.as_tensor(base))
    # with every std 0 nothing is drawn: the step's generator, and the
    # mixup / cutmix draws after it, stay where they were
    assert torch.equal(gen.get_state(), state)


def test_random_erase_noise_matches_jax_in_distribution():
    """fill + std * N(0, 1) inside the box, clipped; the image elsewhere.
    Each package draws from its own generator, so the box's mean and
    spread are compared with the fill and the std, not pixel for pixel."""
    base = np.zeros((1, 96, 96, 3), np.float32)
    args = [np.asarray(a) for a in ([True], [8], [8], [80], [80])]
    fill, std = (100.0, 120.0, 140.0), (10.0, 5.0, 20.0)
    gen = torch.Generator().manual_seed(0)
    got = TD.random_erase(torch.as_tensor(base),
                          *map(torch.as_tensor, args), fill, std, gen)
    want = np.asarray(jit(JD.random_erase, fill=fill, fill_std=std)(
        base, *args, noise_key=jax.random.key(0)))
    for out in (got.numpy(), want):
        box = out[0, 8:88, 8:88].reshape(-1, 3)
        np.testing.assert_allclose(box.mean(0), fill, atol=1.0)
        np.testing.assert_allclose(box.std(0), std, rtol=0.05)
        assert out[0, :8].max() == 0 and out[0, 88:].max() == 0


def test_full_f32_holds_whatever_the_flag_says():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with TD._full_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# planners, collates and the three stages
# ---------------------------------------------------------------------------

def _planned(j_planner, t_planner, samples, seed0):
    """Both planners over the same samples and seeds."""
    js = [j_planner(dict(s), np.random.default_rng(seed0 + i))
          for i, s in enumerate(samples)]
    ts = [t_planner(dict(s), np.random.default_rng(seed0 + i))
          for i, s in enumerate(samples)]
    return js, ts


def test_cls_planner_collate_and_stage_match_jax():
    """The reference's policy list, the erase drawn on half the samples;
    sources of 48^2 (one of 40^2, resized to the static source) -> 32^2."""
    kw = dict(rrc=dict(size=O_CLS), flip=dict(flip_prob=0.5),
              rand_aug=dict(policies=load_cfg(os.path.join(
                  ROOT, "configs/_base_/cls/rand_aug.py"))[
                      "rand_increasing_policies"],
                  num_policies=2, magnitude_level=9, magnitude_std=0.5),
              erase=dict(erase_prob=0.5, mode="rand",
                         fill_color=[104, 116, 124], fill_std=[0, 0, 0]),
              src_size=S_CLS)
    imgs = list(_smooth(B_CLS - 1, S_CLS, 3)) + [_smooth(1, 40, 4)[0]]
    samples = [{"img": im, "gt_label": np.int32(i)}
               for i, im in enumerate(imgs)]
    js, ts = _planned(JP.DeviceAugmentPlanner(**kw),
                      TP.DeviceAugmentPlanner(**kw), samples, 50)
    want, got = JL.collate_cls_aug(js), TL.collate_cls_aug(ts)
    same_batch(got, want)
    assert want["aug_erase_on"].any() and want["aug_flip"].any()
    ja, ta = records(want)
    cfg = dict(src_size=S_CLS, out_size=O_CLS,
               erase_fill=(104., 116., 124.))
    want_img = jit(JD.cls_device_augment, cfg=JD.DeviceAugmentConfig(**cfg))(
        want["img"], ja, noise_key=jax.random.key(0))
    got_img = TD.cls_device_augment(torch.as_tensor(got["img"]), ta,
                                    TD.DeviceAugmentConfig(**cfg))
    within(got_img, want_img, ONE_LEVEL)


def test_seg_planner_collate_and_stage_match_jax():
    """Ratio resize 0.5-2, crop with cat_max_ratio redraws on a striped
    label, flip, photometric; a 48^2 tile resized to the 64^2 source with
    its label. The stage's pad region (past crop_h / crop_w) is left for
    the step's mask in both."""
    Sz = 64
    kw = dict(resize=dict(img_scale=(Sz, Sz), ratio_range=(0.5, 2.0)),
              crop=dict(crop_size=(Sz, Sz), cat_max_ratio=0.75,
                        ignore_index=255),
              flip=dict(prob=0.5), photometric={},
              pad=dict(size=(Sz, Sz), pad_val=0, seg_pad_val=5), src_size=Sz)
    label = ((np.arange(Sz)[:, None] // 8 + np.arange(Sz)[None, :] // 8)
             % 5).astype(np.uint8)
    imgs = list(_smooth(5, Sz, 11)) + [_smooth(1, 48, 12)[0]]
    samples = [{"img": im, "gt_semantic_seg": label[:len(im), :len(im)],
                "ori_shape": im.shape} for im in imgs]
    js, ts = _planned(JP.SegDeviceAugmentPlanner(**kw),
                      TP.SegDeviceAugmentPlanner(**kw), samples, 400)
    want, got = JL.collate_seg_aug(js), TL.collate_seg_aug(ts)
    same_batch(got, want)
    assert (want["img_hw"] < Sz).any() and want["aug_pm_hsv_on"].any()
    ja, ta = records(want)
    cfg = dict(src_size=Sz, out_size=Sz)
    within(TD.seg_device_augment(torch.as_tensor(got["img"]), ta,
                                 TD.SegDeviceAugmentConfig(**cfg)),
           jit(JD.seg_device_augment, cfg=JD.SegDeviceAugmentConfig(**cfg))(
               want["img"], ja), EXACT)


SRC = 80
SCALES = [(48, 133), (51, 133), (64, 133), (80, 133)]
DET_TAILS = {
    # the MTL det tail (configs/_base_/det/dior.py) at 80 / 800 scale
    "mtl": [dict(type="Resize", img_scale=(133, 64), keep_ratio=True),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize")],
    # the standalone DINO's (configs/det/dino_4scale_r50_1x1_50e_dior.py)
    "dino": [dict(type="RandomFlip", flip_ratio=0.5),
             dict(type="AutoAugment", policies=[
                 [dict(type="Resize", img_scale=SCALES,
                       multiscale_mode="value", keep_ratio=True)],
                 [dict(type="Resize", img_scale=[(40, 420), (50, 420),
                                                 (60, 420)],
                       multiscale_mode="value", keep_ratio=True),
                  dict(type="RandomCrop", crop_type="absolute_range",
                       crop_size=(38, 60), allow_negative_crop=True),
                  dict(type="Resize", img_scale=SCALES,
                       multiscale_mode="value", override=True,
                       keep_ratio=True)]]),
             dict(type="Normalize"), dict(type="Pad", size_divisor=1)]}


@pytest.mark.parametrize("tail", sorted(DET_TAILS))
def test_det_planner_collate_and_stage_match_jax(tail):
    """The split, the planner's programs and box arithmetic, the aug
    collate (a bucket list, the DN ladder's ``dn_wide``, the zero-width
    ``out_template``) and the two-stage resample; zero outside each
    image's valid region."""
    cfgs = DET_TAILS[tail]
    want_split = JP.split_det_device_augment_cfg(cfgs, src_hw=(SRC, SRC))
    got_split = TP.split_det_device_augment_cfg(cfgs, src_hw=(SRC, SRC))
    assert got_split == want_split
    boxes = np.array([[5, 6, 30, 40], [20, 25, 75, 70], [50, 2, 65, 20]],
                     np.float32)
    imgs = list(_smooth(7, SRC, 21)) + [_smooth(1, 60, 22)[0]]
    samples = [{"img": im, "gt_bboxes": boxes.copy(),
                "gt_labels": np.int32([1, 2, 3]), "ori_shape": im.shape}
               for im in imgs]
    js, ts = _planned(JP.build_pipeline(want_split[0])[0],
                      TP.build_pipeline(got_split[0])[0], samples, 700)
    kw = dict(bucket_hw=[(80, 80), (136, 136)], max_gt=8, dn_ladder=(2, 8))
    want, got = JL.collate_det_aug(js, **kw), TL.collate_det_aug(ts, **kw)
    same_batch(got, want)
    assert want["aug_flip_src" if tail == "dino" else "aug_flip_out"].any()
    ja, ta = records(want)
    out_hw = got["out_template"].shape[1:3]
    cfg = dict(src_hw=(SRC, SRC))
    got_img = TD.det_device_augment(torch.as_tensor(got["img"]), ta, out_hw,
                                    TD.DetDeviceAugmentConfig(**cfg))
    within(got_img, jit(JD.det_device_augment, out_hw=out_hw,
                        cfg=JD.DetDeviceAugmentConfig(**cfg))(
        want["img"], ja), ONE_LEVEL)
    for i, (h, w) in enumerate(got["img_hw"]):
        assert got_img[i, h:].abs().max() == 0 if h < out_hw[0] else True
        assert got_img[i, :, w:].abs().max() == 0 if w < out_hw[1] else True


@pytest.mark.parametrize("task", ["cls", "det", "seg"])
def test_run_stage_picks_and_checks_the_stage(task):
    """``run_stage`` runs a task's stage only when the step config has one
    and the batch carries its planner's records; the stage refuses a
    source off its config's static size."""
    from rscotr_tpu_torch.engine.train_step import TrainStepConfig
    field, marker = TD.STAGES[task]
    cfg = {"cls": TD.DeviceAugmentConfig(src_size=32, out_size=16),
           "det": TD.DetDeviceAugmentConfig(src_hw=(32, 32)),
           "seg": TD.SegDeviceAugmentConfig(src_size=32, out_size=32)}[task]
    step_cfg = TrainStepConfig(task_weight={}, **{field: cfg})
    batch = {"img": torch.zeros((1, 24, 24, 3), dtype=torch.uint8),
             marker: torch.zeros(1, dtype=torch.int32),
             "out_template": torch.zeros((1, 16, 16, 0))}
    with pytest.raises(ValueError, match=r"source \(24, 24\), its config's"):
        TD.run_stage(task, batch, step_cfg)
    assert TD.run_stage(task, {"img": batch["img"]}, step_cfg) is None
    assert TD.run_stage(task, batch, TrainStepConfig(task_weight={})) is None


def test_planners_refuse_what_they_cannot_plan():
    with pytest.raises(ValueError, match="unsupported AutoAugment op"):
        TP.DetDeviceAugmentPlanner([dict(type="AutoAugment", policies=[
            [dict(type="PhotoMetricDistortion")]])])
    with pytest.raises(ValueError, match="unsupported op"):
        TP.DetDeviceAugmentPlanner([dict(type="RandomCrop")])
    with pytest.raises(ValueError, match="after the augment tail"):
        TP.split_device_augment_cfg([dict(type="RandomResizedCrop"),
                                     dict(type="Pad", size=(8, 8))])
    with pytest.raises(ValueError, match="static output"):
        TP.SegDeviceAugmentPlanner(crop=dict(crop_size=(32, 32)),
                                   pad=dict(size=(64, 64)))
    planner = TP.DetDeviceAugmentPlanner(
        [dict(type="Resize", img_scale=(40, 40), keep_ratio=True),
         dict(type="RandomFlip", flip_ratio=1.0),
         dict(type="Resize", img_scale=(20, 20), keep_ratio=True)],
        src_hw=(40, 40))
    with pytest.raises(ValueError, match="flip between resizes"):
        planner({"img": np.zeros((40, 40, 3), np.float32)},
                np.random.default_rng(0))


# ---------------------------------------------------------------------------
# every config that asks for device augmentation
# ---------------------------------------------------------------------------

def _composed(path):
    full = os.path.join(ROOT, path)
    jcfg = Config.fromfile(full)
    if any(isinstance(e, dict) and "config" in e
           for e in jcfg.data.values()):
        jcfg = jax_load_data_cfg(jcfg, config_root=ROOT)
    cfg = load_cfg(full)
    if any(isinstance(e, dict) and "config" in e
           for e in cfg["data"].values()):
        cfg = load_data_cfg(cfg, config_root=ROOT, filename=full)
    return jcfg, cfg


@pytest.mark.parametrize("path", AUG_CONFIGS)
def test_configs_device_augment_match_jax(path):
    """Each config's step config fields (``derive_device_aug``,
    ``derive_det_device_aug``, ``derive_seg_device_aug``, the normalize
    stats) and, for each loader that asks, the planner pipeline the split
    gives and the stage kwargs, as JAX derives them."""
    jcfg, cfg = _composed(path)
    step = apis.make_step_config(cfg)
    asked = 0
    for name in ("device_aug", "det_device_aug", "seg_device_aug"):
        got = getattr(step, name)
        want = getattr(jax_apis, f"derive_{name}")(jcfg)
        assert (got is None) == (want is None), name
        if got is not None:
            asked += 1
            got_d, want_d = dataclasses.asdict(got), dataclasses.asdict(want)
            # JAX's det config also has a stage-1 buffer size that no
            # config sets; the port's stage-1 buffer is the source bucket
            assert want_d.pop("mid_hw", None) is None, name
            assert got_d == want_d, name
    assert asked
    assert step.img_norm == jax_apis.derive_img_norm(jcfg)
    for entry in cfg["data"].values():
        opts = entry.get("loader", {})
        pcfg = list(entry["data"]["train"]["pipeline"])
        if entry["task"] == "cls" and opts.get("cls_device_augment"):
            split = (TP.split_device_augment_cfg, JP.split_device_augment_cfg,
                     dict(src_size=opts.get("cls_src_size", 256)))
        elif entry["task"] == "seg" and opts.get("seg_device_augment"):
            split = (TP.split_seg_device_augment_cfg,
                     JP.split_seg_device_augment_cfg,
                     dict(src_size=opts.get("seg_size", 512)))
        elif entry["task"] == "det" and opts.get("det_device_augment"):
            split = (TP.split_det_device_augment_cfg,
                     JP.split_det_device_augment_cfg,
                     dict(src_hw=tuple(opts.get("det_src_hw", (800, 800)))))
        else:
            continue
        got = split[0](pcfg, **split[2])
        assert got == split[1](pcfg, **split[2])
        assert [type(t).__name__ for t in TP.build_pipeline(got[0])] == \
            [type(t).__name__ for t in JP.build_pipeline(got[0])]
