"""The port's host training transforms against the JAX package's: each of
RandomResizedCrop, RandomCrop (seg's cat_max_ratio redraws, det's
absolute_range with boxes), PhotoMetricDistortion, RandomErasing,
RandAugment (each of its 15 ops, the config's policy list and the default
pool) and AutoAugment (the standalone DINO's two branches), then the train
pipelines of MTL_tiny_synthetic_devaug.py (its host tails, device
augmentation off) and MTL_synthetic_flagship_hostaug.py on their synthetic
sets, sample for sample, and ``build_pipeline`` over every train pipeline
of configs/.

These are numpy / PIL code in both packages, run from one
``np.random.Generator`` seed: the draws, the pixels and the generator's
position afterwards must be exactly equal.
"""

import copy
import glob
import os

import numpy as np
import pytest

from rscotr_tpu.config import Config
from rscotr_tpu.data import build_datasets as jax_build_datasets
from rscotr_tpu.data import load_data_cfg as jax_load_data_cfg
from rscotr_tpu.data import pipelines as JP
from rscotr_tpu_torch.data import build_datasets, load_data_cfg
from rscotr_tpu_torch.data import pipelines as TP
from rscotr_tpu_torch.ops.device_augment import RAND_AUG_OP_NAMES
from rscotr_tpu_torch.utils.config import load_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.py"), recursive=True))
TINY_DEVAUG = "configs/multi/MTL_tiny_synthetic_devaug.py"
FLAGSHIP_HOSTAUG = "configs/multi/MTL_synthetic_flagship_hostaug.py"
RAND_AUG_CFG = os.path.join(ROOT, "configs/_base_/cls/rand_aug.py")


def _img(seed, hw=(40, 52)):
    return np.random.default_rng(seed).uniform(
        0, 255, hw + (3,)).astype(np.float32)


def same_value(g, w, key=""):
    if isinstance(w, np.ndarray):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and \
            g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    elif isinstance(w, dict):
        assert sorted(g) == sorted(w), key
        for k in w:
            same_value(g[k], w[k], f"{key}.{k}")
    else:
        assert g == w and type(g) is type(w), (key, g, w)


def both(make_j, make_t, sample, seed):
    """Each package's transform on its own copy of ``sample`` from its own
    generator of ``seed``: the results equal, and the generators at the
    same position afterwards."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = make_j()(copy.deepcopy(sample), rj)
    got = make_t()(copy.deepcopy(sample), rt)
    same_value(got, want)
    assert rj.integers(1 << 62) == rt.integers(1 << 62)
    return got


# ---------------------------------------------------------------------------
# the six transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(size=24), dict(size=(20, 28), interpolation="bilinear"),
    dict(size=32, scale=(0.9, 1.0), ratio=(5.0, 6.0))],   # centre fallback
    ids=["bicubic", "bilinear_rect", "fallback"])
def test_random_resized_crop_matches_jax(kw):
    for seed in range(4):
        got = both(lambda: JP.RandomResizedCrop(**kw),
                   lambda: TP.RandomResizedCrop(**kw),
                   {"img": _img(seed)}, seed)
        assert got["img"].shape[:2] == tuple(TP.RandomResizedCrop(
            **kw).size)


def test_random_crop_seg_redraws_match_jax():
    """mmseg's cat_max_ratio redraws on a label map where most crops are
    dominated by one class, and the ignore index left out of the count."""
    seg = np.zeros((40, 52), np.uint8)
    seg[:6, :8] = 1
    seg[30:, 40:] = 255
    kw = dict(crop_size=(16, 20), cat_max_ratio=0.75, ignore_index=255)
    for seed in range(6):
        both(lambda: JP.RandomCrop(**kw), lambda: TP.RandomCrop(**kw),
             {"img": _img(seed), "gt_semantic_seg": seg}, seed)


@pytest.mark.parametrize("negative", [False, True])
def test_random_crop_det_matches_jax(negative):
    """mmdet's absolute_range crop: boxes shifted, clipped, the empty ones
    dropped with their labels; with no box left the crop is redrawn, and
    after 10 tries the sample stays uncropped (unless negative crops are
    allowed)."""
    boxes = np.array([[2, 3, 10, 12], [30, 20, 50, 38], [45, 0, 52, 5]],
                     np.float32)
    kw = dict(crop_type="absolute_range", crop_size=(8, 30),
              allow_negative_crop=negative)
    for seed in range(8):
        both(lambda: JP.RandomCrop(**kw), lambda: TP.RandomCrop(**kw),
             {"img": _img(seed), "gt_bboxes": boxes.copy(),
              "gt_labels": np.array([1, 2, 3], np.int32)}, seed)


def test_photometric_distortion_matches_jax():
    """Every branch of the draw (the HSV gate's short-circuit ``or``,
    contrast first or last), over 24 seeds; values beyond 0..255 clip."""
    kw = dict(brightness_delta=60)
    hsv = 0
    for seed in range(24):
        both(lambda: JP.PhotoMetricDistortion(**kw),
             lambda: TP.PhotoMetricDistortion(**kw),
             {"img": _img(seed, (12, 16))}, seed)
        hsv += TP.PhotoMetricDistortion(**kw).draw_params(
            np.random.default_rng(seed))["hsv_on"]
    assert 0 < hsv < 24


@pytest.mark.parametrize("kw", [
    dict(erase_prob=1.0, mode="rand", fill_color=[104, 116, 124],
         fill_std=[0, 0, 0]),
    dict(erase_prob=1.0, mode="rand", fill_std=[10.0, 20.0, 30.0]),
    dict(erase_prob=0.5, mode="const", fill_color=[1, 2, 3])],
    ids=["rand_std0", "rand_noise", "const"])
def test_random_erasing_matches_jax(kw):
    for seed in range(4):
        both(lambda: JP.RandomErasing(**kw), lambda: TP.RandomErasing(**kw),
             {"img": _img(seed)}, seed)


def test_rand_aug_table_matches_jax():
    assert [(n, s) for n, _, s in TP.RAND_AUG_OPS] == \
        [(n, s) for n, _, s in JP.RAND_AUG_OPS]
    assert [n for n, _, _ in TP.RAND_AUG_OPS] == list(RAND_AUG_OP_NAMES)


@pytest.mark.parametrize("name", RAND_AUG_OP_NAMES)
def test_rand_aug_op_matches_jax(name):
    """Each op at the magnitudes RandAugment draws (unsigned ops take
    m >= 0) on a non-square image."""
    jfn = {n: f for n, f, _ in JP.RAND_AUG_OPS}[name]
    tfn = {n: f for n, f, _ in TP.RAND_AUG_OPS}[name]
    signed = dict((n, s) for n, _, s in TP.RAND_AUG_OPS)[name]
    img = _img(7, (28, 36))
    for m in (0.05, 0.55, 1.0) + ((-0.35, -1.0) if signed else ()):
        same_value(tfn(img.copy(), m), jfn(img.copy(), m), f"{name} {m}")


@pytest.mark.parametrize("policies", ["config", "default"])
def test_rand_augment_matches_jax(policies):
    """The reference's policy list (configs/_base_/cls/rand_aug.py: Shear
    and Translate in both directions) and the built-in pool, over 12
    seeds."""
    kw = dict(num_policies=2, total_level=10, magnitude_level=9,
              magnitude_std=0.5)
    if policies == "config":
        kw["policies"] = load_cfg(RAND_AUG_CFG)["rand_increasing_policies"]
    for seed in range(12):
        both(lambda: JP.RandAugment(**kw), lambda: TP.RandAugment(**kw),
             {"img": _img(seed, (24, 24))}, seed)
    with pytest.raises(KeyError, match="unknown RandAugment policy"):
        TP.RandAugment(policies=[dict(type="Cutout")])


def test_auto_augment_matches_jax():
    """The standalone DINO's det tail (configs/det/
    dino_4scale_r50_1x1_50e_dior.py) scaled down: a flip, then one of two
    AutoAugment branches, the second a resize, an absolute_range crop and
    a resize."""
    scales = [(24, 66), (30, 66), (36, 66)]
    tail = [dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="AutoAugment", policies=[
                [dict(type="Resize", img_scale=scales,
                      multiscale_mode="value", keep_ratio=True)],
                [dict(type="Resize", img_scale=[(20, 210), (25, 210)],
                      multiscale_mode="value", keep_ratio=True),
                 dict(type="RandomCrop", crop_type="absolute_range",
                      crop_size=(12, 20), allow_negative_crop=True),
                 dict(type="Resize", img_scale=scales,
                      multiscale_mode="value", override=True,
                      keep_ratio=True)]])]
    boxes = np.array([[2, 3, 20, 22], [25, 10, 50, 36]], np.float32)
    shapes = set()
    for seed in range(10):
        got = both(lambda: JP.build_pipeline(tail)[1],
                   lambda: TP.build_pipeline(tail)[1],
                   {"img": _img(seed), "gt_bboxes": boxes.copy(),
                    "gt_labels": np.array([4, 5], np.int32)}, seed)
        shapes.add(got["img"].shape)
    assert len(shapes) > 1


# ---------------------------------------------------------------------------
# whole train pipelines on the configs' synthetic sets
# ---------------------------------------------------------------------------

def _cfgs(path):
    jcfg = jax_load_data_cfg(Config.fromfile(os.path.join(ROOT, path)),
                             config_root=ROOT)
    cfg = load_data_cfg(load_cfg(os.path.join(ROOT, path)),
                        config_root=ROOT, filename=os.path.join(ROOT, path))
    return jcfg, cfg


@pytest.mark.parametrize("path,n", [(TINY_DEVAUG, 6),
                                    (FLAGSHIP_HOSTAUG, 2)])
def test_train_pipelines_match_jax_sample_for_sample(path, n):
    """Each train set's first ``n`` samples through its whole train
    pipeline as written, each from its own seeded generator: the tiny
    devaug config's (run on the host: cls 160^2 -> 128^2, det, seg 128^2)
    and the flagship hostaug config's (cls 256^2 -> 224^2 with the
    reference's policy list, det 800^2, seg 512^2)."""
    jcfg, cfg = _cfgs(path)
    jds, tds = jax_build_datasets(jcfg.data), build_datasets(cfg["data"])
    assert sorted(jds) == sorted(tds)
    for name in tds:
        jpipe = JP.build_pipeline(jds[name].pipeline_cfg)
        tpipe = TP.build_pipeline(tds[name].pipeline_cfg)
        assert [type(t).__name__ for t in tpipe] == \
            [type(t).__name__ for t in jpipe]
        for i in range(n):
            seed = 1000 + i
            want = JP.run_pipeline(jpipe, jds[name][i],
                                   np.random.default_rng(seed))
            got = TP.run_pipeline(tpipe, tds[name][i],
                                  np.random.default_rng(seed))
            same_value(got, want, f"{name}[{i}]")


def _train_pipelines(path):
    """{dataset: train pipeline} of a config file: a base file's own
    ``data.train``, or each entry of a composed config's ``data``."""
    full = os.path.join(ROOT, path)
    data = load_cfg(full).get("data") or {}
    if "train" in data:
        return {"train": data["train"].get("pipeline")}
    if any(isinstance(e, dict) and "config" in e for e in data.values()):
        data = load_data_cfg({"data": data}, config_root=ROOT,
                             filename=full)["data"]
    return {name: (e["data"].get("train") or {}).get("pipeline")
            for name, e in data.items()
            if isinstance(e, dict) and "data" in e}


@pytest.mark.parametrize("path", CONFIGS)
def test_every_train_pipeline_builds(path):
    """``build_pipeline`` builds the train pipeline of every dataset of
    every file of configs/ with the transforms JAX's builds."""
    for name, pcfg in _train_pipelines(path).items():
        if not pcfg:
            continue
        got = [type(t).__name__ for t in TP.build_pipeline(pcfg)]
        assert got == [type(t).__name__ for t in JP.build_pipeline(pcfg)], \
            name
