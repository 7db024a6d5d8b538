"""The port's data side of evaluation against the JAX package's, sample for
sample: every dataset class, the test pipelines, the collates and loaders,
``format_results``, and the config reader (``{{_base_.x}}`` references,
``load_data_cfg``, ``--cfg-options``).

The synthetic sets run as the configs define them; the real-format ones
are written into ``tmp_path`` with PIL: a RESISC folder of PNGs of two
sizes, a two-image COCO json (plus an image whose only box is a crowd one,
which ``filter_empty_gt`` drops) and two Potsdam tiles of 300 x 400, which
the test pipeline's keep-ratio resize takes to 384 x 512. Each goes through
the pipeline of its ``configs/_base_`` file.
"""

import glob
import json
import os

import numpy as np
import pytest
from PIL import Image

from rscotr_tpu.config import Config
from rscotr_tpu.config import DictAction as JaxDictAction
from rscotr_tpu.data import build_dataloaders as jax_build_dataloaders
from rscotr_tpu.data import datasets as JD
from rscotr_tpu.data import load_data_cfg as jax_load_data_cfg
from rscotr_tpu.data.build import build_dataset as jax_build_dataset
from rscotr_tpu.data.pipelines import build_pipeline as jax_build_pipeline
from rscotr_tpu.data.pipelines import run_pipeline as jax_run_pipeline
from rscotr_tpu_torch.data import build_dataloaders, load_data_cfg
from rscotr_tpu_torch.data import datasets as PD
from rscotr_tpu_torch.data.build import build_dataset
from rscotr_tpu_torch.data.pipelines import build_pipeline, run_pipeline
from rscotr_tpu_torch.utils.config import (DictAction, load_cfg,
                                           merge_from_dict)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.py"), recursive=True))
WITH_DATA_FILES = [p for p in CONFIGS if any(
    "config" in e for e in load_cfg(os.path.join(ROOT, p)).get(
        "data", {}).values() if isinstance(e, dict))]


def _base(name):
    return load_cfg(os.path.join(ROOT, "configs", "_base_", name))


def same_sample(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w and type(g) is type(w), (k, g, w)


def same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        same_sample(g, w)


# ---------------------------------------------------------------------------
# config reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_load_cfg_matches_jax_config(path):
    """Every file of configs/, {{_base_.x}} references included
    (configs/_base_/cls/resisc_swin_224.py and the flagship's hostaug /
    devaug), composes to the JAX reader's dict."""
    p = os.path.join(ROOT, path)
    want = Config.fromfile(p, import_custom_modules=False).to_dict()
    assert load_cfg(p) == want


def test_base_references_resolve():
    cfg = _base("cls/resisc_swin_224.py")
    ra = next(op for op in cfg["train_pipeline"]
              if op["type"] == "RandAugment")
    assert ra["policies"] == _base("cls/rand_aug.py")[
        "rand_increasing_policies"]
    host = load_cfg(os.path.join(
        ROOT, "configs/multi/MTL_synthetic_flagship_hostaug.py"))
    assert host["data"]["resisc"]["data"]["train"]["pipeline"]


@pytest.mark.parametrize("path", WITH_DATA_FILES)
def test_load_data_cfg_matches_jax(path):
    """The per-dataset config files inlined as the JAX package does."""
    p = os.path.join(ROOT, path)
    got = load_data_cfg(load_cfg(p), config_root=ROOT, filename=p)
    want = jax_load_data_cfg(Config.fromfile(p, import_custom_modules=False),
                             config_root=ROOT).to_dict()
    assert got["data"] == want["data"]
    assert all("pipeline" in e["data"]["val"] for e in got["data"].values())


def test_cfg_options_match_jax():
    import argparse
    argv = ["--cfg-options", "model.backbone.depths=[1,1,2,1]",
            "data.resisc.loader.cls_size=96", "optimizer.lr=1e-3",
            "a.flag=true", "a.none=null", "a.lst=x,y", "a.word=abc",
            "model.test_cfg.det.max_per_img=7"]
    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    ours.add_argument("--cfg-options", nargs="+", action=DictAction)
    theirs.add_argument("--cfg-options", nargs="+",
                        action=JaxDictAction.action())
    opts = ours.parse_args(argv).cfg_options
    assert opts == theirs.parse_args(argv).cfg_options
    assert opts["a.flag"] is True and opts["a.lst"] == ["x", "y"]
    p = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
    jcfg = Config.fromfile(p)
    jcfg.merge_from_dict(opts)
    assert merge_from_dict(load_cfg(p), opts) == jcfg.to_dict()
    # a digit key indexes into a list
    lst = {"optimizer.paramwise_cfg.custom_keys.backbone.lr_mult": 0.5,
           "x.0": 1}
    cfg = merge_from_dict({"x": [{"a": 1}, 2]}, {"x.0.a": 3})
    assert cfg == {"x": [{"a": 3}, 2]}
    jcfg.merge_from_dict(lst)
    assert merge_from_dict(merge_from_dict(load_cfg(p), opts), lst) == \
        jcfg.to_dict()


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------

def test_train_transforms_wait_for_m5():
    """The base files' train pipelines build (ROADMAP M8's transforms,
    ported) and, on one image, label and set of boxes each, make
    what JAX's make from the same seed (RandomResizedCrop, RandAugment with
    the reference's policies, RandomErasing; the ratio resize, RandomCrop
    with cat_max_ratio, PhotoMetricDistortion, Pad; dior's keep-ratio
    resize and flip)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (96, 128, 3)).astype(np.float32)
    seg = (np.arange(128)[None, :] // 24 + np.zeros((96, 1), int)) % 5
    sample = {"img": img, "gt_semantic_seg": seg.astype(np.uint8),
              "gt_bboxes": np.array([[4, 6, 60, 50]], np.float32),
              "gt_labels": np.array([3], np.int32)}
    for name in ("cls/resisc_swin_224.py", "seg/potsdam_IRRG_all.py",
                 "det/dior.py"):
        cfg = _base(name)["train_pipeline"]
        got, want = build_pipeline(cfg), jax_build_pipeline(cfg)
        assert [type(t).__name__ for t in got] == \
            [type(t).__name__ for t in want]
        for seed in range(3):
            same_sample(
                run_pipeline(got, dict(sample), np.random.default_rng(seed)),
                jax_run_pipeline(want, dict(sample),
                                 np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_test_pipelines_match_jax(seed):
    """Resize (keep ratio, exact size, scale list, ratio range), RandomFlip
    (both directions), Pad (size, divisor) and Normalize, and a
    MultiScaleFlipAug flattened, on one image with boxes and a label map,
    each from the same seeded generator."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (61, 83, 3)).astype(np.float32)
    sample = dict(img=img, ori_shape=img.shape, img_shape=img.shape,
                  gt_bboxes=np.array([[3, 4, 40, 50], [10, 0, 83, 61]],
                                     np.float32),
                  gt_labels=np.array([1, 2], np.int32),
                  gt_semantic_seg=rng.integers(0, 6, (61, 83)).astype(
                      np.int32))
    cfgs = [
        dict(type="LoadImageFromFile"),
        dict(type="MultiScaleFlipAug", transforms=[
            dict(type="Resize", img_scale=[(90, 60), (50, 70)],
                 keep_ratio=True),
            dict(type="RandomFlip", prob=0.7),
            dict(type="ImageToTensor", keys=["img"]),
            dict(type="Collect", keys=["img"])]),
        dict(type="Resize", img_scale=(64, 48), ratio_range=(0.5, 1.5)),
        dict(type="RandomFlip", flip_ratio=0.6, direction="vertical"),
        dict(type="Resize", size=(40, 40), keep_ratio=False,
             interpolation="bicubic"),
        dict(type="Pad", size_divisor=16, seg_pad_val=5),
        dict(type="Normalize", mean=[1, 2, 3], std=[4, 5, 6]),
        dict(type="Pad", size=(50, 64)),
    ]
    got = run_pipeline(build_pipeline(cfgs), dict(sample),
                       np.random.default_rng(seed))
    want = jax_run_pipeline(jax_build_pipeline(cfgs), dict(sample),
                            np.random.default_rng(seed))
    same_sample(got, want)


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------

SYNTHETIC = {
    "SyntheticClsDataset": dict(length=5, img_size=40, num_classes=7,
                                seed=1),
    "SyntheticDetDataset": dict(length=5, img_size=64, num_classes=4,
                                max_boxes=6, seed=2),
    "SyntheticSegDataset": dict(length=5, img_size=48, num_classes=5,
                                seed=3),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_datasets_match_jax(name):
    ds = getattr(PD, name)(**SYNTHETIC[name])
    jds = getattr(JD, name)(**SYNTHETIC[name])
    assert len(ds) == len(jds) and ds.CLASSES == jds.CLASSES
    assert ds.task == jds.task
    for i in range(len(ds)):
        same_sample(ds[i], jds[i])
    rng = np.random.default_rng(4)
    if ds.task == "cls":
        res = list(rng.random((5, 7)).astype(np.float32))
    elif ds.task == "det":
        for a, b in zip(ds.get_annotations(), jds.get_annotations()):
            same_sample(a, b)
        res = [[np.concatenate([rng.uniform(0, 32, (3, 2)),
                                rng.uniform(32, 64, (3, 2)),
                                rng.random((3, 1))], 1).astype(np.float32)
                for _ in range(4)] for _ in range(5)]
    else:
        np.testing.assert_array_equal(ds.get_gt_seg_map(2),
                                      jds.get_gt_seg_map(2))
        res = [rng.integers(0, 8, (48, 48)) for _ in range(5)]
    assert ds.evaluate(res) == jds.evaluate(res)
    if ds.task == "det":
        assert ds.evaluate(res, classwise=True) == \
            jds.evaluate(res, classwise=True)
    if ds.task == "seg":
        kw = dict(metric=["mIoU", "mFscore"], classwise=True)
        pre = [ds.pre_eval(r, i) for i, r in enumerate(res)]
        assert ds.evaluate(pre, **kw) == jds.evaluate(res, **kw)


@pytest.mark.parametrize("flagship_set", ["resisc", "dior", "potsdam"])
def test_flagship_val_loaders_match_jax(flagship_set):
    """The flagship's val sets at their full size, through both packages'
    eval loaders (first batch)."""
    p = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")
    cfg, jcfg = load_cfg(p), Config.fromfile(p)
    entry = cfg["data"][flagship_set]
    ds = build_dataset(entry["data"]["val"])
    jds = jax_build_dataset(jcfg.data[flagship_set]["data"]["val"])
    ds.task = jds.task = entry["task"]
    loaders = build_dataloaders({flagship_set: ds}, cfg["data"], train=False)
    jloaders = jax_build_dataloaders({flagship_set: jds}, jcfg.data,
                                     train=False)
    loader, jloader = loaders[flagship_set], jloaders[flagship_set]
    assert (len(loader), loader.batch_size) == (len(jloader),
                                               jloader.batch_size) == \
        {"resisc": (4, 8), "dior": (2, 4), "potsdam": (2, 4)}[flagship_set]
    same_sample(next(iter(loader)), next(iter(jloader)))


@pytest.mark.parametrize("replicas,rank", [(1, 0), (2, 1)])
def test_train_loader_matches_jax(replicas, rank):
    """The training side of ``build_dataloaders``: shuffled order, the
    rank's strided share and per-sample seeds (through a RandomFlip)."""
    data = {"potsdam": dict(
        task="seg", loader=dict(seg_size=32, seg_pad_val=5),
        data=dict(samples_per_gpu=2, train=dict(
            type="SyntheticSegDataset", length=7, img_size=32, seed=5,
            pipeline=[dict(type="RandomFlip", prob=0.5)])))}
    ds = {"potsdam": build_dataset(data["potsdam"]["data"]["train"])}
    jds = {"potsdam": jax_build_dataset(data["potsdam"]["data"]["train"])}
    ds["potsdam"].task = jds["potsdam"].task = "seg"
    kw = dict(train=True, seed=3, world_size=2, num_replicas=replicas,
              rank=rank)
    loader = build_dataloaders(ds, data, **kw)["potsdam"]
    jloader = jax_build_dataloaders(jds, data, **kw)["potsdam"]
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        same_batches(loader, jloader)
    # on-device augmentation (ROADMAP M6, ported): the planner's uint8
    # tiles, labels and aug_* records, as JAX's loader makes them
    data["potsdam"]["loader"]["seg_device_augment"] = True
    ds["potsdam"].pipeline_cfg = jds["potsdam"].pipeline_cfg = [
        dict(type="Resize", img_scale=(32, 32), ratio_range=(0.5, 2.0)),
        dict(type="RandomCrop", crop_size=(32, 32), cat_max_ratio=0.75),
        dict(type="RandomFlip", prob=0.5), dict(type="PhotoMetricDistortion"),
        dict(type="Normalize"),
        dict(type="Pad", size=(32, 32), pad_val=0, seg_pad_val=5)]
    loader = build_dataloaders(ds, data, **kw)["potsdam"]
    jloader = jax_build_dataloaders(jds, data, **kw)["potsdam"]
    assert loader.img_norm == jloader.img_norm is not None
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        same_batches(loader, jloader)
    assert next(iter(loader))["img"].dtype == np.uint8


# ---------------------------------------------------------------------------
# real-format datasets in tmp_path
# ---------------------------------------------------------------------------

def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _both(ds_cfg, name, task, loader_opts, bs=2):
    """(port, JAX) datasets and their eval loaders for one config entry."""
    data = {name: dict(task=task, data=dict(test_samples_per_gpu=bs,
                                            val=ds_cfg),
                       loader=loader_opts)}
    ds, jds = build_dataset(ds_cfg), jax_build_dataset(ds_cfg)
    ds.task = jds.task = task
    return (ds, jds, build_dataloaders({name: ds}, data, train=False)[name],
            jax_build_dataloaders({name: jds}, data, train=False)[name])


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_resisc_folder_matches_jax(tmp_path, device_preprocess):
    rng = np.random.default_rng(0)
    classes = ("beach", "forest", "river")
    for c in classes:
        for i, hw in enumerate(((40, 50), (64, 48))):
            _png(str(tmp_path / c / f"{c}_{i}.png"),
                 rng.integers(0, 256, hw + (3,)).astype(np.uint8))
    cfg = dict(_base("cls/resisc_swin_224.py")["data"]["val"],
               data_prefix=str(tmp_path))
    ds, jds, loader, jloader = _both(
        cfg, "resisc", "cls",
        dict(cls_size=224, device_preprocess=device_preprocess))
    assert ds.CLASSES == jds.CLASSES == classes
    assert ds.samples == jds.samples and len(ds) == 6
    assert loader.img_norm == jloader.img_norm
    same_batches(loader, jloader)
    batch = next(iter(loader))
    assert batch["img"].shape == (2, 224, 224, 3)
    assert batch["img"].dtype == (np.uint8 if device_preprocess
                                  else np.float32)
    scores = rng.random((6, 3)).astype(np.float32)
    assert ds.evaluate(scores, topk=(1, 2)) == jds.evaluate(scores,
                                                            topk=(1, 2))
    out, jout = str(tmp_path / "fmt"), str(tmp_path / "jfmt")
    import pickle
    for p, q in zip(ds.format_results(list(scores), out),
                    jds.format_results(list(scores), jout)):
        np.testing.assert_array_equal(pickle.load(open(p, "rb")),
                                      pickle.load(open(q, "rb")))


def _coco(tmp_path):
    rng = np.random.default_rng(1)
    names = ("airplane", "ship", "vehicle")
    cats = [{"id": 10 + i, "name": n} for i, n in enumerate(names)]
    images, anns = [], []
    for i, hw in enumerate(((120, 90), (90, 120), (60, 60))):
        fn = f"img_{i}.png"
        _png(str(tmp_path / "imgs" / fn),
             rng.integers(0, 256, hw + (3,)).astype(np.uint8))
        images.append({"id": 100 + i, "file_name": fn, "height": hw[0],
                       "width": hw[1]})
    boxes = [(0, [5, 6, 30, 20], 10, 0), (0, [40, 50, 20, 30], 12, 0),
             (1, [10, 10, 50, 40], 11, 0), (1, [0, 0, 20, 20], 12, 0),
             (1, [60, 30, 30, 30], 10, 1), (2, [5, 5, 10, 10], 11, 1)]
    for j, (img, box, cat, crowd) in enumerate(boxes):
        anns.append({"id": j, "image_id": 100 + img, "bbox": box,
                     "category_id": cat, "iscrowd": crowd})
    path = str(tmp_path / "ann.json")
    json.dump({"images": images, "annotations": anns, "categories": cats},
              open(path, "w"))
    return path, names


def test_coco_json_matches_jax(tmp_path):
    ann, names = _coco(tmp_path)
    cfg = dict(_base("det/dior.py")["data"]["val"], ann_file=ann,
               img_prefix=str(tmp_path / "imgs"), classes=names)
    ds, jds, loader, jloader = _both(
        cfg, "dior", "det", dict(det_bucket_hw=[(800, 800), (1088, 1088)],
                                 max_gt=4))
    assert len(ds) == len(jds) == 2        # the crowd-only image dropped
    for a, b in zip(ds.get_annotations(), jds.get_annotations()):
        same_sample(a, b)
    same_batches(loader, jloader)
    batch = next(iter(loader))
    # 120 x 90 and 90 x 120 keep-ratio resized to 1067 x 800 / 800 x 1067
    np.testing.assert_array_equal(batch["img_hw"], [[1067, 800],
                                                    [800, 1067]])
    assert batch["img"].shape == (2, 1088, 1088, 3)
    rng = np.random.default_rng(2)
    res = [[np.concatenate([rng.uniform(0, 40, (4, 2)),
                            rng.uniform(40, 90, (4, 2)),
                            rng.random((4, 1))], 1).astype(np.float32)
            for _ in names] for _ in range(2)]
    for kw in ({}, dict(classwise=True, iou_thrs=(0.5, 0.75))):
        assert ds.evaluate(res, **kw) == jds.evaluate(res, **kw)
    p = ds.format_results(res, str(tmp_path / "fmt"))
    q = jds.format_results(res, str(tmp_path / "jfmt"))
    got, want = json.load(open(p[0])), json.load(open(q[0]))
    assert got == want and {d["category_id"] for d in got} == {10, 11, 12}


def test_potsdam_tiles_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(3):
        _png(str(tmp_path / "img" / f"t_{i}.png"),
             rng.integers(0, 256, (300, 400, 3)).astype(np.uint8))
        _png(str(tmp_path / "ann" / f"t_{i}.png"),
             rng.integers(0, 7, (300, 400)).astype(np.uint8))
    cfg = dict(_base("seg/potsdam_IRRG_all.py")["data"]["val"],
               data_root=str(tmp_path), img_dir="img", ann_dir="ann")
    ds, jds, loader, jloader = _both(
        cfg, "potsdam", "seg", dict(seg_size=512, seg_pad_val=5))
    assert len(ds) == len(jds) == 3 and len(loader) == 2
    for i in range(3):
        same_sample(ds[i], jds[i])
        np.testing.assert_array_equal(ds.get_gt_seg_map(i),
                                      jds.get_gt_seg_map(i))
    same_batches(loader, jloader)
    batch = next(iter(loader))
    np.testing.assert_array_equal(batch["img_hw"], [[384, 512]] * 2)
    np.testing.assert_array_equal(batch["ori_hw"], [[300, 400]] * 2)
    assert (batch["gt_semantic_seg"][:, 384:] == 5).all()
    preds = [rng.integers(0, 100, (300, 400)) for _ in range(3)]
    kw = dict(metric=["mIoU", "mFscore"], classwise=True)
    assert ds.evaluate(preds, **kw) == jds.evaluate(preds, **kw)
    for i, p in enumerate(preds):
        for a, b in zip(ds.pre_eval(p, i), jds.pre_eval(p, i)):
            np.testing.assert_array_equal(a, b)
    labels = [rng.integers(0, 5, (300, 400)) for _ in range(3)]
    got = ds.format_results(labels, str(tmp_path / "fmt"))
    want = jds.format_results(labels, str(tmp_path / "jfmt"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == [f"t_{i}.png" for i in range(3)]
    for p, q in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                      np.asarray(Image.open(q)))
