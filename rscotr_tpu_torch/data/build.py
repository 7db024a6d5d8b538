"""Data builders of the port (counterpart of rscotr_tpu/data/build.py):
the two-level config composition, datasets, per-dataset loaders, and the
multi-task loader of co-training.

* ``load_data_cfg``: each ``cfg["data"][name]`` entry may carry ``config:
  <path>``, a per-dataset config file that is loaded and inlined, its
  ``data`` with the entry's own ``data`` deep-merged over it.
* ``build_datasets(data_cfg, split)`` tags each dataset with ``task`` and
  ``dataset_name``.
* ``build_dataloaders`` applies the per-task loader options: a static det
  bucket (``det_bucket_hw``), ``max_gt`` GT padding, the seg size and pad
  value, and ``device_preprocess`` (Normalize dropped from the host
  pipeline, uint8 batches normalized on the card), and on the training
  side the det collate's DN-width ladder (``det_dn_ladder``) and on-device
  augmentation (``cls_device_augment``, ``det_device_augment``,
  ``seg_device_augment``: the pipeline's augment tail becomes its planner,
  the collate its aug collate, and Normalize moves to the card).
  ``num_replicas`` / ``rank`` are arguments (one process unless given).
* ``build_iteration_strategy`` (default round_robin) logs a 300-draw
  histogram, as the reference does; ``derive_dn_ladder``;
  ``build_multidataloader`` assembles the ``MultiDataLoader``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from rscotr_tpu_torch.data import datasets  # noqa: F401 (registrations)
from rscotr_tpu_torch.data.iteration_strategies import strategies_map
from rscotr_tpu_torch.data.loader import (MultiDataLoader, TaskDataLoader,
                                          collate_cls, collate_cls_aug,
                                          collate_det, collate_det_aug,
                                          collate_seg, collate_seg_aug)
from rscotr_tpu_torch.data.pipelines import (build_pipeline,
                                             split_det_device_augment_cfg,
                                             split_device_augment_cfg,
                                             split_normalize_cfg,
                                             split_seg_device_augment_cfg)
from rscotr_tpu_torch.utils.config import deep_merge, load_cfg
from rscotr_tpu_torch.utils.logging import get_root_logger
from rscotr_tpu_torch.utils.registry import DATASETS

def load_data_cfg(cfg: dict, config_root: Optional[str] = None,
                  filename: Optional[str] = None) -> dict:
    """Inline each dataset's config file under ``cfg["data"][name]`` (in
    place; returns ``cfg``). A relative path is tried against the config
    file's grandparent (``filename``: the file ``cfg`` came from), then
    ``config_root`` (default: the working directory), then as given."""
    root = config_root or os.getcwd()
    for entry in cfg["data"].values():
        if "config" not in entry:
            continue
        path = entry["config"]
        if not os.path.isabs(path):
            cands = [os.path.join(root, path), path]
            if filename:
                cands.insert(0, os.path.join(
                    os.path.dirname(os.path.abspath(filename)), "..", "..",
                    path))
            path = next((c for c in cands if os.path.isfile(c)), path)
        sub = load_cfg(path)
        entry["data"] = deep_merge({"data": sub.get("data", {})},
                                   {"data": dict(entry.get("data", {}))}
                                   )["data"]
        if "evaluation" in sub and "evaluation" not in entry:
            entry["evaluation"] = sub["evaluation"]
    return cfg


def build_dataset(ds_cfg: dict):
    ds_cfg = dict(ds_cfg)
    pipeline_cfg = ds_cfg.pop("pipeline", None)
    ds = DATASETS.build(ds_cfg)
    ds.pipeline_cfg = pipeline_cfg
    return ds


def build_datasets(data_cfg: dict, split: str = "train") -> Dict[str, object]:
    """{name: dataset} of ``data_cfg`` (``cfg["data"]``) for the entries
    that have ``split``."""
    out = {}
    for name, entry in data_cfg.items():
        dcfg = entry["data"].get(split)
        if dcfg is None:
            continue
        ds = build_dataset(dcfg)
        ds.task = entry["task"]
        ds.dataset_name = name
        out[name] = ds
    return out


_COLLATES = {
    "cls": lambda opts: collate_cls,
    "det": lambda opts: (lambda samples: collate_det(
        samples, bucket_hw=opts.get("det_bucket_hw", (800, 800)),
        max_gt=opts.get("max_gt", 100), dn_ladder=opts.get("_dn_ladder"))),
    "seg": lambda opts: (lambda samples: collate_seg(
        samples, size=opts.get("seg_size", 512),
        seg_pad_val=opts.get("seg_pad_val", 255))),
}


def det_src_hw(opts: dict):
    """The static source bucket of det device augmentation:
    ``loader.det_src_hw``, else the largest of ``det_bucket_hw``."""
    src_hw = opts.get("det_src_hw")
    if src_hw is None:
        bh = opts.get("det_bucket_hw", (800, 800))
        src_hw = max(bh, key=lambda b: b[0] * b[1]) if \
            isinstance(bh[0], (tuple, list)) else bh
    return tuple(src_hw)


def seg_src_size(opts: dict) -> int:
    return opts.get("seg_src_size", opts.get("seg_size", 512))


def _device_augment(task: str, opts: dict, pcfg):
    """(pipeline config, collate, img_norm) of a training loader whose
    task asks for on-device augmentation, else None."""
    if task == "cls" and opts.get("cls_device_augment"):
        pcfg, norm, _ = split_device_augment_cfg(
            pcfg, src_size=opts.get("cls_src_size", 256))
        return pcfg, collate_cls_aug, norm
    if task == "det" and opts.get("det_device_augment"):
        pcfg, norm, _ = split_det_device_augment_cfg(
            pcfg, src_hw=det_src_hw(opts))
        return pcfg, (lambda samples: collate_det_aug(
            samples, bucket_hw=opts.get("det_bucket_hw", (800, 800)),
            max_gt=opts.get("max_gt", 100),
            dn_ladder=opts.get("_dn_ladder"))), norm
    if task == "seg" and opts.get("seg_device_augment"):
        pcfg, norm, _ = split_seg_device_augment_cfg(
            pcfg, src_size=seg_src_size(opts))
        return pcfg, collate_seg_aug, norm
    return None


def _uint8_collate(fn):
    def wrapped(samples):
        batch = fn(samples)
        batch["img"] = np.clip(np.round(batch["img"]), 0,
                               255).astype(np.uint8)
        return batch
    return wrapped


def build_dataloaders(datasets: Dict[str, object], data_cfg: dict,
                      train: bool = True, seed: int = 0,
                      num_threads: int = 4, world_size: int = 1,
                      num_replicas: int = 1, rank: int = 0,
                      det_dn_ladder=None) -> Dict[str, TaskDataLoader]:
    """One ``TaskDataLoader`` per dataset. Training loaders shuffle, drop
    the last short batch and take this rank's share of a global batch of
    ``samples_per_gpu * world_size``; a training det loader given
    ``det_dn_ladder`` adds the zero-width ``dn_wide`` entry to its batches.
    Eval loaders (``train=False``) run every sample in order,
    ``test_samples_per_gpu`` at a time. A training loader whose task asks
    for on-device augmentation runs its planner and aug collate (raw uint8
    images and ``aug_*`` records). Each loader carries ``img_norm``: the
    Normalize stats moved to the card by device augmentation or
    ``device_preprocess``, else None."""
    loaders = {}
    for name, ds in datasets.items():
        entry = data_cfg[name]
        opts = dict(entry.get("loader", {}))
        if train and ds.task == "det" and det_dn_ladder:
            opts["_dn_ladder"] = tuple(det_dn_ladder)
        if train:
            bs = entry["data"].get("samples_per_gpu", 1) * max(1, world_size)
            if bs % num_replicas:
                raise ValueError(f"global batch {bs} not divisible by "
                                 f"{num_replicas} processes ({name})")
            bs //= num_replicas
        else:
            bs = entry["data"].get("test_samples_per_gpu", 1)
        pcfg = list(ds.pipeline_cfg or [])
        collate = _COLLATES[ds.task](opts)
        img_norm = None
        aug = _device_augment(ds.task, opts, pcfg) if train else None
        if aug is not None:
            pcfg, collate, img_norm = aug
        elif opts.get("device_preprocess", False):
            pcfg, img_norm = split_normalize_cfg(pcfg)
            collate = _uint8_collate(collate)
        loaders[name] = TaskDataLoader(
            ds, batch_size=bs, pipeline=build_pipeline(pcfg),
            collate_fn=collate, shuffle=train, seed=seed, drop_last=train,
            num_threads=num_threads,
            num_replicas=num_replicas if train else 1,
            rank=rank if train else 0)
        loaders[name].img_norm = img_norm
    return loaders


def build_iteration_strategy(cfg: dict, loaders, seed: int = 0):
    """The strategy ``cfg["iteration_strategy"]`` names (round_robin when
    it names none), seeded ``seed``; logs the empirical ratios of 300
    draws of a twin, as the reference does."""
    icfg = dict(cfg.get("iteration_strategy") or {"type": "round_robin"})
    t = icfg.pop("type", "round_robin")
    strategy = strategies_map[t](loaders, seed=seed, **icfg)
    probe = strategies_map[t](loaders, seed=seed, **icfg)
    hist = np.bincount([probe() for _ in range(300)],
                       minlength=len(loaders))
    get_root_logger().info(
        "iteration strategy '%s' empirical ratios over 300 draws: %s",
        t, dict(zip(loaders.keys(), (hist / 300).round(3).tolist())))
    return strategy


def derive_dn_ladder(cfg: dict):
    """The DN group-width ladder of the det collate, or None (no det head
    with ``dn_cfg``, or a det loader with ``dn_widen=False``).

    The widths are ``dn_max_gt = min(group_cfg.dn_max_gt (20), max_gt)``,
    ``max_gt``, and ``num_dn // g`` for every group count g that the
    reference's ``num_groups = num_dn // n`` takes for a GT count n in
    (dn_max_gt, max_gt]. A batch takes the smallest width >= its largest GT
    count, so above ``dn_max_gt`` the group count is the reference's
    (``N // (N // (N // n)) == N // n``). At or below ``dn_max_gt`` every
    batch takes width ``dn_max_gt`` and ``num_dn // dn_max_gt`` groups,
    where the reference would build ``num_dn // n`` (ROADMAP C1). Flagship
    (N = 100, max_gt 100): (20, 25, 33, 50, 100)."""
    bh = (cfg.get("model") or {}).get("bbox_head") or {}
    if not bh or not bh.get("dn_cfg"):
        return None
    gc = (bh.get("dn_cfg") or {}).get("group_cfg") or {}
    max_gt = 100
    for entry in cfg["data"].values():
        if entry["task"] == "det":
            opts = dict(entry.get("loader", {}))
            max_gt = opts.get("max_gt", 100)
            if not opts.get("dn_widen", True):
                return None
    dn_max_gt = min(gc.get("dn_max_gt", 20), max_gt)
    num_dn = gc.get("num_dn_queries", 100) or 100
    rungs = {dn_max_gt, max_gt}
    if dn_max_gt < max_gt:
        for g in range(1, max(num_dn // (dn_max_gt + 1), 1) + 1):
            r = num_dn // g
            if dn_max_gt < r <= max_gt:
                rungs.add(r)
    return tuple(sorted(rungs))


def build_multidataloader(cfg: dict, datasets: Dict[str, object],
                          seed: int = 0, world_size: int = 1
                          ) -> MultiDataLoader:
    """The training loaders of ``datasets`` (with the DN ladder) under the
    config's iteration strategy, both seeded ``seed``."""
    loaders = build_dataloaders(datasets, cfg["data"], train=True, seed=seed,
                                world_size=world_size,
                                det_dn_ladder=derive_dn_ladder(cfg))
    return MultiDataLoader(loaders,
                           build_iteration_strategy(cfg, loaders, seed=seed))
