"""Data builders of the port (counterpart of rscotr_tpu/data/build.py):
the two-level config composition, datasets, and per-dataset loaders.

* ``load_data_cfg``: each ``cfg["data"][name]`` entry may carry ``config:
  <path>``, a per-dataset config file that is loaded and inlined, its
  ``data`` with the entry's own ``data`` deep-merged over it.
* ``build_datasets(data_cfg, split)`` tags each dataset with ``task`` and
  ``dataset_name``.
* ``build_dataloaders`` applies the per-task loader options: a static det
  bucket (``det_bucket_hw``), ``max_gt`` GT padding, the seg size and pad
  value, and ``device_preprocess`` (Normalize dropped from the host
  pipeline, uint8 batches normalized on the card). ``num_replicas`` /
  ``rank`` are arguments (one process unless given). The training side
  (the iteration strategies, ``MultiDataLoader``, the device-augment
  collates) waits for ROADMAP M5 / M6.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from rscotr_tpu_torch.data import datasets  # noqa: F401 (registrations)
from rscotr_tpu_torch.data.loader import (TaskDataLoader, collate_cls,
                                          collate_det, collate_seg)
from rscotr_tpu_torch.data.pipelines import (build_pipeline,
                                             split_normalize_cfg)
from rscotr_tpu_torch.utils.config import deep_merge, load_cfg
from rscotr_tpu_torch.utils.registry import DATASETS

_DEVICE_AUG = ("cls_device_augment", "det_device_augment",
               "seg_device_augment")


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
        max_gt=opts.get("max_gt", 100))),
    "seg": lambda opts: (lambda samples: collate_seg(
        samples, size=opts.get("seg_size", 512),
        seg_pad_val=opts.get("seg_pad_val", 255))),
}


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
                      num_replicas: int = 1, rank: int = 0
                      ) -> Dict[str, TaskDataLoader]:
    """One ``TaskDataLoader`` per dataset. Training loaders shuffle, drop
    the last short batch and take this rank's share of a global batch of
    ``samples_per_gpu * world_size``; eval loaders (``train=False``) run
    every sample in order, ``test_samples_per_gpu`` at a time. Each loader
    carries ``img_norm``: the Normalize stats moved to the card by
    ``device_preprocess``, else None."""
    loaders = {}
    for name, ds in datasets.items():
        entry = data_cfg[name]
        opts = dict(entry.get("loader", {}))
        if train:
            wanted = [k for k in _DEVICE_AUG if opts.get(k)]
            if wanted:
                raise NotImplementedError(
                    f"loader options {wanted}: on-device augmentation is "
                    "not ported to rscotr_tpu_torch yet (ROADMAP M6)")
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
        if opts.get("device_preprocess", False):
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
