"""Cells at a size a CPU test can hold: each cell's driver, check, limits
and traffic kind, on small tiles, in float32 unless asked otherwise. The
Swin cells run the tiny MTL (``data/mtl_tiny.json``, the repository's
tiny synthetic config frozen here); the ResNet cell its own configuration
(256^2 tiles: the two-stage head needs 600 proposals)."""

from __future__ import annotations

import copy
import json
from pathlib import Path
from types import SimpleNamespace

from bench_h100 import harness

DATA = Path(__file__).resolve().parent / "data"

SMALL = {
    "mtl_det_scene": ("tiny", {"batch": 2, "image_hw": [128, 128],
                               "scene_hw": [256, 128], "max_per_img": 50}),
    "mtl_cls_archive": ("tiny", {"batch": 4, "image_hw": [64, 64]}),
    "dino_4scale_r50_det_scene": ("own", {"batch": 2, "image_hw": [256, 256],
                                          "scene_hw": [512, 256],
                                          "max_per_img": 50}),
}
CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


def config(name, dtype=None):
    real = harness.load_cell(harness.load_bench(), name)
    if SMALL[name][0] == "tiny":
        cfg = json.loads((DATA / "mtl_tiny.json").read_text())
    else:
        cfg = copy.deepcopy(real.config)
    if dtype:
        cfg["model"]["compute_dtype"] = dtype
    else:
        cfg["model"].pop("compute_dtype", None)
    return cfg


def cell(name, dtype=None):
    real = harness.load_cell(harness.load_bench(), name)
    tr = dict(real.traffic, pool=3, warmup=1, trace_requests=2,
              check={"requests": 2, "among_first": 3}, **SMALL[name][1])
    return SimpleNamespace(name=name, entry=real.entry,
                           workload=copy.deepcopy(real.workload),
                           config=config(name, dtype), traffic=tr)
