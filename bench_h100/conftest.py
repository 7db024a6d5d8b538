"""The seg cell's stand-in among the tests' tiny cells (``tests/_tiny.py``),
registered before any test module is collected: a Mask2Former of the
cell's kind at a width the CPU holds (``tests/data/m2f_tiny.json``: Swin at
window 12, so the plain K2 path runs at n = 144, a 3-level pixel decoder,
3 masked-attention layers, 7 classes) on two 96^2 tiles of a 192 x 96
scene."""

from __future__ import annotations

import copy
import json

from bench_h100.tests import _tiny

SEG_CELL = "m2f_swin_l_seg_scene"
SEG_TINY = _tiny.DATA / "m2f_tiny.json"

_config = _tiny.config


def _seg_config(name, dtype=None):
    if name != SEG_CELL:
        return _config(name, dtype)
    cfg = copy.deepcopy(json.loads(SEG_TINY.read_text()))
    if dtype:
        cfg["model"]["compute_dtype"] = dtype
    return cfg


_tiny.SMALL.setdefault(SEG_CELL, ("own", {"batch": 2, "image_hw": [96, 96],
                                          "scene_hw": [192, 96]}))
_tiny.config = _seg_config
