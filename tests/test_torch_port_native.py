"""The port's native host code (``rscotr_tpu_torch/csrc/host/``, built by
``ops/host_lib.py``) against its numpy / PIL paths and the JAX package's
native modules, on the CPU:

* ``class_ap_native`` and ``seg_confusion_native`` on the cases of
  tests/test_native.py and tests/test_coco_golden.py: through ``eval_map``
  (native against the port's numpy path and against JAX's native AP, atol
  1e-6, as tests/test_native.py holds them) and called directly (the same
  AP from both packages' cores), the confusion counts exactly equal;
* ``imdecode`` on PNG (RGB, gray) and JPEG bytes exactly equal to PIL's
  decode and to JAX's ``imdecode``; bytes it does not read give None;
* ``LoadImageFromFile`` over the kinds of folders of
  tests/test_torch_port_eval_data.py (RESISC PNGs of two sizes, COCO
  images, Potsdam tiles) and a JPEG, exactly equal to JAX's, natively and
  with ``RSCOTR_NO_NATIVE_IMDECODE=1`` (PIL);
* ``available()`` true here (g++, jpeglib.h and png.h are installed), and a
  build that fails reports the compiler's lines.
"""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from rscotr_tpu.data.native_image import imdecode as jax_imdecode
from rscotr_tpu.data.pipelines import build_pipeline as jax_build_pipeline
from rscotr_tpu.data.pipelines import run_pipeline as jax_run_pipeline
from rscotr_tpu.evaluation.coco_map import eval_map as jax_eval_map
from rscotr_tpu.evaluation.native import class_ap_native as jax_class_ap
from rscotr_tpu.evaluation.native import \
    seg_confusion_native as jax_seg_confusion
from rscotr_tpu_torch.data import native_image
from rscotr_tpu_torch.data.pipelines import build_pipeline, run_pipeline
from rscotr_tpu_torch.evaluation import eval_map, intersect_and_union, native
from rscotr_tpu_torch.ops import host_lib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_native import _random_case  # noqa: E402

AP_TOL = 1e-6


def _ann(bboxes, labels):
    return {"bboxes": np.asarray(bboxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64).reshape(-1)}


def _det(*rows):
    return np.asarray(rows, np.float32).reshape(-1, 5)


# tests/test_coco_golden.py's cases: (dets, anns, num_classes, kwargs, the
# hand-derived bbox_mAP)
GOLDEN = {
    "perfect": ([[_det([0, 0, 10, 10, 0.9])]],
                [_ann([[0, 0, 10, 10]], [0])], 1, {}, 1.0),
    "greedy": ([[_det([0, 0, 10, 6, 0.9], [0, 0, 10, 10, 0.8],
                      [20, 0, 30, 10, 0.7])]],
               [_ann([[0, 0, 10, 10], [20, 0, 30, 10]], [0, 0])], 1, {},
               (51 + 50 * 2 / 3) / 101),
    "tie": ([[_det([50, 50, 60, 60, 0.5], [0, 0, 10, 10, 0.5])]],
            [_ann([[0, 0, 10, 10]], [0])], 1, {}, 0.5),
    "max_dets": ([[_det([50, 50, 60, 60, 0.9], [70, 70, 80, 80, 0.8],
                        [0, 0, 10, 10, 0.7])]],
                 [_ann([[0, 0, 10, 10]], [0])], 1, dict(max_dets=2), 0.0),
    "empty_class": ([[_det([0, 0, 10, 10, 0.9]),
                      _det([50, 50, 60, 60, 0.3])]],
                    [_ann([[0, 0, 10, 10]], [0])], 2, {}, 1.0),
    "no_dets": ([[_det([0, 0, 10, 10, 0.9]), np.zeros((0, 5))]],
                [_ann([[0, 0, 10, 10], [20, 20, 30, 30]], [0, 1])], 2, {},
                0.5),
    "two_thresholds": ([[_det([0, 0, 10, 6, 0.9])]],
                       [_ann([[0, 0, 10, 10]], [0])], 1,
                       dict(iou_thrs=(0.5, 0.75)), 0.5),
    "cross_image": ([[_det([50, 50, 60, 60, 0.9])],
                     [_det([0, 0, 10, 10, 0.8])]],
                    [_ann(np.zeros((0, 4)), np.zeros((0,))),
                     _ann([[0, 0, 10, 10]], [0])], 1, {}, 0.5),
}


def _close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])


def test_available_here():
    for lib in (native, native_image):
        st = lib.available()
        assert st and st.ok and st.reason == "", st.reason
        assert st.build.path.parent == host_lib.BUILD_DIR
        assert st.build.path.suffix == ".so"


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_ap(name):
    """The native AP of each golden case is the hand value, as the port's
    numpy path's and JAX's native one."""
    dets, anns, n, kw, want = GOLDEN[name]
    got = eval_map(dets, anns, n, use_native=True, **kw)
    assert got["bbox_mAP"] == pytest.approx(want, abs=1e-4)
    _close(got, eval_map(dets, anns, n, use_native=False, **kw))
    _close(got, jax_eval_map(dets, anns, n, use_native=True, **kw))


@pytest.mark.parametrize("seed", range(4))
def test_random_cases_ap(seed):
    """tests/test_native.py's random cases: the native eval_map against the
    port's numpy one and JAX's native one; each class's AP from the two
    cores called directly."""
    dets, anns = _random_case(seed)
    kw = dict(iou_thrs=[0.5, 0.75], class_names=["a", "b", "c"])
    got = eval_map(dets, anns, 3, use_native=True, **kw)
    _close(got, eval_map(dets, anns, 3, use_native=False, **kw))
    _close(got, jax_eval_map(dets, anns, 3, use_native=True, **kw))
    for c in range(3):
        boxes = np.concatenate([d[c][:, :4] for d in dets])
        scores = np.concatenate([d[c][:, 4] for d in dets])
        img = np.concatenate([np.full(len(d[c]), i)
                              for i, d in enumerate(dets)])
        gts = [a["bboxes"][a["labels"] == c] for a in anns]
        start = np.concatenate([[0], np.cumsum([len(g) for g in gts])])
        for thr in (0.5, 0.75):
            args = (boxes, scores, img, np.concatenate(gts), start,
                    len(dets), thr)
            a, b = native.class_ap_native(*args), jax_class_ap(*args)
            assert a == b or (np.isnan(a) and np.isnan(b))


def test_class_ap_native_checks_sizes():
    with pytest.raises(ValueError, match="inconsistent"):
        native.class_ap_native(np.zeros((2, 4)), np.zeros(1), np.zeros(1),
                               np.zeros((1, 4)), np.array([0, 1]), 1, 0.5)


@pytest.mark.parametrize("shape,num_classes,ignore",
                         [((64, 64), 5, 5), ((37, 53), 6, 255),
                          ((1, 1000), 3, 0)])
def test_seg_confusion(shape, num_classes, ignore):
    """Exactly the port's ``intersect_and_union`` and JAX's native counts
    (predictions past the class range, labels at the ignore index)."""
    rng = np.random.default_rng(sum(shape))
    pred = rng.integers(0, num_classes + 2, shape).astype(np.int32)
    label = rng.integers(0, num_classes + 1, shape).astype(np.int32)
    label[rng.random(shape) < 0.1] = ignore
    got = native.seg_confusion_native(pred, label, num_classes, ignore)
    want = intersect_and_union(pred, label, num_classes,
                               ignore_index=ignore)
    jwant = jax_seg_confusion(pred, label, num_classes, ignore)
    for a, b, c in zip(got, want, jwant):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)


def _encoded(arr, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["png_rgb", "png_gray", "jpeg", "jpeg_gray"])
def test_imdecode(kind):
    rng = np.random.default_rng(len(kind))
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    src = img[:, :, 0] if kind.endswith("gray") else img
    data = _encoded(src, "PNG" if kind.startswith("png") else "JPEG",
                    **({} if kind.startswith("png") else dict(quality=90)))
    got = native_image.imdecode(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jax_imdecode(data))
    if kind == "png_rgb":
        np.testing.assert_array_equal(got, img)


def test_imdecode_refuses_what_it_does_not_read(monkeypatch):
    assert native_image.imdecode(b"definitely not an image") is None
    assert native_image.imdecode(b"") is None
    bmp = _encoded(np.zeros((4, 4, 3), np.uint8), "BMP")
    assert native_image.imdecode(bmp) is None
    png = _encoded(np.zeros((4, 4, 3), np.uint8), "PNG")
    monkeypatch.setenv("RSCOTR_NO_NATIVE_IMDECODE", "1")
    assert native_image.imdecode(png) is None


def _folders(root):
    """The kinds of image folders of tests/test_torch_port_eval_data.py,
    and a JPEG and a BMP (which only PIL reads)."""
    rng = np.random.default_rng(0)
    paths = []

    def save(rel, arr, **kw):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, **kw)
        paths.append(path)

    for c in ("beach", "forest"):
        for i, hw in enumerate(((40, 50), (64, 48))):
            save(f"resisc/{c}/{c}_{i}.png",
                 rng.integers(0, 256, hw + (3,)).astype(np.uint8))
    for i, hw in enumerate(((120, 90), (90, 120), (60, 60))):
        save(f"coco/imgs/img_{i}.png",
             rng.integers(0, 256, hw + (3,)).astype(np.uint8))
    for i in range(2):
        save(f"potsdam/img/t_{i}.png",
             rng.integers(0, 256, (300, 400, 3)).astype(np.uint8))
    save("misc/a.jpg", rng.integers(0, 256, (70, 30, 3)).astype(np.uint8),
         quality=85)
    save("misc/b.bmp", rng.integers(0, 256, (20, 30, 3)).astype(np.uint8))
    return paths


@pytest.mark.parametrize("native_on", [True, False])
def test_load_image_from_file_matches_jax(tmp_path, monkeypatch, native_on):
    if not native_on:
        monkeypatch.setenv("RSCOTR_NO_NATIVE_IMDECODE", "1")
    pipe = build_pipeline([dict(type="LoadImageFromFile")])
    jpipe = jax_build_pipeline([dict(type="LoadImageFromFile")])
    for path in _folders(str(tmp_path)):
        got = run_pipeline(pipe, {"img_path": path},
                           np.random.default_rng(0))
        want = jax_run_pipeline(jpipe, {"img_path": path},
                                np.random.default_rng(0))
        assert got["img"].dtype == np.float32
        np.testing.assert_array_equal(got["img"], want["img"])
        assert got["ori_shape"] == want["ori_shape"] == got["img"].shape
        assert got["img_shape"] == want["img_shape"]


def test_failed_builds_say_why(tmp_path, monkeypatch):
    """A source that does not compile, a library that does not link and a
    missing compiler each leave the library unavailable, the reason the
    compiler's last lines (or the missing compiler), and the callers on
    their fallback."""
    (tmp_path / "broken.cpp").write_text("#include <no_such_header.h>\n")
    (tmp_path / "fine.cpp").write_text('extern "C" int f() { return 1; }\n')
    monkeypatch.setattr(host_lib, "HOST_CSRC", tmp_path)
    monkeypatch.setattr(host_lib, "BUILD_DIR", tmp_path / "build")
    cases = [("broken.cpp", (), "no_such_header.h"),
             ("fine.cpp", ("-lno_such_library",), "no_such_library")]
    for source, libs, why in cases:
        lib = host_lib.HostLibrary(source, libs, lambda lib: None)
        st = lib.status()
        assert not st and why in st.reason and lib.load() is None
        assert not list((tmp_path / "build").glob("*.tmp"))
    with monkeypatch.context() as m:
        m.setattr(host_lib.shutil, "which", lambda name: None)
        st = host_lib.HostLibrary("fine.cpp", (), lambda lib: None).status()
        assert not st and st.reason == "g++ not found on PATH"
    ok = host_lib.HostLibrary("fine.cpp", (), lambda lib: None)
    assert ok.status() and ok.status().build.compiled
    again = host_lib.HostLibrary("fine.cpp", (), lambda lib: None).status()
    assert again.build.path == ok.status().build.path
    assert not again.build.compiled
    assert again.build.path.name.startswith("libfine_")
