"""The port's parity and featmap tools against the root tools, on the CPU,
with real converted weights, as tests/test_parity_runbook.py rehearses the
JAX package's runbook:

* JAX's tiny init (seed 3) is saved through orbax and converted with
  ``tools/convert_checkpoint.py --to-torch`` (the stand-in for the
  published ``.pth``);
* the root ``parity_check.py dump`` of the orbax checkpoint and the port's
  ``dump`` of the ``.pth`` (``--device cpu``) hold the same keys, shapes
  and dtypes, and agree at the tolerances of
  tests/test_torch_port_slice.py: cls 1e-5; det labels equal, scores 1e-5
  and boxes 1e-3 px (JAX's gap at the top-k cut asserted above 10x the
  score tolerance, read from a JAX run at k + 1); seg labels wherever
  JAX's top-two logits lie more than 10x SEG_TOL apart
  (tests/helpers/eval_parity.py);
* the port's ``compare`` and ``metrics`` print the root tool's lines and
  return its exit codes on the same files, the perturbed-dump failure
  included; the port's ``dump`` refuses the orbax directory with the
  command that converts it;
* the port's backbone features from the converted weights are within
  SEG_TOL of JAX's ``backbone.apply`` (the root featmap tools'
  ``load_backbone``), and its folder, single-image, test-split and
  per-level featmap CLIs write the root CLIs' file names.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.eval_parity import (CLS_TOL, SEG_TOL, check_det,  # noqa: E402
                                 check_seg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
DEPTHS = ["--depths", "1", "1", "2", "1"]
# the dumps' input seed: JAX's gap at the det top-k cut is 9.0e-4 for seed
# 3; seed 0's 3.7e-5 is below 10x the score tolerance, so which detection
# a package keeps there would not be decided
SEED = "3"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch keeps to 2 threads, so that the test workers beside this one
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(orbax checkpoint of JAX's tiny init, seed 3; its --to-torch .pth)."""
    from rscotr_tpu.apis import init_model_params
    from rscotr_tpu.config import Config
    from rscotr_tpu.data import load_data_cfg
    from rscotr_tpu.engine import save_checkpoint
    from rscotr_tpu.models import build_model

    wd = tmp_path_factory.mktemp("tools_parity")
    cfg = load_data_cfg(Config.fromfile(CFG), config_root=ROOT)
    model = build_model(cfg.model)
    params = init_model_params(model, cfg, seed=3)
    native = save_checkpoint(str(wd), step=0, params=params, name="native")
    pth = str(wd / "standin.pth")
    convert = _load("tools/convert_checkpoint.py", "convert_tools_parity")
    convert.main([CFG, native, pth, "--to-torch"] + DEPTHS)
    return native, pth


@pytest.fixture(scope="module")
def dumps(weights, tmp_path_factory):
    native, pth = weights
    root = _load("tools/parity_check.py", "root_parity_check")
    from rscotr_tpu_torch.tools import parity_check
    wd = tmp_path_factory.mktemp("dumps")
    a, b = str(wd / "jax.npz"), str(wd / "port.npz")
    assert root.main(["dump", CFG, native, "--out", a, "--seed", SEED]) == 0
    assert parity_check.main(["dump", CFG, pth, "--out", b, "--seed", SEED,
                              "--device", "cpu"]) == 0
    return root, parity_check, a, b


def _jax_det_more(native, k):
    """JAX's det outputs on the dump's det input at max_per_img k + 1."""
    from rscotr_tpu.apis import (derive_img_norm, derive_shapes,
                                 init_model_params)
    from rscotr_tpu.config import Config
    from rscotr_tpu.data import load_data_cfg
    from rscotr_tpu.engine import load_checkpoint, make_infer_steps
    from rscotr_tpu.models import build_model

    cfg = load_data_cfg(Config.fromfile(CFG), config_root=ROOT)
    model = build_model(cfg.model)
    params = load_checkpoint(native, target={
        "params": init_model_params(model, cfg)})["params"]
    infer = make_infer_steps(model, max_per_img=k + 1,
                             img_norm=derive_img_norm(cfg))
    shapes = derive_shapes(cfg)
    rng = np.random.default_rng(int(SEED))
    rng.normal(size=(1,) + shapes["cls"][1:])       # the dump's cls draw
    s = shapes["det"]
    x = rng.normal(size=(1,) + s[1:]).astype(np.float32)
    det, labels = infer["det"](params, jnp.asarray(x),
                               jnp.asarray([[s[1], s[2]]], jnp.int32),
                               jnp.ones((1, 4), jnp.float32))
    return np.asarray(det), np.asarray(labels)


def _per_class(boxes, labels, num_classes):
    return [boxes[labels == c] for c in range(num_classes)]


def test_dumps_match_key_for_key(weights, dumps):
    native, _ = weights
    _, _, a, b = dumps
    want, got = np.load(a), np.load(b)
    assert sorted(got.files) == sorted(want.files) == \
        ["cls", "det_boxes", "det_labels", "seg"]
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    np.testing.assert_allclose(got["cls"], want["cls"], rtol=0,
                               atol=CLS_TOL)

    k = want["det_boxes"].shape[1]
    more, more_labels = _jax_det_more(native, k)
    np.testing.assert_array_equal(more_labels[:, :k], want["det_labels"])
    gap = more[0, k - 1, 4] - more[0, k, 4]
    assert gap > 10 * 1e-5, gap
    nc = int(max(want["det_labels"].max(), more_labels.max())) + 1
    unclear = check_det(
        [_per_class(got["det_boxes"][0], got["det_labels"][0], nc)],
        [_per_class(more[0], more_labels[0], nc)])
    assert not unclear
    np.testing.assert_array_equal(got["det_labels"], want["det_labels"])

    masks = check_seg([got["seg"][0].argmax(-1)], [want["seg"][0].argmax(-1)],
                      [want["seg"][0]])
    assert masks[0].mean() > 0.99


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def test_compare_and_metrics_match_root(dumps, tmp_path):
    root, port, a, b = dumps
    data = dict(np.load(b))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **dict(data, cls=data["cls"] + 0.1))
    fewer = str(tmp_path / "fewer.npz")
    np.savez(fewer, **{k: v for k, v in data.items() if k != "seg"})
    cases = [["compare", a, b, "--tol", "1e-3"],
             ["compare", b, b, "--tol", "0"],
             ["compare", b, bad, "--tol", "1e-3"],
             ["compare", b, fewer]]
    got = {"resisc.accuracy_top-1": 94.45, "dior.bbox_mAP_50": 0.901}
    m = str(tmp_path / "m.json")
    json.dump(got, open(m, "w"))
    for name, pub in (("ok", {"resisc.accuracy_top-1": 94.5}),
                      ("off", {"resisc.accuracy_top-1": 96.0}),
                      ("missing", {"potsdam.mIoU": 80.0})):
        p = str(tmp_path / f"pub_{name}.json")
        json.dump(pub, open(p, "w"))
        cases.append(["metrics", m, "--published", p, "--tol", "0.3"])
    rcs = []
    for argv in cases:
        want = _run(root.main, argv)
        assert _run(port.main, argv) == want, argv
        rcs.append(want[0])
    assert rcs == [0, 0, 1, 0, 0, 1, 1]


def test_dump_refuses_orbax(weights, tmp_path):
    native, _ = weights
    from rscotr_tpu_torch.tools import parity_check
    with pytest.raises(ValueError, match="--to-torch"):
        parity_check.main(["dump", CFG, native, "--out",
                           str(tmp_path / "x.npz"), "--device", "cpu"])


# -- featmap -----------------------------------------------------------------

def _root_featmap():
    sys.path.insert(0, os.path.join(ROOT, "tools", "featmap_vis"))
    try:
        return _load("tools/featmap_vis/_common.py", "root_featmap_common")
    finally:
        sys.path.pop(0)


def test_backbone_features_match_jax(weights):
    native, pth = weights
    root = _root_featmap()
    from rscotr_tpu_torch.tools.featmap_vis import _common
    img = np.random.default_rng(5).integers(0, 256, (80, 96, 3)).astype(
        np.uint8)
    backbone, variables = root.load_backbone(CFG, native)
    port = _common.load_backbone(CFG, pth, device="cpu")
    for size in (64, 96):
        x = _common.preprocess(img, size)
        np.testing.assert_array_equal(x, root.preprocess(img, size))
        want = root.run_backbone(backbone, variables, x)
        got = _common.run_backbone(port, x)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=SEG_TOL)


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(6)
    for sub, name in (("a", "x1.png"), ("b", "x2.jpg")):
        os.makedirs(d / sub, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (40, 50, 3)).astype(
            np.uint8)).save(d / sub / name)
    return d


def _names(d):
    return sorted(os.listdir(d))


def test_featmap_clis_write_root_names(weights, img_dir, tmp_path):
    native, pth = weights
    root = _root_featmap()
    from rscotr_tpu_torch.tools.featmap_vis import (dior_vis_featmap,
                                                    seg_vis_featmap_single_img,
                                                    vis_featmap_test)
    small = ["--topk", "4", "--size", "64"]
    one = str(img_dir / "a" / "x1.png")
    runs = [
        (lambda o: root.folder_main("det", [CFG, str(img_dir), "--checkpoint",
                                            native, "--out-dir", o] + small),
         lambda o: dior_vis_featmap.main([CFG, str(img_dir), "--checkpoint",
                                          pth, "--out-dir", o, "--device",
                                          "cpu"] + small)),
        (lambda o: root.single_img_main("seg", [CFG, one, "--out-dir", o,
                                                "--levels", "0", "2"]
                                        + small),
         lambda o: seg_vis_featmap_single_img.main(
             [CFG, one, "--out-dir", o, "--levels", "0", "2", "--device",
              "cpu"] + small)),
        (lambda o: root.test_split_main("cls", [CFG, "--out-dir", o,
                                                "--num", "2"] + small),
         lambda o: vis_featmap_test.main([CFG, "--out-dir", o, "--num", "2",
                                          "--device", "cpu"] + small)),
    ]
    for i, (want_fn, got_fn) in enumerate(runs):
        w, g = str(tmp_path / f"root{i}"), str(tmp_path / f"port{i}")
        want_fn(w)
        written = got_fn(g)
        assert _names(g) == _names(w) and _names(g), i
        assert sorted(os.path.basename(p) for p in written) == _names(g)


def test_vis_featmap_writes_root_names(img_dir, tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "tools", "featmap_vis"))
    try:
        root = _load("tools/featmap_vis/vis_featmap.py", "root_vis_featmap2")
    finally:
        sys.path.pop(0)
    from rscotr_tpu_torch.tools.featmap_vis import vis_featmap
    one = str(img_dir / "b" / "x2.jpg")
    flags = ["--level", "1", "--topk", "3", "--size", "64"]
    monkeypatch.setattr(sys, "argv", ["vis_featmap", CFG, one, "--out-dir",
                                      str(tmp_path / "root")] + flags)
    root.main()
    got = vis_featmap.main([CFG, one, "--out-dir", str(tmp_path / "port"),
                            "--device", "cpu"] + flags)
    assert _names(tmp_path / "port") == _names(tmp_path / "root") == \
        [f"featmap_l1_top{i}.png" for i in range(3)]
    assert len(got) == 3
