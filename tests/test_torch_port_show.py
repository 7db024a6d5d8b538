"""Painted results: the port's ``utils/visualize.py``, ``tools/test.py
--show-dir`` and ``tools/inference_one_img.py`` against the JAX package's,
on the CPU.

* every function of ``visualize`` writes the same pixels as JAX's on the
  same inputs (boxes above and below the threshold, labels past the class
  list, palettes past the six Potsdam colours, images from ``img`` and from
  ``img_path``);
* the port's ``tools/test.py --show-dir`` paints what JAX's painter makes
  of the same raw results (its ``--out`` pickle) over JAX's datasets: the
  same file names, count, image sizes and pixels;
* ``inference_one_img`` on a JAX checkpoint's weights (``state_dict_from_
  jax`` into a ``.pth``) prints the lines of JAX's tool on the orbax
  checkpoint and writes its two PNGs, of the same size; the det PNGs equal,
  the seg overlays equal where JAX's top-two seg logits lie more than 10x
  1e-4 apart.
"""

import contextlib
import importlib.util
import io
import os
import pickle

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from rscotr_tpu.config import Config
from rscotr_tpu.data import build_datasets as jax_build_datasets
from rscotr_tpu.data.datasets import PotsdamDataset as JaxPotsdam
from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
from rscotr_tpu.engine import save_checkpoint as jax_save_checkpoint
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu.utils import visualize as jvis
from rscotr_tpu_torch.data import build_datasets
from rscotr_tpu_torch.data.datasets import PotsdamDataset
from rscotr_tpu_torch.engine import save_checkpoint
from rscotr_tpu_torch.tools import inference_one_img
from rscotr_tpu_torch.tools import test as test_cli
from rscotr_tpu_torch.utils import visualize as vis
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
SEG_TOL = 1e-4


def _pixels(path):
    return np.asarray(Image.open(path))


def _same_png(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape
    np.testing.assert_array_equal(pa, pb)


def _image(seed, hw=(48, 64)):
    return np.random.default_rng(seed).uniform(0, 255, hw + (3,)).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 5, 6, 9, 20])
def test_seg_palette(n):
    assert vis.seg_palette(n) == jvis.seg_palette(n)
    assert len(vis.seg_palette(n)) == n


@pytest.mark.parametrize("score_thr", [0.0, 0.3, 0.95])
def test_draw_det_results(tmp_path, score_thr):
    img = _image(0)
    det = np.array([[2, 3, 30, 20, 0.9], [10, 10, 40, 45, 0.4],
                    [0, 0, 63, 47, 0.2], [5.5, 7.25, 12.5, 30, 0.31]],
                   np.float32)
    labels = np.array([0, 1, 7, 2])           # 7: past the class list
    for classes in (["plane", "ship", "tank"], None):
        out, jout = tmp_path / "p.png", tmp_path / "j.png"
        vis.draw_det_results(img, det, labels, classes, score_thr, str(out))
        jvis.draw_det_results(img, det, labels, classes, score_thr,
                              str(jout))
        _same_png(out, jout)


@pytest.mark.parametrize("alpha,palette", [(0.5, None), (0.3, "given"),
                                           (1.0, None)])
def test_draw_seg_results(tmp_path, alpha, palette):
    img = _image(1, (40, 50))
    seg = np.random.default_rng(2).integers(0, 9, (32, 50))
    pal = jvis.seg_palette(9) if palette else None
    vis.draw_seg_results(img, seg, str(tmp_path / "p.png"), alpha=alpha,
                         palette=pal)
    jvis.draw_seg_results(img, seg, str(tmp_path / "j.png"), alpha=alpha,
                          palette=pal)
    _same_png(tmp_path / "p.png", tmp_path / "j.png")


@pytest.mark.parametrize("name", ["forest", "a_much_longer_class_name"])
def test_draw_cls_result(tmp_path, name):
    img = _image(3, (64, 64))
    vis.draw_cls_result(img, name, 0.8765, str(tmp_path / "p.png"))
    jvis.draw_cls_result(img, name, 0.8765, str(tmp_path / "j.png"))
    _same_png(tmp_path / "p.png", tmp_path / "j.png")


def _potsdam_folder(root):
    rng = np.random.default_rng(4)
    for d in ("img", "ann"):
        os.makedirs(os.path.join(root, d))
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (30, 40, 3)).astype(
            np.uint8)).save(os.path.join(root, "img", f"t_{i}.png"))
        Image.fromarray(rng.integers(0, 7, (30, 40)).astype(np.uint8)).save(
            os.path.join(root, "ann", f"t_{i}.png"))
    return dict(data_root=root, img_dir="img", ann_dir="ann")


def test_raw_image(tmp_path):
    """From ``img`` (synthetic sets), from ``img_path`` (a Potsdam folder),
    None for a sample with neither."""
    cfg = load_cfg(TINY)
    ds = build_datasets(cfg["data"], split="val")
    jds = jax_build_datasets(Config.fromfile(TINY).data, split="val")
    for name in ds:
        np.testing.assert_array_equal(vis._raw_image(ds[name], 1),
                                      jvis._raw_image(jds[name], 1))
    kw = _potsdam_folder(str(tmp_path))
    got = vis._raw_image(PotsdamDataset(**kw), 1)
    assert got.dtype == np.float32 and got.shape == (30, 40, 3)
    np.testing.assert_array_equal(got, jvis._raw_image(JaxPotsdam(**kw), 1))
    assert vis._raw_image([{"gt_label": 0}], 0) is None


def _boxes(rng, n):
    """n (x1, y1, x2, y2, score) rows inside a 256^2 image."""
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(1, 50, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1))],
                          1).astype(np.float32)


def test_save_eval_visualizations(tmp_path):
    """Fake results over the tiny val sets (and a set with no dataset, and
    a per-dataset cap): the same files and pixels as JAX's painter."""
    cfg = load_cfg(TINY)
    ds = build_datasets(cfg["data"], split="val")
    jds = jax_build_datasets(Config.fromfile(TINY).data, split="val")
    rng = np.random.default_rng(5)
    res = {"resisc": [rng.dirichlet(np.ones(45)).astype(np.float32)
                      for _ in range(3)],
           "dior": [[_boxes(rng, n) for n in rng.integers(0, 3, 20)]
                    for _ in range(2)],
           "potsdam": [rng.integers(0, 5, (128, 128)).astype(np.int32)
                       for _ in range(2)],
           "elsewhere": [np.zeros(3)]}
    for cap in (0, 2):
        out, jout = tmp_path / f"p{cap}", tmp_path / f"j{cap}"
        n = vis.save_eval_visualizations(ds, res, str(out), score_thr=0.3,
                                         max_per_dataset=cap)
        jn = jvis.save_eval_visualizations(jds, res, str(jout),
                                           score_thr=0.3,
                                           max_per_dataset=cap)
        assert n == jn == (7 if cap == 0 else 6)
        _same_tree(out, jout)


def _same_tree(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    jnames = sorted(os.path.relpath(os.path.join(d, f), b)
                    for d, _, fs in os.walk(b) for f in fs)
    assert names == jnames and names
    for n in names:
        _same_png(os.path.join(a, n), os.path.join(b, n))


# ---------------------------------------------------------------------------
# the CLIs, on one JAX init carried into the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The tiny model's JAX init (key 0) as an orbax checkpoint and, through
    ``state_dict_from_jax``, as the port's ``.pth``."""
    jcfg = Config.fromfile(TINY)
    jm = jax_build_model(jcfg.model)
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    wd = tmp_path_factory.mktemp("ckpts")
    orbax = jax_save_checkpoint(str(wd), step=0, params=params,
                                name="native")
    from rscotr_tpu_torch.models import build_model
    model = build_model(load_cfg(TINY)["model"], device="cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(lambda x: np.asarray(x).copy(), params["params"])),
        strict=True)
    pth = save_checkpoint(str(wd / "port"), 0, model)
    return dict(jm=jm, params=params, orbax=orbax, pth=pth)


def test_show_dir_paints_what_jax_paints(checkpoints, tmp_path):
    show, raw = tmp_path / "painted", tmp_path / "raw.pkl"
    test_cli.main([TINY, checkpoints["pth"], "--device", "cpu",
                   "--max-batches", "1", "--show-dir", str(show), "--out",
                   str(raw), "--eval-out", str(tmp_path / "m.json")])
    results = pickle.load(open(raw, "rb"))
    jds = jax_build_datasets(Config.fromfile(TINY).data, split="val")
    n = jvis.save_eval_visualizations(jds, results, str(tmp_path / "jax"),
                                      score_thr=0.3)
    assert n == sum(len(r) for r in results.values()) > 0
    assert {d: len(os.listdir(show / d)) for d in os.listdir(show)} == \
        {d: len(r) for d, r in results.items()}
    _same_tree(show, tmp_path / "jax")


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inference_one_img_matches_jax(checkpoints, tmp_path):
    img = np.random.default_rng(6).integers(0, 256, (100, 120, 3)).astype(
        np.uint8)
    png = str(tmp_path / "one.png")
    Image.fromarray(img).save(png)
    outs = {}
    for who, run in (("port", lambda d: inference_one_img.main(
            [TINY, checkpoints["pth"], png, "--out-dir", d, "--device",
             "cpu"])),
            ("jax", lambda d: _root_tool("inference_one_img").main(
                [TINY, checkpoints["orbax"], png, "--out-dir", d]))):
        d = str(tmp_path / who)
        os.makedirs(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(d)
        # the printed results (the loggers' lines aside)
        outs[who] = (d, [ln for ln in buf.getvalue().replace(
            d, "OUT").splitlines() if ln.startswith("[")])
    (pd, lines), (jd, jlines) = outs["port"], outs["jax"]
    assert lines == jlines and len(lines) == 3, (lines, jlines)
    assert lines[0].startswith("[cls/resisc] class = ")
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == [
        "det_output.png", "seg_output.png"]
    _same_png(os.path.join(pd, "det_output.png"),
              os.path.join(jd, "det_output.png"))
    # the seg overlay: equal where JAX's labels are clear of a near tie
    seg_img = np.zeros((1, 128, 128, 3), np.float32)
    seg_img[0, :100, :120] = img
    with jax.default_matmul_precision("highest"):
        logits = np.asarray(jax_make_infer_steps(checkpoints["jm"])[
            "seg_logits"](checkpoints["params"], jnp.asarray(seg_img)))[0]
    top2 = -np.sort(-logits[:100, :120], axis=-1)[..., :2]
    clear = top2[..., 0] - top2[..., 1] > 10 * SEG_TOL
    assert clear.mean() > 0.99
    p, j = (_pixels(os.path.join(d, "seg_output.png")) for d in (pd, jd))
    assert p.shape == j.shape == (100, 120, 3)
    np.testing.assert_array_equal(p[clear], j[clear])
