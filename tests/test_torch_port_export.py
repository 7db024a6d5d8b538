"""Export and serve: K1's and K2's forwards as ``torch.library`` operators,
``rscotr_tpu_torch/export.py`` through the port's ``tools/export_model.py``
on a ``.pth``, and ``tools/serve.py``, on the CPU, held against the JAX
package's live steps.

One module fixture carries the tiny config's weights from JAX's init
(``state_dict_from_jax``) into the port, saves them as a ``.pth`` and runs
``export_model --device cpu --input-dtype uint8 --check`` on it at the
buckets cls 2 x 64^2, det 2 x 128^2, seg 2 x 64^2; the tests load that one
artifact. Checked:

* the operators' schemas and fake implementations (``opcheck``);
* each loaded program calls ``rscotr_torch::msda_fwd`` (det, seg),
  ``rscotr_torch::window_attn_fwd`` and ``rscotr_torch::layer_norm_fwd``
  once per MSDA layer, Swin block and LayerNorm call, and no
  ``grid_sampler`` and no aten LayerNorm;
* the artifact against the port's live steps (atol 1e-5, as JAX's
  tests/test_export.py) and against JAX's live ``make_infer_steps`` (JAX
  under highest matmul precision) at the slice tolerances of
  tests/test_torch_port_slice.py: cls 1e-5, det scores 1e-5 and boxes 1e-3
  px with labels equal (JAX's gap at the top-k cut asserted above 10x the
  score tolerance), seg labels equal wherever JAX's top-two logits lie more
  than 10x SEG_TOL (1e-4) apart;
* ``meta.json``'s keys against those of JAX's ``save_artifact``;
* the raw-bytes artifact with a custom normalization, and a float32 one;
* the serve tool's ``_prep`` / ``_resize_labels_nearest`` / ``_list_images``
  / ``_class_name`` against the root ``tools/serve.py``'s, exactly;
* the serve CLI in a process that imports no model module (the cls
  program), and the tool over every task against the live steps (its
  results.json and seg PNGs);
* ``load_artifact``'s refusals; a ``cuda`` case (the operators' CUDA
  dispatch and launches per artifact request) that skips without a card.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from rscotr_tpu_torch import export as export_mod
from rscotr_tpu_torch.engine import make_infer_steps, save_checkpoint
from rscotr_tpu_torch.export import (META_NAME, check_kernel_ops,
                                     export_inference, graph_ops,
                                     load_artifact, save_artifact)
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.tools import export_model
from rscotr_tpu_torch.tools import serve as port_serve
from rscotr_tpu_torch.utils.config import load_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
BUCKETS = {"cls": (2, 64), "det": (2, 128), "seg": (2, 64)}
ROUND_TOL = 1e-5
CLS_TOL, SCORE_TOL, BOX_TOL, SEG_TOL = 1e-5, 1e-5, 1e-3, 1e-4
# the tiny config: Swin depths [1, 1, 2, 1]; 2 encoder and 2 det decoder
# MSDA layers; LayerNorm calls: Swin 18, det head 13, seg head 17
OP_COUNTS = {"cls": {"window_attn_fwd": 5, "msda_fwd": 0,
                     "layer_norm_fwd": 18},
             "det": {"window_attn_fwd": 5, "msda_fwd": 4,
                     "layer_norm_fwd": 31},
             "seg": {"window_attn_fwd": 5, "msda_fwd": 2,
                     "layer_norm_fwd": 35}}


def _jax_side(cfg):
    """JAX's tiny model, its init (key 0) and its weights in the port's
    layout. JAX is imported here so that the ``cuda`` case runs where JAX
    is not."""
    import jax
    import jax.numpy as jnp

    from rscotr_tpu.models import build_model as jax_build_model
    from rscotr_tpu_torch.utils.convert import state_dict_from_jax
    jm = jax_build_model(cfg["model"])
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    tree = jax.tree.map(lambda x: np.asarray(x).copy(), params["params"])
    return jm, params, state_dict_from_jax(tree)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = load_cfg(TINY)
    jm, params, state = _jax_side(cfg)
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(state, strict=True)
    wd = tmp_path_factory.mktemp("export")
    classes = {"resisc": [f"scene_{i}" for i in range(45)]}
    ckpt = save_checkpoint(str(wd), 0, model, meta={"CLASSES": classes})
    art = str(wd / "artifact")
    argv = [TINY, ckpt, "--out", art, "--device", "cpu", "--input-dtype",
            "uint8", "--check"]
    for t, (bs, size) in BUCKETS.items():
        argv += [f"--{t}-bs", str(bs), f"--{t}-size", str(size)]
    # the artifact --check loads is the one the tests use (a load costs
    # seconds)
    loaded = []

    def keep(*a, **kw):
        loaded.append(load_artifact(*a, **kw))
        return loaded[-1]

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        export_mod.load_artifact = keep
        try:
            rc = export_model.main(argv)
        finally:
            export_mod.load_artifact = load_artifact
    (fns, meta), = loaded
    # the serve CLI's own process starts now and runs beside the tests
    # before its own (a torch import and a program load: seconds)
    serve_dir = wd / "serve"
    serve_dir.mkdir()
    imgs = _serve_images(serve_dir)
    argv = [art, str(imgs), "--out-dir", str(serve_dir / "out"), "--device",
            "cpu", "--tasks", "cls"]
    code = ("import json, runpy, sys\n"
            f"sys.argv = ['serve'] + {json.dumps(argv)}\n"
            "runpy.run_module('rscotr_tpu_torch.tools.serve', "
            "run_name='__main__')\n"
            "print('MODULES', json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('rscotr_tpu', 'rscotr_tpu_torch', 'jax', "
            "'flax'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        yield dict(cfg=cfg, jm=jm, params=params, model=model, art=art,
                   fns=fns, meta=meta, rc=rc, stdout=out.getvalue(),
                   classes=classes, serve=(proc, argv, serve_dir))
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _inputs(task, seed=3):
    """uint8 pixels; det with one padded image and a rescale, as the slice
    test's (seed 3: JAX's cut gaps clear 10x SCORE_TOL)."""
    bs, size = BUCKETS[task]
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (bs, size, size, 3)).astype(np.uint8)
    if task != "det":
        return (img,)
    return (img, np.array([[128, 128], [100, 120]], np.int32),
            np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]], np.float32))


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def test_export_model_cli_check(exported):
    e = exported
    assert e["rc"] == 0, e["stdout"]
    for t in BUCKETS:
        assert f"check {t}: OK" in e["stdout"]
        assert f"{t}: traced in" in e["stdout"]
    assert sorted(os.listdir(e["art"])) == [
        "cls.pt2", "det.pt2", META_NAME, "params.npz", "seg.pt2"]
    assert e["meta"]["classes"] == e["classes"]
    assert e["meta"]["num_param_leaves"] == len(e["model"].state_dict())
    # the weights are stored once: each program is a small share of them
    npz = os.path.getsize(os.path.join(e["art"], "params.npz"))
    assert all(os.path.getsize(os.path.join(e["art"], f"{t}.pt2"))
               < npz / 2 for t in BUCKETS)


@pytest.mark.parametrize("task", sorted(BUCKETS))
def test_programs_call_the_kernel_ops(exported, task):
    program = exported["fns"][task].program
    found = check_kernel_ops(task, program)
    ops = graph_ops(program)
    counts = {name: sum(n for t, n in ops.items()
                        if t == f"rscotr_torch.{name}.default")
              for name in OP_COUNTS[task]}
    assert counts == OP_COUNTS[task]
    assert set(found) <= {f"rscotr_torch.{n}" for n in OP_COUNTS[task]}
    assert not any("grid_sampler" in t for t in ops)
    assert not any("layer_norm" in t and "rscotr" not in t for t in ops)


@pytest.mark.parametrize("task", sorted(BUCKETS))
def test_round_trip_matches_live(exported, task):
    e = exported
    stc = e["cfg"]["model"]["test_cfg"]
    live = make_infer_steps(e["model"],
                            max_per_img=stc["det"]["max_per_img"],
                            seg_test_cfg=stc["seg"])[task]
    got = _tuple(e["fns"][task](*_inputs(task)))
    want = _tuple(live(*_inputs(task)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=ROUND_TOL,
                                   atol=ROUND_TOL)


def _jax_steps(e, max_per_img):
    from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
    return jax_make_infer_steps(e["jm"], max_per_img=max_per_img,
                                seg_test_cfg=e["cfg"]["model"]["test_cfg"]
                                ["seg"])


def test_cls_matches_jax(exported):
    import jax
    import jax.numpy as jnp
    e = exported
    (img,) = _inputs("cls")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_jax_steps(e, 100)["cls"](e["params"],
                                                    jnp.asarray(img)))
    got = e["fns"]["cls"](img)
    assert got.shape == (2, 45) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CLS_TOL)


def test_det_matches_jax(exported):
    import jax
    import jax.numpy as jnp
    e = exported
    k = e["cfg"]["model"]["test_cfg"]["det"]["max_per_img"]
    img, hw, sf = _inputs("det")
    with jax.default_matmul_precision("highest"):
        jdet, jlabels = _jax_steps(e, k + 1)["det"](
            e["params"], jnp.asarray(img), jnp.asarray(hw), jnp.asarray(sf))
    jdet, jlabels = np.asarray(jdet), np.asarray(jlabels)
    gap = jdet[:, k - 1, 4] - jdet[:, k, 4]
    assert np.all(gap > 10 * SCORE_TOL), gap
    det, labels = e["fns"]["det"](img, hw, sf)
    assert det.shape == (2, k, 5) and labels.shape == (2, k)
    np.testing.assert_array_equal(labels.numpy(), jlabels[:, :k])
    np.testing.assert_allclose(det[..., 4].numpy(), jdet[:, :k, 4], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(det[..., :4].numpy(), jdet[:, :k, :4],
                               rtol=0, atol=BOX_TOL)


def test_seg_matches_jax(exported):
    import jax
    import jax.numpy as jnp
    e = exported
    (img,) = _inputs("seg")
    with jax.default_matmul_precision("highest"):
        logits = np.asarray(_jax_steps(e, 100)["seg_logits"](
            e["params"], jnp.asarray(img)))
    top2 = -np.sort(-logits, axis=-1)[..., :2]
    clear = top2[..., 0] - top2[..., 1] > 10 * SEG_TOL
    assert clear.mean() > 0.99
    got = e["fns"]["seg"](img)
    assert got.shape == (2, 64, 64) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy()[clear],
                                  logits.argmax(-1)[clear])


class _StubExported:
    """What JAX's ``save_artifact`` reads of a ``jax.export.Exported``, so
    its meta.json can be written without running ``jax.export``."""

    platforms = ("cpu",)

    def __init__(self, in_avals, out_avals):
        self.in_avals, self.out_avals = in_avals, out_avals

    def serialize(self):
        return b""


def test_meta_keys_match_jax(exported, tmp_path):
    from rscotr_tpu.export import save_artifact as jax_save_artifact
    e = exported
    meta = e["meta"]
    params = {"w": np.zeros(3, np.float32)}
    stubs = {}
    for t, spec in meta["tasks"].items():
        ins = [np.zeros(s, d) for s, d in spec["input_specs"]]
        stubs[t] = _StubExported([params["w"]] + ins, ins[:1])
    shapes = {t: dict(bs=bs, size=size) for t, (bs, size) in BUCKETS.items()}
    jax_save_artifact(str(tmp_path), stubs, params, shapes,
                      classes=e["classes"], img_norm=None,
                      extra_meta={"config": os.path.basename(TINY)})
    jmeta = json.load(open(tmp_path / META_NAME))
    rename = {"jax_version": "torch_version", "platforms": "device"}
    assert sorted(rename.get(k, k) for k in jmeta) == sorted(meta)
    for t, jspec in jmeta["tasks"].items():
        spec = meta["tasks"][t]
        assert sorted(rename.get(k, k) for k in jspec) == sorted(spec)
        for k in ("input_names", "input_specs", "bs", "size"):
            assert spec[k] == jspec[k], (t, k)
        assert spec["device"] == "cpu"
    for k in ("classes", "img_norm", "config"):
        assert meta[k] == jmeta[k]
    k = e["cfg"]["model"]["test_cfg"]["det"]["max_per_img"]
    assert meta["tasks"]["det"]["output_specs"] == [
        [[2, k, 5], "float32"], [[2, k], "int64"]]


@pytest.mark.parametrize("img_dtype", [torch.uint8, torch.float32])
def test_cls_program_input_dtypes(exported, img_dtype):
    """JAX's test_uint8_raw_input_export: a uint8 program bakes a custom
    normalization in; a float32 one takes the normalized pixels. Each, as
    exported (weights first), against the live step on the same inputs."""
    model = exported["model"]
    norm = ((10.0, 20.0, 30.0), (5.0, 5.0, 5.0))
    programs = export_inference(model, {"cls": dict(bs=2, size=32)},
                                tasks=["cls"], img_norm=norm,
                                img_dtype=img_dtype)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    img = raw if img_dtype == torch.uint8 else \
        ((raw - np.float32(norm[0])) / np.float32(norm[1])).astype(
            np.float32)
    want = make_infer_steps(model, img_norm=norm)["cls"](img)
    with torch.inference_mode():
        got = programs["cls"].module()(list(model.state_dict().values()),
                                       torch.as_tensor(img))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ROUND_TOL,
                               atol=ROUND_TOL)
    user = [n for n in programs["cls"].graph.nodes if n.op == "placeholder"
            and n.name in programs["cls"].graph_signature.user_inputs]
    assert user[-1].meta["val"].dtype == img_dtype


def test_load_artifact_refusals(exported):
    e = exported
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        load_artifact(e["art"], tasks=["cls"], device="cuda")
    with pytest.raises(ValueError, match="the program takes"):
        e["fns"]["cls"](np.zeros((3, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="the program takes"):
        e["fns"]["cls"](np.zeros((2, 64, 64, 3), np.float32))
    with pytest.raises(TypeError, match="takes 3 inputs"):
        e["fns"]["det"](np.zeros((2, 128, 128, 3), np.uint8))


def _root_serve():
    spec = importlib.util.spec_from_file_location(
        "root_serve", os.path.join(ROOT, "tools", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("task", sorted(BUCKETS))
def test_prep_matches_root_serve(task):
    root = _root_serve()
    rng = np.random.default_rng(len(task))
    norm = ([10.0, 20.0, 30.0], [5.0, 6.0, 7.0])
    for hw in ((40, 50), (128, 96), (7, 300)):
        raw = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        for img_norm in (None, norm):
            for is_uint8 in (True, False):
                got = port_serve._prep(task, raw, 64, img_norm, is_uint8)
                want = root._prep(task, raw, 64, img_norm, is_uint8)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
        labels = rng.integers(0, 6, (64, 64))
        np.testing.assert_array_equal(
            port_serve._resize_labels_nearest(labels, *hw),
            root._resize_labels_nearest(labels, *hw))
    meta = {"classes": {"a": ["x", "y"], "b": ["p", "q", "r"]}}
    assert [port_serve._class_name(meta, n, 1) for n in (2, 3, 4)] == \
        [root._class_name(meta, n, 1) for n in (2, 3, 4)]


def _serve_images(root):
    """3 PNGs of mixed sizes (a partial last batch) and a file that is not
    an image."""
    rng = np.random.default_rng(7)
    imgs = root / "imgs"
    imgs.mkdir()
    for i, hw in enumerate([(40, 50), (64, 64), (90, 60)]):
        Image.fromarray(rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                        ).save(imgs / f"im{i}.png")
    (imgs / "notes.txt").write_text("not an image")
    return imgs


def test_serve_cli_without_model_code(exported, monkeypatch):
    """tools/serve.py in a process of its own (the cls program, the
    cheapest to load; started by the fixture): it imports no model module
    of the port and nothing of JAX, and serves what the tool serves in
    process."""
    e = exported
    proc, argv, serve_dir = e["serve"]
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stdout + stderr
    mods = json.loads(stdout.split("MODULES", 1)[1])
    assert all(m.startswith(("rscotr_tpu_torch.ops", "rscotr_tpu_torch.tools",
                             "rscotr_tpu_torch.export"))
               or m == "rscotr_tpu_torch" for m in mods), mods
    assert "[cls] im0.png: scene_" in stdout
    got = json.load(open(serve_dir / "out" / "results.json"))
    monkeypatch.setattr(export_mod, "load_artifact",
                        lambda *a, **kw: (e["fns"], e["meta"]))
    want = port_serve.main(argv + ["--out-dir", str(serve_dir / "in")])
    assert got == want


def test_serve_results_match_live(exported, tmp_path, monkeypatch):
    """The serve tool over every task (the fixture's loaded artifact):
    results.json and the seg PNGs against the live steps on the tool's own
    preprocessing."""
    e = exported
    monkeypatch.setattr(export_mod, "load_artifact",
                        lambda *a, **kw: (e["fns"], e["meta"]))
    imgs = _serve_images(tmp_path)
    out = tmp_path / "out"
    results = port_serve.main([e["art"], str(imgs), "--out-dir", str(out),
                               "--score-thr", "0.0", "--device", "cpu"])
    assert json.load(open(out / "results.json")) == results
    assert sorted(results) == [f"im{i}.png" for i in range(3)]
    stc = e["cfg"]["model"]["test_cfg"]
    live = make_infer_steps(e["model"], max_per_img=stc["det"]["max_per_img"],
                            seg_test_cfg=stc["seg"])
    raws = [np.asarray(Image.open(imgs / f"im{i}.png")) for i in range(3)]
    for task, (bs, size) in BUCKETS.items():
        prepped = [port_serve._prep(task, r, size, None, True) for r in raws]
        for b0 in range(0, 3, bs):
            chunk = prepped[b0:b0 + bs]
            n = len(chunk)
            chunk += [chunk[-1]] * (bs - n)
            args = [np.stack([c[i] for c in chunk]) for i in range(3)]
            want = live[task](*(args if task == "det" else args[:1]))
            for i in range(n):
                r = results[f"im{b0 + i}.png"][task]
                if task == "cls":
                    assert r["top1"] == int(want[i].argmax())
                    assert r["label"] == f"scene_{r['top1']}"
                    assert abs(r["prob"] - float(want[i].max())) <= ROUND_TOL
                elif task == "det":
                    np.testing.assert_allclose(
                        np.asarray(r["boxes_xyxy_score"]),
                        want[0][i].numpy(), rtol=ROUND_TOL, atol=ROUND_TOL)
                    assert r["labels"] == want[1][i].tolist()
                else:
                    H, W = raws[b0 + i].shape[:2]
                    lab = port_serve._resize_labels_nearest(
                        want[i].numpy(), H, W)
                    png = np.asarray(Image.open(r["png"]))
                    assert png.shape == (H, W)
                    np.testing.assert_array_equal(png, lab)
                    assert r["classes"] == sorted(np.unique(lab).tolist())


# ---------------------------------------------------------------------------
# the operators on the card
# ---------------------------------------------------------------------------

def _msda_case(device, D=32):
    rng = np.random.default_rng(0)
    shapes = [(12, 16), (6, 8)]
    nv = sum(h * w for h, w in shapes)
    value = torch.tensor(rng.normal(size=(2, nv, 4, D)), dtype=torch.float32)
    loc = torch.tensor(rng.uniform(size=(2, 37, 4, 2, 4, 2)),
                       dtype=torch.float32)
    attn = torch.tensor(rng.uniform(size=(2, 37, 4, 2, 4)),
                        dtype=torch.float32)
    flat = [n for s in shapes for n in s]
    return [t.to(device) for t in (value, loc, attn)], flat


def _wa_case(device, masked=True):
    from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
    rng = np.random.default_rng(1)
    qkv = torch.tensor(rng.normal(size=(2, 4, 3, 3, 49, 16)),
                       dtype=torch.float32)
    q, k, v = qkv.unbind(2)                       # strided views
    bias = torch.tensor(rng.normal(size=(3, 49, 49)), dtype=torch.float32)
    mask = torch.as_tensor(_shift_attn_mask(14, 14, 7, 3)) if masked \
        else None
    to = (lambda t: None if t is None else t.to(device))
    return [to(t) for t in (q, k, v, bias, mask)] + [16 ** -0.5]


@pytest.mark.parametrize("masked", [True, False])
def test_ops_opcheck(masked):
    """Schema, fake implementation and dispatch of both operators on CPU
    tensors (the plain versions), strided q, k, v included."""
    (value, loc, attn), flat = _msda_case("cpu")
    torch.library.opcheck(torch.ops.rscotr_torch.msda_fwd.default,
                          (value, flat, loc, attn))
    torch.library.opcheck(torch.ops.rscotr_torch.window_attn_fwd.default,
                          tuple(_wa_case("cpu", masked)))
    out = torch.ops.rscotr_torch.window_attn_fwd(*_wa_case("cpu", masked))
    assert out.is_contiguous() and out.shape == (2, 4, 3, 49, 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ops_launch_the_kernels_on_cuda(cuda_device, tmp_path):
    """On the card each operator launches its kernel (counted by the
    wrapper) and agrees with its plain version; an artifact exported on
    ``cuda`` launches K1 / K2 / K7 per request as the live steps do, every
    K1 on the vector body."""
    from rscotr_tpu_torch.ops.layer_norm import layer_norm
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_torch)
    from rscotr_tpu_torch.ops.window_attention import (
        window_attention, window_attention_torch)
    (value, loc, attn), flat = _msda_case(cuda_device)
    k1, vec = ms_deform_attn.launches, ms_deform_attn.vec_launches
    out = torch.ops.rscotr_torch.msda_fwd(value, flat, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == k1 + 1
    assert ms_deform_attn.vec_launches == vec + 1
    pairs = list(zip(flat[::2], flat[1::2]))
    torch.testing.assert_close(out, ms_deform_attn_torch(value, pairs, loc,
                                                         attn),
                               rtol=1e-5, atol=1e-5)
    args = _wa_case(cuda_device)
    k2 = window_attention.launches
    out = torch.ops.rscotr_torch.window_attn_fwd(*args)
    torch.cuda.synchronize()
    assert window_attention.launches == k2 + 1
    torch.testing.assert_close(out, window_attention_torch(*args),
                               rtol=1e-5, atol=1e-5)

    cfg = load_cfg(TINY)
    model = build_model(cfg["model"], device=cuda_device)
    shapes = {t: dict(bs=bs, size=s) for t, (bs, s) in BUCKETS.items()}
    programs = export_inference(model, shapes, max_per_img=10,
                                img_dtype=torch.uint8)
    save_artifact(str(tmp_path), programs, model.state_dict(), shapes)
    fns, _ = load_artifact(str(tmp_path), device="cuda")
    for task, want in OP_COUNTS.items():
        k1, vec = ms_deform_attn.launches, ms_deform_attn.vec_launches
        k2, k7 = window_attention.launches, layer_norm.launches
        fns[task](*_inputs(task))
        torch.cuda.synchronize()
        assert layer_norm.launches - k7 == want["layer_norm_fwd"]
        assert ms_deform_attn.launches - k1 == want["msda_fwd"]
        assert ms_deform_attn.vec_launches - vec == want["msda_fwd"]
        assert window_attention.launches - k2 == want["window_attn_fwd"]
