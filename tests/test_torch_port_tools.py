"""The port's user tools (rscotr_tpu_torch/tools/) against the root tools of
the JAX package, on the CPU:

* ``_bench_common``: the benchmark's batches equal the root tool's
  ``make_batch_fns`` arrays exactly (tiny config and flagship, with and
  without CLI overrides), and ``derive_shapes`` its shapes;
* ``benchmark``: the tiny config's report carries the root tool's keys
  (``--train`` with ``model.backbone.with_cp=True`` as
  tests/test_tools.py::TestBenchmarkCLI runs it; ``--eval-loop``), and
  ``--scan`` is refused with its reason;
* ``ops/flops.py``: the K2 and K2b formulas against ``FlopCounterMode``'s
  count of their plain versions (pure matmuls), and each of the four
  kernel operators counted once, not also through its body;
* K1b and K2b as operators: ``torch.library.opcheck`` on CPU tensors;
* ``overfit_proof``: the root tool's targets and default config, its log
  format and JSON line on a 4-iteration run, and the exit code;
* ``confusion_matrix``: the matrix equal to the root tool's, the plot
  written where matplotlib is installed;
* ``featmap_vis.draw_featmap``: pixel-equal to the root renderer for all
  three reductions;
* ``test_without_det_eval``: the port's test tool.

The ``cuda``-marked case skips without a card.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import rscotr_tpu_torch.ops  # noqa: F401  (registers the operators)
from rscotr_tpu_torch.ops import flops
from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                 ms_deform_attn_bwd_torch,
                                                 ms_deform_attn_torch)
from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                   window_attention_bwd_torch,
                                                   window_attention_torch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
FLAGSHIP = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")

# the root tools/benchmark.py report: top-level and per-task keys (its
# *_mfu keys only where it knows the device's peak)
BENCH_TOP = {"device", "backend", "tasks"}
BENCH_INFER = {"infer_ms", "infer_gflops", "infer_temp_mb"}
BENCH_TRAIN = {"train_ms", "train_gflops", "train_temp_mb"}
EVAL_LOOP = {"task", "images", "img_per_s", "total_s", "host_pipeline_s",
             "host_share", "metric_s"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch keeps to 2 threads, so that the test workers beside this one
    do not oversubscribe the cores (the proof's loader threads and the
    main thread each run torch ops)."""
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


# -- _bench_common -----------------------------------------------------------

def _both_cfgs(path):
    from rscotr_tpu.config import Config
    from rscotr_tpu.data import load_data_cfg as jax_load_data_cfg
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.utils.config import load_cfg
    jcfg = jax_load_data_cfg(Config.fromfile(path), config_root=ROOT)
    cfg = load_data_cfg(load_cfg(path), config_root=ROOT, filename=path)
    return jcfg, cfg


@pytest.mark.parametrize("path", [TINY, FLAGSHIP], ids=["tiny", "flagship"])
@pytest.mark.parametrize("overrides", [
    None, {"cls": {"bs": 2, "size": 32}, "det": {"bs": 2, "size": 64},
           "seg": {"bs": 1, "size": 48}}], ids=["config", "flags"])
def test_bench_batches_match_root(path, overrides):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import _bench_common as root_bench
    finally:
        sys.path.pop(0)
    from rscotr_tpu_torch.tools import _bench_common as port_bench
    jcfg, cfg = _both_cfgs(path)
    jshapes = root_bench.derive_shapes(jcfg, overrides)
    shapes = port_bench.derive_shapes(cfg, overrides)
    assert shapes == jshapes
    if path == FLAGSHIP and overrides is None:
        # full size: one det image at 800^2 is enough to hold the order
        shapes = dict(shapes, cls=dict(shapes["cls"], bs=2),
                      seg=dict(shapes["seg"], bs=1))
    want = root_bench.make_batch_fns(shapes, np.random.default_rng(0))
    got = port_bench.make_batch_fns(shapes, np.random.default_rng(0))
    for i in range(2):
        for task in ("cls", "det", "seg"):
            w, g = want[task](i), got[task](i)
            assert sorted(g) == sorted(w)
            for k in w:
                wk = np.asarray(w[k])
                assert g[k].numpy().dtype == wk.dtype, (task, k)
                np.testing.assert_array_equal(g[k].numpy(), wk,
                                              err_msg=f"{task} {k}")


# -- benchmark ---------------------------------------------------------------

def test_benchmark_report_has_root_keys():
    from rscotr_tpu_torch.tools import benchmark
    report = benchmark.main([
        TINY, "--tasks", "cls", "--train", "--iters", "1", "--warmup", "1",
        "--cfg-options", "model.backbone.with_cp=True", "--device", "cpu"])
    assert set(report) == BENCH_TOP
    assert report["backend"] == "cpu" and list(report["tasks"]) == ["cls"]
    entry = report["tasks"]["cls"]
    assert BENCH_INFER | BENCH_TRAIN <= set(entry)
    assert not any(k.endswith("_mfu") for k in entry)   # no peak on a CPU
    assert entry["train_ms"] > 0 and entry["infer_ms"] > 0
    assert entry["train_temp_mb"] == 0.0
    # the cls path: K2 and K2b, no MSDA; with with_cp the blocks run twice
    # in the step (forward, then the recompute)
    kf = entry["train_kernel_flops"]
    assert kf["msda_fwd"] == kf["msda_bwd"] == 0
    assert kf["window_attn_fwd"] == 2 * entry["infer_kernel_flops"][
        "window_attn_fwd"] > 0
    assert entry["train_gflops"] > entry["infer_gflops"] > 0


def test_benchmark_eval_loop():
    from rscotr_tpu_torch.tools import benchmark
    report = benchmark.main([TINY, "--eval-loop", "--iters", "1",
                             "--device", "cpu"])
    assert set(report) == BENCH_TOP | {"eval_loop"}
    assert sorted(report["eval_loop"]) == ["dior", "potsdam", "resisc"]
    for name, ev in report["eval_loop"].items():
        assert set(ev) == EVAL_LOOP, name
        assert ev["images"] >= 1 and ev["img_per_s"] > 0
        assert 0 < ev["host_share"]


def test_benchmark_refuses_scan():
    from rscotr_tpu_torch.tools import benchmark
    with pytest.raises(SystemExit) as e:
        benchmark.main([TINY, "--scan", "--device", "cpu"])
    msg = str(e.value)
    assert "lax.scan" in msg and "CUDA-graph" in msg


# -- FLOP formulas -------------------------------------------------------------

def _wa_case(masked, dtype=torch.float32, B=2, nW=4, H=3, n=49, hd=16):
    g = torch.Generator().manual_seed(0)
    q, k, v, d = (torch.randn(B, nW, H, n, hd, generator=g).to(dtype)
                  for _ in range(4))
    bias = torch.randn(H, n, n, generator=g)
    mask = (torch.randint(0, 2, (nW, n, n), generator=g).float() * -100.0
            if masked else None)
    return q, k, v, bias, mask, 0.25, d


def _msda_case(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    shapes = ((8, 8), (4, 4))
    value = torch.randn(2, 80, 2, 8, generator=g).to(dtype)
    loc = torch.rand(2, 10, 2, 2, 3, 2, generator=g) * 1.4 - 0.2
    attn = torch.rand(2, 10, 2, 2, 3, generator=g).to(dtype)
    d_out = torch.randn(2, 10, 16, generator=g).to(dtype)
    return value, shapes, loc, attn, d_out


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops(), fc.get_flop_counts()["Global"]


@pytest.mark.parametrize("masked", [True, False])
def test_window_attn_formulas_match_plain(masked):
    """K2's formula is the count of its plain version; K2b's five products
    are the plain backward's count less its recompute of O = P V (the
    kernel takes rowsum(dO o O) as rowsum(P o dP) instead)."""
    q, k, v, bias, mask, scale, d = _wa_case(masked)
    tiles, n, hd = 2 * 4 * 3, 49, 16
    total, _ = _counted(lambda: window_attention_torch(q, k, v, bias, mask,
                                                       scale))
    assert total == flops.window_attn_flops(tiles, n, hd)
    total, _ = _counted(lambda: window_attention_bwd_torch(
        q, k, v, bias, mask, scale, d))
    recompute_o = 2 * n * n * hd * tiles
    assert total == flops.window_attn_bwd_flops(tiles, n, hd) + recompute_o


def test_kernel_operators_counted_once():
    """Through the autograd Functions: each operator once, at its formula,
    and nothing of its body (the plain versions' einsums, grid_sample)."""
    q, k, v, bias, mask, scale, _ = _wa_case(True)
    q, k, v, bias = (t.requires_grad_() for t in (q, k, v, bias))
    total, per = _counted(lambda: window_attention(
        q, k, v, bias, mask, scale).sum().backward())
    tiles = 2 * 4 * 3
    ops = torch.ops.rscotr_torch
    assert per == {ops.window_attn_fwd: flops.window_attn_flops(tiles, 49,
                                                                16),
                   ops.window_attn_bwd: flops.window_attn_bwd_flops(
                       tiles, 49, 16)}
    assert total == sum(per.values())

    value, shapes, loc, attn, _ = _msda_case()
    for t in (value, loc, attn):
        t.requires_grad_()
    total, per = _counted(lambda: ms_deform_attn(
        value, shapes, loc, attn).sum().backward())
    corners = flops.msda_corners(loc.shape)
    assert corners == 4 * 2 * 10 * 2 * 2 * 3
    assert per == {ops.msda_fwd: flops.msda_fwd_flops(corners, 8),
                   ops.msda_bwd: flops.msda_bwd_flops(corners, 8)}
    assert total == sum(per.values())


# -- K1b and K2b as operators ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [True, False])
def test_window_attn_bwd_opcheck(masked, dtype):
    args = _wa_case(masked, dtype)
    torch.library.opcheck(torch.ops.rscotr_torch.window_attn_bwd.default,
                          args)
    dq, dk, dv, db = torch.ops.rscotr_torch.window_attn_bwd(*args)
    want = window_attention_bwd_torch(*args)
    for g, w in zip((dq, dk, dv, db), want):
        assert g.is_contiguous() and torch.equal(g, w)
    assert dq.dtype == dtype and db.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_bwd_opcheck(dtype):
    value, shapes, loc, attn, d_out = _msda_case(dtype)
    flat = [n for s in shapes for n in s]
    torch.library.opcheck(torch.ops.rscotr_torch.msda_bwd.default,
                          (value, flat, loc, attn, d_out))
    got = torch.ops.rscotr_torch.msda_bwd(value, flat, loc, attn, d_out)
    want = ms_deform_attn_bwd_torch(value, shapes, loc, attn, d_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_msda_forward_plain_unchanged():
    value, shapes, loc, attn, _ = _msda_case()
    flat = [n for s in shapes for n in s]
    assert torch.equal(torch.ops.rscotr_torch.msda_fwd(value, flat, loc,
                                                       attn),
                       ms_deform_attn_torch(value, shapes, loc, attn))


@pytest.mark.cuda
def test_backward_operators_launch_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn_bwd
    from rscotr_tpu_torch.ops.window_attention import window_attention_bwd
    dev = torch.device("cuda")
    args = [t.to(dev) if isinstance(t, torch.Tensor) else t
            for t in _wa_case(True)]
    before = window_attention_bwd.launches
    got = window_attention_bwd(*args)
    assert window_attention_bwd.launches == before + 1
    want = window_attention_bwd_torch(*[
        t.cpu() if isinstance(t, torch.Tensor) else t for t in args])
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    value, shapes, loc, attn, d_out = (
        t.to(dev) if isinstance(t, torch.Tensor) else t
        for t in _msda_case())
    before = ms_deform_attn_bwd.launches
    got = ms_deform_attn_bwd(value, shapes, loc, attn, d_out)
    assert ms_deform_attn_bwd.launches == before + 1
    want = ms_deform_attn_bwd_torch(value.cpu(), shapes, loc.cpu(),
                                    attn.cpu(), d_out.cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


# -- overfit proof -----------------------------------------------------------

def test_overfit_targets_and_config_match_root():
    root = _load("tools/overfit_proof.py", "root_overfit_proof")
    from rscotr_tpu_torch.tools import overfit_proof
    assert overfit_proof.TARGETS == root.TARGETS
    assert list(overfit_proof.TARGETS) == list(root.TARGETS)
    want = root.parse_args([])
    got = overfit_proof.parse_args([])
    assert os.path.abspath(got.config) == os.path.abspath(want.config)
    for k in ("work_dir", "eval_every", "max_iters", "log", "seed"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.device == "cuda"


def test_overfit_proof_short_run(tmp_path, capsys, monkeypatch):
    """4 iterations, an evaluation every 2: the root tool's log (heading,
    run line, table, trajectory) and JSON line. The real targets are not
    met so early; with every threshold at 0 they are, at the first
    evaluation."""
    from rscotr_tpu_torch.tools import overfit_proof
    log = tmp_path / "proof.md"
    res = overfit_proof.main(["--work-dir", str(tmp_path / "wd"),
                              "--eval-every", "2", "--max-iters", "4",
                              "--log", str(log), "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(res))
    assert set(res) == {"ok", "first_met", "final"}
    assert list(res["final"]) == list(overfit_proof.TARGETS)
    assert all(isinstance(v, float) for v in res["final"].values())
    assert res["ok"] is (len(res["first_met"]) == 3)
    text = log.read_text().splitlines()
    assert text[0] == "# Overfit-to-metric proof"
    assert text[2].startswith("Run: ") and " on `cpu` (1 device(s)), " \
        "config `configs/multi/MTL_overfit_proof.py`, eval every 2, cap 4 " \
        "iters." in text[2]
    assert "| target | threshold | first met at iter | final |" in text
    rows = [ln for ln in text if ln.startswith("| ") and "." in ln
            and "target" not in ln]
    assert [r.split(" | ")[0][2:] for r in rows] == list(
        overfit_proof.TARGETS)
    traj = [ln for ln in text if ln.startswith("iter ")]
    assert [ln.split(":")[0] for ln in traj] == ["iter 2", "iter 4"]
    assert list(json.loads(traj[0].split(": ", 1)[1])) == list(
        overfit_proof.TARGETS)

    monkeypatch.setattr(overfit_proof, "TARGETS",
                        dict.fromkeys(overfit_proof.TARGETS, 0.0))
    res = overfit_proof.main(["--work-dir", str(tmp_path / "wd0"),
                              "--eval-every", "2", "--max-iters", "4",
                              "--device", "cpu"])
    assert res["ok"] is True
    assert res["first_met"] == dict.fromkeys(overfit_proof.TARGETS, 2)
    table = (tmp_path / "wd0" / "proof.md").read_text()
    assert "NOT MET" not in table


def test_overfit_proof_exit_code(tmp_path):
    """Run as a module, it exits 1 when a target is not met (2 iterations
    meet none of the real ones)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run(
        [sys.executable, "-m", "rscotr_tpu_torch.tools.overfit_proof",
         "--work-dir", str(tmp_path), "--eval-every", "2", "--max-iters",
         "2", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 1, res.stdout[-2000:] + res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] is False
    assert "NOT MET" in (tmp_path / "proof.md").read_text()


# -- confusion matrix --------------------------------------------------------

@pytest.mark.parametrize("preds", ["scores", "labels"])
def test_confusion_matrix_matches_root(tmp_path, preds, capsys,
                                       monkeypatch):
    root = _load("tools/confusion_matrix/get_cls_confusion_matrix.py",
                 "root_get_cm")
    from rscotr_tpu_torch.tools.confusion_matrix import (
        get_cls_confusion_matrix)
    rng = np.random.default_rng(4)
    gt = rng.integers(0, 5, 40)
    pred = rng.normal(size=(40, 5)) if preds == "scores" else \
        rng.integers(0, 5, 40)
    np.save(tmp_path / "gt.npy", gt)
    np.save(tmp_path / "pred.npy", pred)
    want_path, got_path = tmp_path / "root.npy", tmp_path / "port.npy"
    monkeypatch.setattr(sys, "argv", [
        "get_cls_confusion_matrix", str(tmp_path / "gt.npy"),
        str(tmp_path / "pred.npy"), "--out", str(want_path)])
    root.main()
    want_line = capsys.readouterr().out.strip().replace(str(want_path), "")
    cm = get_cls_confusion_matrix.main([
        str(tmp_path / "gt.npy"), str(tmp_path / "pred.npy"), "--out",
        str(got_path), "--plot", str(tmp_path / "cm.png")])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].replace(str(got_path), "") == want_line
    want = np.load(want_path)
    np.testing.assert_array_equal(np.load(got_path), want)
    np.testing.assert_array_equal(cm, want)
    pytest.importorskip("matplotlib")
    assert out[1] == f"plot -> {tmp_path / 'cm.png'}"
    assert (tmp_path / "cm.png").stat().st_size > 0


def test_plot_confusion_matrix(tmp_path):
    pytest.importorskip("matplotlib")
    from rscotr_tpu_torch.tools.confusion_matrix import plot_confusion_matrix
    np.save(tmp_path / "cm.npy", np.array([[3, 1, 0], [0, 2, 1],
                                           [1, 0, 4]]))
    (tmp_path / "classes.txt").write_text("a\nb\nc\n")
    out = plot_confusion_matrix.main([
        str(tmp_path / "cm.npy"), "--out", str(tmp_path / "cm.png"),
        "--classes", str(tmp_path / "classes.txt")])
    assert out == str(tmp_path / "cm.png")
    assert (tmp_path / "cm.png").stat().st_size > 0


# -- featmap renderer, alias ---------------------------------------------------

@pytest.mark.parametrize("reduction", ["squeeze_mean", "select_max", None])
def test_draw_featmap_pixel_equal(reduction):
    root = _load("tools/featmap_vis/draw_featmap.py", "root_draw_featmap")
    from rscotr_tpu_torch.tools.featmap_vis.draw_featmap import draw_featmap
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(8, 8, 24)).astype(np.float32)
    img = rng.integers(0, 255, size=(32, 32, 3)).astype(np.uint8)
    for kw in ({}, {"topk": 6, "arrangement": (2, 3)}):
        want = root.draw_featmap(feat, img, channel_reduction=reduction,
                                 **kw)
        got = draw_featmap(feat, img, channel_reduction=reduction, **kw)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_vis_featmap_draw_pixel_equal():
    """vis_featmap.py's own two-colour renderer."""
    sys.path.insert(0, os.path.join(ROOT, "tools", "featmap_vis"))
    try:
        root = _load("tools/featmap_vis/vis_featmap.py", "root_vis_featmap")
    finally:
        sys.path.pop(0)
    from rscotr_tpu_torch.tools.featmap_vis import vis_featmap
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(7, 7, 10)).astype(np.float32)
    img = rng.uniform(0, 255, size=(28, 28, 3)).astype(np.float32)
    for red in ("squeeze_mean", "select_max"):
        want = root.draw_featmap(feat, img, channel_reduction=red, topk=3)
        got = vis_featmap.draw_featmap(feat, img, channel_reduction=red,
                                       topk=3)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_test_without_det_eval_is_the_test_tool():
    from rscotr_tpu_torch.tools import test, test_without_det_eval
    assert test_without_det_eval.main is test.main
