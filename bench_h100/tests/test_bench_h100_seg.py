"""The seg cell (``m2f_swin_l_seg_scene``) on its CPU stand-in
(``conftest.py``: a tiny Mask2Former with Swin at window 12): its check
fails the float8 control, an altered label map and a half batch; its FLOP
count equals ``FlopCounterMode``'s; its metric readers read synthetic
traces and the serve driver's traced run."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_h100 import calibrate, harness, run as brun
from bench_h100.checks import seg as seg_check
from bench_h100.counts import mask2former as m2f_counts
from bench_h100.tests import _tiny
from bench_h100.trace import Trace

CELL = "m2f_swin_l_seg_scene"
SEED = 2 ** 31 + 23
NEW = ("seg_mfu_pct.infer", "seg_idle_pct.infer", "winattn144_roofline.infer",
       "seg_pixdec_idle_ms.infer", "seg_decoder_idle_ms.infer",
       "seg_semantic_idle_ms.infer")


def _run(cell, trace=0, seconds=0.5):
    return brun.run_cell(cell, SEED, seconds, trace, device="cpu", t0=0.0)


def _broken(monkeypatch, fault):
    """The seg entry replaced by a broken copy under the serve driver."""
    from rscotr_tpu_torch.engine import infer
    real = infer.make_infer_steps

    def make(model, *a, **k):
        steps = dict(real(model, *a, **k))
        good = steps["seg"]
        steps["seg"] = lambda img: fault(good, img)
        return steps
    monkeypatch.setattr(infer, "make_infer_steps", make)


def test_sound_run_is_correct_and_exact_on_labels():
    ok, run, table = _run(_tiny.cell(CELL))
    assert ok, table
    assert table["label_gap"]["value"] == 0.0
    assert run.requests > 0 and run.checked


def test_control_is_not_correct():
    cell = _tiny.cell(CELL, dtype="bfloat16")
    ok, run, table = _run(cell)
    assert ok, table
    ctrl = calibrate.control_numbers(cell, SEED, run, "cpu")
    assert set(ctrl) == set(cell.workload["limits"])
    assert not harness.judge(ctrl, cell.workload["limits"])[0], ctrl


def _labels_moved(fn, img):
    """The last tile's labels moved by one class where the map is made."""
    out = fn(img).clone()
    out[-1] = (out[-1] + 1) % 7
    return out


def _half_left_out(fn, img):
    """Half of the tiles computed, the other half answered with them."""
    out = fn(img[:img.shape[0] // 2])
    return torch.cat([out, out])


def test_altered_label_map_is_caught_by_label_gap(monkeypatch):
    _broken(monkeypatch, _labels_moved)
    ok, _, table = _run(_tiny.cell(CELL))
    assert not ok
    assert table["label_gap"]["value"] == math.inf
    for k in ("mask_gap", "cls_gap", "sem_gap", "flip_share"):
        assert table[k]["value"] <= table[k]["limit"], table


def test_half_batch_is_not_correct(monkeypatch):
    _broken(monkeypatch, _half_left_out)
    ok, _, table = _run(_tiny.cell(CELL))
    assert not ok
    assert all(v["value"] == math.inf for v in table.values()), table


def test_label_gap_takes_ties_either_way():
    val = torch.tensor([[[3.0, 2.0], [1.0, 1.0], [5.0, 4.0]]])
    idx = torch.tensor([[[4, 2], [0, 6], [1, 3]]])
    assert seg_check.label_gap(torch.tensor([[4, 0, 1]]), val, idx) == 0.0
    assert seg_check.label_gap(torch.tensor([[4, 6, 1]]), val, idx) == 0.0
    assert seg_check.label_gap(torch.tensor([[2, 0, 1]]), val, idx) == 1.0
    assert seg_check.label_gap(torch.tensor([[4, 0, 0]]), val, idx) == \
        math.inf


def test_flops_equal_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    import rscotr_tpu_torch.ops  # noqa: F401  (K1 / K2 formulas)
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    cfg = _tiny.config(CELL)["model"]
    model = build_model(cfg, device="cpu").requires_grad_(False)
    fn = make_infer_steps(model)["seg"]
    x = torch.zeros(2, 96, 64, 3, dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        fn(x)
    flops, calls = m2f_counts.seg(cfg, 2, 96, 64)
    assert flops == fc.get_total_flops()
    assert len(calls["window_attn_fwd"]) == sum(cfg["backbone"]["depths"])
    assert len(calls["msda_fwd"]) == cfg["encoder"]["num_layers"]
    assert {c["n"] for c in calls["window_attn_fwd"]} == {144}


def test_full_size_request_counts():
    """The cell's request: about 0.8 TFLOP a 640^2 tile (Swin-L most of
    it), 24 K2 calls of 144 tokens at head width 32 and 6 K1 calls."""
    cell = harness.load_cell(harness.load_bench(), CELL)
    flops, calls = seg_check.count(cell.config["model"], cell.traffic)
    assert 0.7e12 < flops / 16 < 0.9e12
    k2 = calls["window_attn_fwd"]
    assert len(k2) == 24 and {(c["n"], c["hd"]) for c in k2} == {(144, 32)}
    assert [c["nW"] for c in k2[:2]] == [196, 196]
    assert len(calls["msda_fwd"]) == 6


def _request(t0):
    return [(t0 + 0.5, t0 + 9.5, "rscotr.request.seg"),
            (t0 + 0.6, t0 + 1.0, "rscotr.input"),
            (t0 + 1.0, t0 + 4.0, "rscotr.backbone"),
            (t0 + 4.0, t0 + 6.0, "rscotr.seg.pixel_decoder"),
            (t0 + 4.5, t0 + 5.5, "rscotr.encoder"),
            (t0 + 6.0, t0 + 8.0, "rscotr.seg.decoder"),
            (t0 + 8.0, t0 + 9.0, "rscotr.seg.semantic"),
            (t0 + 9.0, t0 + 9.4, "rscotr.seg.semantic")]


def _device(t0):
    # idle inside: [4.0, 4.2] pixel decoder, [5.0, 5.5] encoder, [5.5, 6]
    # pixel decoder, [7, 8] decoder, [8.5, 9.4] semantic
    return [(t0 + 0.0, t0 + 4.0, "void swin_kernel"),
            (t0 + 4.2, t0 + 5.0, "window_attn_tc144_kernel<false>"),
            (t0 + 6.0, t0 + 7.0, "gemm"), (t0 + 8.0, t0 + 8.5, "bmm"),
            (t0 + 9.4, t0 + 10.0, "copy")]


def _trace_run(n=2, host=None, kernel_calls=None):
    host = host if host is not None else \
        [s for i in range(n) for s in _request(10.0 * i)]
    dev = [d for i in range(n) for d in _device(10.0 * i)]
    return SimpleNamespace(
        kind="infer", traced_requests=n, requests=4, window_s=2.0,
        flops_per_request=4.945e12, device_name="NVIDIA H100 80GB HBM3",
        kernel_calls=kernel_calls or {},
        trace=Trace(0.0, 10.0 * n, dev, host))


def test_stage_idle_readers_on_a_synthetic_trace():
    run = _trace_run()
    got = {m: harness.reader(m)(run) for m in NEW[3:]}
    assert math.isclose(got["seg_pixdec_idle_ms.infer"], 1e3 * (0.2 + 0.5 +
                                                                0.5))
    assert math.isclose(got["seg_decoder_idle_ms.infer"], 1e3 * 1.0)
    assert math.isclose(got["seg_semantic_idle_ms.infer"], 1e3 * 0.9)
    host = [s for s in _request(0.0) if s[2] != "rscotr.request.seg"]
    assert all(harness.reader(m)(_trace_run(1, host)) is None
               for m in NEW[3:])


def test_share_readers_on_a_synthetic_trace():
    run = _trace_run()
    idle = harness.reader("seg_idle_pct.infer")(run)
    assert math.isclose(idle, 100.0 * (1 - 2 * 6.9 / 20.0))
    mfu = harness.reader("seg_mfu_pct.infer")(run)
    assert math.isclose(mfu, 100.0 * 4.945e12 * 4 / 2.0 / 989e12)
    roof = harness.reader("winattn144_roofline.infer")
    assert roof(run) is None                          # no calls counted
    call = dict(B=16, nW=196, H=6, n=144, hd=32, masked=True)
    got = roof(_trace_run(kernel_calls={"window_attn_fwd": [call]}))
    from bench_h100.counts import kernels
    bound = kernels.bound_s(*kernels.window_attn_fwd(**call), 989e12,
                            3.35e12)
    assert math.isclose(got, 100.0 * bound * 2 / (2 * 0.8))
    # the n <= 64 bodies' names do not count as the long-window body's
    run = _trace_run(kernel_calls={"window_attn_fwd": [call]})
    run.trace.device = [(a, b, "window_attn_tc_kernel<32, false>")
                        for a, b, _ in run.trace.device]
    assert roof(run) is None


def test_traced_run_reads_the_span_metrics():
    """The serve driver's traced run on the CPU: the stage metrics the
    program's spans feed are finite; the device ones have no device."""
    ok, run, _ = _run(_tiny.cell(CELL), trace=1, seconds=0.0)
    assert ok and run.trace is not None
    got = harness.read_metrics([{"name": m, "unit": "x"} for m in NEW], run)
    assert {"seg_pixdec_idle_ms.infer", "seg_decoder_idle_ms.infer",
            "seg_semantic_idle_ms.infer", "seg_idle_pct.infer"} <= set(got)
    assert "winattn144_roofline.infer" not in got
    assert all(got[m]["value"] > 0 for m in got)


def test_cell_lists_only_its_own_per_layer_metrics():
    bench = harness.load_bench()
    per = [m["name"] for m in harness.cell_metrics(bench, CELL, True)]
    assert sorted(per) == sorted(NEW)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
        else:
            assert CELL not in m["workloads"]
    e2e = [m["name"] for m in harness.cell_metrics(bench, CELL, False)]
    assert e2e == ["infer_img_s", "request_ms_p95", "setup_s"]


def test_reference_reads_every_weight_of_the_full_model():
    from rscotr_tpu_torch.models import build_model
    from bench_h100.reference import mask2former as ref
    cfg = harness.load_cell(harness.load_bench(), CELL).config["model"]
    model = build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == ref.parameter_shapes(cfg)
    assert sum(int(np.prod(s)) for s in got.values()) == 215_488_779
