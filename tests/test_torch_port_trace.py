"""The port's stage spans (``rscotr_tpu_torch/utils/trace.py``) on the tiny
synthetic MTL through ``make_infer_steps``, under a CPU ``torch.profiler``:
every span of a request in its nesting and order, each a host ``cpu_op``
and no user annotation (which the profiler would copy onto the device
timeline), outputs bit-equal with and without the profiler, and a
``torch.export`` of the steps, or a ``torch.compile`` graph, that carries
no span."""

import contextlib
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rscotr_tpu_torch.engine import make_infer_steps
from rscotr_tpu_torch.export import export_inference, graph_ops
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils import trace
from rscotr_tpu_torch.utils.config import load_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")

# (span, depth) in order: the request's stages nest one level under it
STAGES = {
    "cls": [(trace.REQUEST_CLS, 0), (trace.INPUT, 1), (trace.BACKBONE, 1),
            (trace.CLS_HEAD, 1)],
    "det": [(trace.REQUEST_DET, 0), (trace.INPUT, 1), (trace.BACKBONE, 1),
            (trace.NECK, 1), (trace.DET_EMBED, 1), (trace.ENCODER, 1),
            (trace.DET_SELECT, 1), (trace.DET_DECODER, 1),
            (trace.DET_BOXES, 1)],
    "seg": [(trace.INPUT, 0), (trace.BACKBONE, 0), (trace.NECK, 0)],
}


@pytest.fixture(scope="module")
def tiny():
    cfg = load_cfg(TINY)
    torch.manual_seed(0)
    model = build_model(cfg["model"], device="cpu").eval()
    steps = make_infer_steps(model, max_per_img=50)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    det = rng.integers(0, 256, (1, 128, 128, 3)).astype(np.uint8)
    args = {"cls": (img,), "seg": (img,),
            "det": (det, np.array([[128, 100]], np.int64))}
    return model, steps, args


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


def _spans(prof):
    """The port's spans of a profile as [(name, depth)] in start order,
    and their events."""
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("rscotr.")),
                 key=lambda e: (e.start_ns(), -e.duration_ns()))
    out, open_ends = [], []
    for e in evs:
        while open_ends and open_ends[-1] <= e.start_ns():
            open_ends.pop()
        out.append((e.name(), len(open_ends)))
        open_ends.append(e.start_ns() + e.duration_ns())
    return out, evs


@pytest.mark.parametrize("task", sorted(STAGES))
def test_spans_nest_in_order_as_host_ops(tiny, task):
    _, steps, args = tiny
    plain = _flat(steps[task](*args[task]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _flat(steps[task](*args[task]))
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    got, evs = _spans(prof)
    assert got == STAGES[task]
    for e in evs:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation(), e.name()


def test_span_names_and_kind():
    names = [v for k, v in vars(trace).items() if k.isupper()]
    assert len(names) == len(set(names)) == 11
    assert all(n.startswith("rscotr.") for n in names)
    assert {n for task in STAGES for n, _ in STAGES[task]} == set(names)
    # the record_function annotation the spans avoid is a user annotation
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("annotation"):
            pass
        with trace.span("rscotr.x"):
            pass
    kinds = {e.name(): e.is_user_annotation()
             for e in prof.profiler.kineto_results.events()}
    assert kinds == {"annotation": True, "rscotr.x": False}


def test_exported_steps_carry_no_span(tiny):
    model, steps, args = tiny
    progs = export_inference(model, {"cls": {"bs": 1, "size": 64}},
                             tasks=("cls",), max_per_img=50,
                             img_dtype=torch.uint8)
    ops = graph_ops(progs["cls"])
    assert not any("profiler" in t or "record_function" in t for t in ops)
    # exporting left the live steps' spans as they were
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps["cls"](*args["cls"])
    assert _spans(prof)[0] == STAGES["cls"]


@pytest.mark.cuda
def test_spans_have_no_device_copy_on_card():
    """On the card the profiler copies a user annotation onto the device
    timeline; the spans stay host ops, so a device trace holds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device timeline)")
    cfg = load_cfg(TINY)
    model = build_model(cfg["model"], tasks=("det",), device="cuda").eval()
    step = make_infer_steps(model, max_per_img=50)["det"]
    img = np.zeros((1, 128, 128, 3), np.uint8)
    hw = np.array([[128, 128]], np.int64)
    step(img, hw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(img, hw)
        torch.cuda.synchronize()
    got, _ = _spans(prof)
    assert got == STAGES["det"]
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.profiler.kineto_results.events()
    assert any(e.device_type() == cuda for e in evs)
    assert not [e.name() for e in evs
                if e.device_type() == cuda and "rscotr." in e.name()]


def test_no_span_while_compiling_or_exporting(monkeypatch):
    def f(x):
        with trace.span(trace.BACKBONE):
            return x + 1

    # dynamo cannot trace the span's constructor: a full graph needs the
    # null context
    g = torch.compile(f, backend="eager", fullgraph=True)
    assert torch.equal(g(torch.ones(3)), torch.full((3,), 2.0))
    assert not isinstance(trace.span("rscotr.x"), contextlib.nullcontext)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert isinstance(trace.span("rscotr.x"), contextlib.nullcontext)
