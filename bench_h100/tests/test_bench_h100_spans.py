"""The readers of the program's stage spans (``spans.py``): device-idle
time put down to the innermost span only, host synchronisations counted
inside a request span only, means over the traced requests, and nothing
read from a trace without the program's spans. Hand-built traces, then
the serve driver's traced run on the tiny cells on the CPU."""

import math
from types import SimpleNamespace

import pytest

from bench_h100 import harness, run as brun, spans
from bench_h100.tests import _tiny
from bench_h100.trace import Trace

NEW = ("input_ms.infer", "host_syncs.infer", "backbone_idle_ms.infer",
       "encoder_idle_ms.infer", "dethead_idle_ms.infer")
SYNC = "cudaStreamSynchronize"


def _request(t0):
    """One det request from ``t0``: its spans (the neck nested in the
    backbone), an aten op and a sync inside, the read-back's sync after."""
    return [(t0 + 0.5, t0 + 9.5, "rscotr.request.det"),
            (t0 + 0.6, t0 + 1.5, "rscotr.input"),
            (t0 + 0.7, t0 + 0.8, SYNC),
            (t0 + 1.5, t0 + 6.0, "rscotr.backbone"),
            (t0 + 2.5, t0 + 3.5, "rscotr.neck"),
            (t0 + 3.0, t0 + 3.2, "aten::mm"),
            (t0 + 6.0, t0 + 8.0, "rscotr.encoder"),
            (t0 + 7.0, t0 + 7.1, "cudaDeviceSynchronize"),
            (t0 + 8.0, t0 + 9.0, "rscotr.det.decoder"),
            (t0 + 9.0, t0 + 9.4, "rscotr.det.boxes"),
            (t0 + 9.6, t0 + 9.7, SYNC)]


def _device(t0):
    return [(t0 + 1, t0 + 2, "k"), (t0 + 4, t0 + 5, "k"),
            (t0 + 4.5, t0 + 5.5, "copy"), (t0 + 7, t0 + 7.5, "k")]


def _run(n=1, host=None):
    host = host if host is not None else \
        [s for i in range(n) for s in _request(10.0 * i)]
    dev = [d for i in range(n) for d in _device(10.0 * i)]
    return SimpleNamespace(kind="infer", traced_requests=n,
                           trace=Trace(0.0, 10.0 * n, dev, host))


def test_idle_goes_to_the_innermost_span_once():
    # idle: [0, 1], [2, 4], [5.5, 7], [7.5, 10]
    by = spans.idle_by_stage(_run().trace)
    want = {"rscotr.request.det": 0.1 + 0.1, "rscotr.input": 0.4,
            "rscotr.backbone": 0.5 + 0.5 + 0.5, "rscotr.neck": 1.0,
            "rscotr.encoder": 1.0 + 0.5, "rscotr.det.decoder": 1.0,
            "rscotr.det.boxes": 0.4}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert math.isclose(by[k], v), (k, by[k])
    # the rest of the window's idle time lies outside every span
    total = sum(b - a for a, b in spans.idle(_run().trace))
    assert math.isclose(total, 1 + 2 + 1.5 + 2.5)
    assert math.isclose(total - sum(by.values()), 0.5 + 0.5)


def test_stage_readers_are_means_over_the_requests():
    for n in (1, 3):
        run = _run(n)
        got = {m: harness.reader(m)(run) for m in NEW}
        assert math.isclose(got["backbone_idle_ms.infer"], 1500.0)
        assert math.isclose(got["encoder_idle_ms.infer"], 1500.0)
        assert math.isclose(got["dethead_idle_ms.infer"], 1400.0)
        assert math.isclose(got["input_ms.infer"], 900.0)
        assert got["host_syncs.infer"] == 2.0


def test_syncs_outside_a_request_are_not_counted():
    host = _request(0.0) + [(0.1, 0.2, SYNC),
                            (9.8, 9.9, "cudaEventSynchronize"),
                            (5.0, 5.1, "cudaMemcpyAsync")]
    assert harness.reader("host_syncs.infer")(_run(host=host)) == 2.0
    host = [s for s in _request(0.0) if "Synchronize" not in s[2]]
    assert harness.reader("host_syncs.infer")(_run(host=host)) == 0.0


def test_spans_that_end_together_are_not_counted_twice():
    tr = Trace(0.0, 4.0, [], [(0.0, 4.0, "rscotr.request.cls"),
                              (1.0, 4.0, "rscotr.backbone"),
                              (3.0, 4.0, "rscotr.cls_head")])
    assert spans.idle_by_stage(tr) == {"rscotr.request.cls": 1.0,
                                       "rscotr.backbone": 2.0,
                                       "rscotr.cls_head": 1.0}


@pytest.mark.parametrize("metric", NEW)
def test_nothing_is_read_without_the_programs_spans(metric):
    read = harness.reader(metric)
    host = [s for s in _request(0.0) if not s[2].startswith("rscotr.")]
    assert read(_run(host=host)) is None
    assert read(SimpleNamespace(kind="infer", trace=None)) is None
    # stage spans without a request span (the seg entry) are not a request
    host = [s for s in _request(0.0) if s[2] != "rscotr.request.det"]
    assert read(_run(host=host)) is None
    assert spans.idle_by_stage(Trace(0.0, 1.0, [], [])) is None


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_traced_run_reads_every_span_metric_of_the_cell(name):
    """The serve driver's traced run on the CPU: each new metric the cell
    lists is finite; on the CPU the device list is empty, so idle is the
    whole window and no host call waits for a card. A window of 0 s
    traces from the first request."""
    ok, run, _ = brun.run_cell(_tiny.cell(name), 2 ** 31 + 11, 0.0, 1,
                               device="cpu", t0=0.0)
    assert ok and run.trace is not None
    listed = [m["name"] for m in
              harness.cell_metrics(harness.load_bench(), name, True)
              if m["name"] in NEW]
    got = harness.read_metrics(
        [{"name": m, "unit": "x"} for m in listed], run)
    assert sorted(got) == sorted(listed)
    assert got["host_syncs.infer"]["value"] == 0.0
    assert got["input_ms.infer"]["value"] > 0
    assert got["backbone_idle_ms.infer"]["value"] > 0
    reqs = [s for s in spans.spans(run.trace)
            if s[2].startswith(spans.REQUEST)]
    assert len(reqs) == run.traced_requests
