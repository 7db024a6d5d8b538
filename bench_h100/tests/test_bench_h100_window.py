"""The window's statistics: a rate is all the work over all the time, a
tail is the tail of every request, and the trace's busy time is the union
of the device's intervals."""

import math
from types import SimpleNamespace

import numpy as np

from bench_h100 import harness
from bench_h100.trace import Trace, union_length


def _run(lat, batch=16, issue=None):
    return SimpleNamespace(kind="infer", requests=len(lat),
                           images=batch * len(lat), window_s=sum(lat),
                           latencies=lat, issue=issue or lat, setup_s=7.0,
                           trace=None, traced_requests=0,
                           device_name="NVIDIA H100 80GB HBM3",
                           flops_per_request=1e12, kernel_calls={},
                           window_peak_bytes=3 << 30)


def test_rate_counts_every_request_and_a_stall():
    lat = [0.1] * 99 + [2.0]
    r = harness.reader("infer_img_s")(_run(lat))
    assert math.isclose(r, 16 * 100 / (9.9 + 2.0))


def test_p95_is_over_every_request():
    lat = [0.1] * 90 + [1.0] * 10
    got = harness.reader("request_ms_p95")(_run(lat))
    assert math.isclose(got, 1e3 * float(np.percentile(lat, 95)))
    assert got == 1000.0


def test_issue_median_setup_memory_and_mfu():
    lat = [0.1, 0.2, 0.3]
    run = _run(lat, issue=[0.01, 0.05, 0.02])
    assert math.isclose(harness.reader("issue_ms.infer")(run), 20.0)
    assert harness.reader("setup_s")(run) == 7.0
    assert harness.reader("peak_mem_gib.infer")(run) == 3.0
    mfu = harness.reader("mfu_pct.infer")(run)
    assert math.isclose(mfu, 100 * 3e12 / 0.6 / 989e12)


def test_union_counts_overlap_once():
    assert math.isclose(union_length([(0, 2), (1, 3), (5, 6)]), 4.0)
    tr = Trace(0.0, 10.0, [(0, 2, "a"), (1, 3, "copy"), (5, 6, "a")],
               [(0.0, 10.0, "outer"), (3.5, 4.5, "aten::inner")])
    assert math.isclose(tr.busy_s(), 4.0)
    assert math.isclose(tr.kernel_s(["a"]), 3.0)
    assert tr.kernel_s(["none"]) is None
    assert tr.top_ops(1) == [("a", 3.0)]
    gaps = tr.idle_gaps(2)
    assert gaps[0] == ("outer", 4.0) and gaps[1] == ("aten::inner", 2.0)
    idle = harness.reader("device_idle_pct.infer")(
        SimpleNamespace(kind="infer", trace=tr))
    assert math.isclose(idle, 60.0)


def test_roofline_needs_its_kernels_in_the_trace():
    run = _run([0.1])
    read = harness.reader("msda_roofline.infer")
    assert read(run) is None
    call = dict(B=1, Q=100, Nv=100, H=8, D=32, L=4, P=4)
    run.kernel_calls = {"msda_fwd": [call]}
    run.trace = Trace(0.0, 1.0, [(0.0, 1e-3, "void msda_fwd_vec_kernel<>")],
                      [])
    run.traced_requests = 2
    from bench_h100.counts import kernels
    want = 100 * 2 * kernels.bound_s(*kernels.msda_fwd(**call), 989e12,
                                      3.35e12) / 1e-3
    assert math.isclose(read(run), want)
    run.trace = Trace(0.0, 1.0, [(0.0, 1e-3, "elementwise")], [])
    assert read(run) is None
