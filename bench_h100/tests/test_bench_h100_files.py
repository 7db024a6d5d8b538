"""The benchmark is found from its files alone: every cell, configuration,
traffic mix and metric of BENCHMARK.json by its name, and the file keeps
to its format: names, units, bounds, run length, each cell's metrics."""

import importlib
import json
import math
import re

import pytest

from bench_h100 import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.load_cell(BENCH, name)
    importlib.import_module(f"bench_h100.drivers.{cell.workload['driver']}")
    chk = harness.check(cell.workload["check"])
    assert callable(chk.compare) and callable(chk.reference)
    assert cell.workload["limits"]
    assert cell.traffic["kind"] == "closed_loop"
    assert cell.config["model"]["type"] == "MTL"


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["bench_h100"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] +
             METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_bounds_and_run_length():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    t = BENCH["run_seconds"]
    assert 1 <= t <= 51 and t == int(t)
    assert (2 + 14 * 24) * (t + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(name):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.cell_metrics(BENCH, name, True)
    assert per
    assert all(m["moves"] in e2e for m in per)


def test_per_layer_keys():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_result_line_keys_and_order():
    from types import SimpleNamespace
    from bench_h100.trace import Trace
    run = SimpleNamespace(device_name="NVIDIA H100 80GB HBM3",
                          memory_peak_bytes=1 << 30, attempted=3, failed=0,
                          trace=Trace(0.0, 1.0, [(0.1, 0.3, "k")],
                                      [(0.0, 1.0, "aten::mm")]))
    ok, table = harness.judge({"gap": 0.5}, {"gap": 1.0})
    line = harness.result_line(ok, run, {"x": {"value": 1.0, "unit": "s"}},
                               table, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s",
                                   "window_s"}
    assert line["correct"] is True
    assert line["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
    assert math.isclose(line["device"]["busy_s"], 0.2)
    line0 = harness.result_line(ok, run, {}, table, trace=False)
    assert list(line0) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]


def test_judge_fails_a_missing_or_nan_number():
    assert harness.judge({"a": 0.1}, {"a": 1.0, "b": 1.0})[0] is False
    assert harness.judge({"a": float("nan")}, {"a": 1.0})[0] is False
    assert harness.judge({"a": 2.0}, {"a": 1.0})[0] is False
