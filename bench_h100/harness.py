"""What every cell shares: finding its files by name, the window's
statistics, the metric readers, the checks and the result line.

A cell ``<name>`` of ``BENCHMARK.json`` has ``workloads/<name>.json`` (its
driver, check and limits), its configuration ``configs/<config>.json`` and
its traffic ``traffic/<traffic>.json``; every metric ``<metric>`` has a
reader ``metrics/<metric>.py`` with ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rscotr_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(bench: dict, name: str) -> SimpleNamespace:
    """The cell's entry, workload file, configuration and traffic."""
    entry = cell_entry(bench, name)
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return SimpleNamespace(
        name=name, entry=entry,
        workload=load_json(BENCH_DIR / "workloads" / f"{name}.json"),
        config=load_json(ROOT / cfg["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"))


def cell_metrics(bench: dict, name: str, trace: bool):
    """The metrics a run of the cell reports: with ``trace`` the per-layer
    ones that list the cell, else the end-to-end ones that list it (or
    list no cells)."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in cell_metrics(bench, name, False)}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e
                             else [])]


def reader(metric: str):
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_h100_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics, run) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        val = reader(m["name"])(run)
        if val is None:
            continue
        val = float(val)
        if not math.isfinite(val):
            continue
        out[m["name"]] = {"value": val, "unit": m["unit"]}
    return out


def percentile(values, q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def roofline_share(run, calls_key, count, names):
    """A kernel's share of its roofline: the analytic bound of the traced
    requests' calls (``count(**shape) -> (flops, bytes)``, at the card's
    peaks) over the profiled time of the device operations whose names
    contain one of ``names``. None when the trace has none of them."""
    from bench_h100.counts import kernels, peaks
    if run.trace is None or not run.traced_requests:
        return None
    pf, pb = peaks.flops(run.device_name), peaks.bytes_s(run.device_name)
    calls = run.kernel_calls.get(calls_key, [])
    measured = run.trace.kernel_s(names)
    if pf is None or not calls or not measured:
        return None
    bound = sum(kernels.bound_s(*count(**c), pf, pb) for c in calls)
    return 100.0 * bound * run.traced_requests / measured


def check(name: str):
    return importlib.import_module(f"bench_h100.checks.{name}")


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {"value", "limit"}}); a number missing or not
    finite fails."""
    table, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        good = math.isfinite(v) and v <= lim
        ok = ok and good
        table[k] = {"value": v, "limit": lim}
    return ok, table


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def cache_dirs(root: Path = ROOT) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths. The program builds its kernels under ``build/rscotr_tpu_torch``
    itself."""
    base = root / "build" / "bench_h100"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")


def result_line(correct: bool, run, metrics: Dict[str, dict],
                checks: Dict[str, dict], trace: bool) -> dict:
    dev = {"platform": "gpu", "kind": run.device_name, "count": 1,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if trace:
        dev["busy_s"] = run.trace.busy_s() if run.trace else None
        dev["window_s"] = run.trace.window_s if run.trace else None
    line = {"correct": bool(correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps(10)]}
    line["checks"] = checks
    return line
