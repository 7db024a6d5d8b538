"""Run one cell of the benchmark once::

    python3 bench_h100/run.py --workload NAME --seed N --seconds S --trace 0|1

(or ``python3 -m bench_h100.run ...``) from the root of a checkout. The
last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit, which also end
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_h100 import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed, seconds, trace, device="cuda", t0=None):
    """Drive the cell, judge its outputs -> (correct, run, checks)."""
    import importlib
    driver = importlib.import_module(
        f"bench_h100.drivers.{cell.workload['driver']}")
    run = driver.run(cell, seed, seconds, bool(trace), device,
                     T0 if t0 is None else t0)
    ok, table = harness.judge(run.numbers, cell.workload["limits"])
    return ok and run.failed == 0, run, table


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs()
    bench = harness.load_bench()
    cell = harness.load_cell(bench, args.workload)
    import torch
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench_h100: the cell needs {need} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    ok, run, table = run_cell(cell, args.seed, args.seconds, args.trace)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench_h100: loaded {bad} in the measuring process",
              file=sys.stderr)
        return 3
    metrics = harness.read_metrics(
        harness.cell_metrics(bench, args.workload, bool(args.trace)), run)
    line = harness.result_line(ok, run, metrics, table, bool(args.trace))
    for k, v in table.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
