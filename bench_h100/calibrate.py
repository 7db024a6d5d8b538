"""Readings that the limits of ``correct`` are set from, on the card::

    python3 -m bench_h100.calibrate --workload NAME --seeds S1,S2,... \
        [--control-seeds C1,C2,...] [--seconds 3] [--flops]

For each seed, one short run of the cell through the harness's own driver
(the timed entry at the cell's sizes and load), its compared numbers; for
each control seed the same run, and then the control: the plain
reference in the program's place in float8 (``checks/<check>.py``
``reference(..., "fp8")``) on the same sampled requests, judged by the
same comparison and the cell's limits (``control_correct`` has to come
out false; the command exits 1 if it does not). ``--flops`` also counts
one request under ``FlopCounterMode`` beside the check module's analytic
count. One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench_h100 import harness, traffic as traffic_mod, weights


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def control_numbers(cell, seed, run, device):
    import torch
    tr, mcfg = cell.traffic, cell.config["model"]
    reqs = traffic_mod.pool(tr, seed, device)
    from rscotr_tpu_torch.models import build_model
    shapes = [(n, tuple(p.shape)) for n, p in build_model(
        mcfg, tasks=(tr["entry"],), device="meta").named_parameters()]
    P = weights.make(shapes, seed, device)
    chk = harness.check(cell.workload["check"])
    numbers = {}
    for idx in run.checked:
        imgs = torch.from_numpy(reqs[idx % len(reqs)]).to(device)
        with torch.no_grad():
            outs = chk.reference(imgs, P, mcfg, "fp8", tr)
            got = chk.compare(imgs, {k: v.cpu() for k, v in outs.items()},
                              P, mcfg, tr)
        numbers = {k: max(numbers.get(k, 0.0), v) for k, v in got.items()}
    return numbers


def flop_check(cell, device):
    from torch.utils.flop_counter import FlopCounterMode
    import rscotr_tpu_torch.ops  # noqa: F401  (registers K1/K2 formulas)
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    tr, mcfg = cell.traffic, cell.config["model"]
    chk = harness.check(cell.workload["check"])
    model = build_model(mcfg, tasks=(tr["entry"],), device=device)
    # the counter's module tracker hooks inputs that need gradients, which
    # fails under inference_mode
    model.requires_grad_(False)
    fn = make_infer_steps(model, max_per_img=tr.get("max_per_img", 300))[
        tr["entry"]]
    call = chk.prepare(model, fn, tr, {"on": False, "out": None})
    x = traffic_mod.pool(dict(tr, pool=1), 0, device)[0]
    call(x)
    with FlopCounterMode(display=False) as fc:
        call(x)
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    return {"flop_counter": fc.get_total_flops(),
            "analytic": chk.count(mcfg, tr)[0], "by_op": by_op}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--flops", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    harness.cache_dirs()
    from bench_h100 import run as brun
    cell = harness.load_cell(harness.load_bench(), a.workload)
    if a.flops:
        print(json.dumps({"workload": a.workload, **flop_check(cell,
                                                                a.device)}))
    rc = 0
    for seed in sorted(set(a.seeds) | set(a.control_seeds)):
        t = time.perf_counter()
        ok, run, table = brun.run_cell(cell, seed, a.seconds, False,
                                       a.device, t)
        rec = {"workload": a.workload, "seed": seed, "correct": ok,
               "program": run.numbers, "requests": run.requests}
        if seed in a.control_seeds:
            rec["control"] = control_numbers(cell, seed, run, a.device)
            rec["control_correct"] = harness.judge(
                rec["control"], cell.workload["limits"])[0]
            rc = 1 if rec["control_correct"] else rc
        print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
