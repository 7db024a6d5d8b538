"""Serving driver: one client in a closed loop calls a serving entry of
``rscotr_tpu_torch.engine.infer.make_infer_steps`` and waits for each
answer on the host before it sends the next request.

What is particular to an entry (its call, its read-back, a hook on the
head, its FLOPs) comes from the cell's check module (``checks/<check>.py``).

Set-up, timed by stages on standard error: imports, the CUDA context, the
model of the cell's configuration (only the entry's head), weights from
the seed (``weights.py``), the requests' pixels from the seed
(``traffic.py``), ``warmup`` requests of the cell's one shape. The window
opens after a synchronise and closes at the first answer after
``seconds``. A request's time runs from the call into the entry until its
outputs are on the host; its issue time until the entry returns. With a
trace, ``trace_requests`` requests from a third of the way into the window
run under the profiler. After the window the program's state is freed and
the sampled requests' outputs are compared with the plain reference
(``checks/<check>.py``), fed the same pixels and weights made again from
the seed.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from types import SimpleNamespace

from bench_h100 import traffic as traffic_mod
from bench_h100 import harness, trace as trace_mod, weights


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def run(cell, seed, seconds, trace, device, t0):
    stages = [("start", t0)]
    import torch
    from rscotr_tpu_torch.engine import infer
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.ops.window_attention import window_attention
    stages.append(("imports", time.perf_counter()))

    tr, mcfg = cell.traffic, cell.config["model"]
    task = tr["entry"]
    chk = harness.check(cell.workload["check"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
        sync()
    stages.append(("device", time.perf_counter()))
    model = build_model(mcfg, tasks=(task,), device=dev)
    stages.append(("build", time.perf_counter()))
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    weights.load(model, weights.make(shapes, seed, dev))
    sync()
    stages.append(("weights", time.perf_counter()))
    fn = infer.make_infer_steps(model, max_per_img=tr.get("max_per_img",
                                                          300))[task]
    reqs = traffic_mod.pool(tr, seed, dev)
    stages.append(("inputs", time.perf_counter()))
    keep = {"on": False, "out": None}
    call = chk.prepare(model, fn, tr, keep)
    to_host = chk.to_host

    for i in range(int(tr.get("warmup", 3))):
        to_host(call(reqs[i % len(reqs)]))
    sync()
    stages.append(("warmup", time.perf_counter()))
    sample = set(traffic_mod.sample(tr, seed))
    kept = {}
    launches0 = (ms_deform_attn.launches, window_attention.launches)
    sync()
    pre_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lat, issue = [], []
    prof, profiling, traced = None, False, 0
    n_trace = int(tr.get("trace_requests", 8))
    t_open = time.perf_counter()
    setup_s = t_open - t0
    i = 0
    while True:
        if trace and prof is None and \
                time.perf_counter() - t_open >= seconds / 3:
            prof = trace_mod.profiler()
            prof.start()
            rf = torch.profiler.record_function(trace_mod.WINDOW)
            rf.__enter__()
            profiling = True
        keep["on"] = i in sample
        x = reqs[i % len(reqs)]
        a = time.perf_counter()
        out = call(x)
        b = time.perf_counter()
        host = to_host(out)
        c = time.perf_counter()
        lat.append(c - a)
        issue.append(b - a)
        if keep["on"]:
            if keep["out"] is not None:
                host.update({k: v.cpu() for k, v in keep["out"].items()})
            kept[i] = host
            keep["out"] = None
        i += 1
        if profiling:
            traced += 1
            if traced == n_trace:
                rf.__exit__(None, None, None)
                prof.stop()
                profiling = False
        if c - t_open >= seconds and not profiling:
            break
    t_close = c
    launches = (ms_deform_attn.launches - launches0[0],
                window_attention.launches - launches0[1])
    win_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    tr_read = trace_mod.read(prof) if prof is not None else None
    flops, calls = chk.count(mcfg, tr)
    # the window is closed: free the program's state, then judge
    del model, fn, call, out, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    P = weights.make(shapes, seed, dev)
    numbers = {}
    for idx, outs in kept.items():
        imgs = torch.from_numpy(reqs[idx % len(reqs)]).to(dev)
        with torch.no_grad():
            got = chk.compare(imgs, outs, P, mcfg, tr)
        numbers = {k: max(numbers.get(k, 0.0), v) for k, v in got.items()}
    if not kept:
        numbers = {k: float("nan") for k in cell.workload["limits"]}
    n = len(lat)
    print(f"bench_h100: {cell.name}: {n} requests in {t_close - t_open:.3f}"
          f" s, setup {setup_s:.3f} s; launches in the window K1 "
          f"{launches[0]} K2 {launches[1]}; {n_trace if trace else 0} "
          f"traced; card {_power_limit() if cuda else 'cpu'}; set-up "
          + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b) in
                      zip(stages, stages[1:])),
          file=sys.stderr)
    return SimpleNamespace(
        kind="infer", setup_s=setup_s, window_s=t_close - t_open,
        requests=n, images=n * int(tr["batch"]), latencies=lat, issue=issue,
        attempted=n, failed=0, trace=tr_read, traced_requests=traced,
        flops_per_request=flops, kernel_calls=calls,
        device_name=device_name, window_peak_bytes=win_peak,
        memory_peak_bytes=max(pre_peak, win_peak), numbers=numbers,
        launches=launches, checked=sorted(kept))
