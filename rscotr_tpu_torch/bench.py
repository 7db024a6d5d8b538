"""Benchmark harness: the flagship MTL's throughput on one card (the
port's counterpart of the root ``bench.py``, with its keys)::

    python -m rscotr_tpu_torch.bench [--device cuda]

Prints ONE JSON line on stdout: ``{"metric": ..., "value": N, "unit":
"img/s", "vs_baseline": N, ...}``; its progress and the kernel launches per
inference call go to stderr.

Headline (``value``, ``train_s_per_iter``, ``vs_baseline``): the port's
``apis.train_model`` on ``configs/multi/MTL_synthetic_flagship_devaug.py``
(the host draws, uint8 to the card, the three on-device augment stages in
the steps, the grouped order of ``runner.steps_per_dispatch``) for
``RSCOTR_BENCH_TRAIN_ITERS`` iterations (default 160), without evaluation
or checkpoints, the log interval set to ``steps_per_dispatch``. The port's
``LogHook`` turns the steps' device scalars into floats at each log line,
which waits for the card, so each ``metrics.jsonl`` record's ``time``
covers the device work of its interval's same-task steps (with interval 1,
one step's). ``steady_state_mix`` (the root's function, copied) takes the
per-task means and the img/s is 19 images (16 cls + 1 det + 2 seg) per
three-step mix.

Inference fields: the root's inference config
(``MTL_slvlcls_swin-t-p4-w7_1x1_resisc_dior_potsdam.py``) with random
weights from a seeded generator, served through ``make_infer_steps(model,
max_per_img=300)`` on the root's inputs (float32 normal cls 16x224^2, det
1x800^2 with ``img_hw`` and ``scale_factor``, seg 2x512^2): per task
``WARMUP`` calls, then ``ITERS`` calls on distinct inputs.
``*_dispatch_ms`` is the wall time per call of those calls ended by a
sync, as the root's. The root's ``*_ms`` time the calls inside one jitted
``lax.scan``, which eager PyTorch has no counterpart of (the port's
``tools/benchmark.py`` refuses ``--scan`` for that reason): here
``*_ms`` is the profiler's device time per call (``torch.profiler``, the
device kernels and copies of ``ITERS`` more calls summed, over ``ITERS``),
as PERF.md's section 5 reads it; on the CPU the wall time per call.
``infer_img_s`` is 19 over the sum of the three ``*_ms``.

``unit_gflops`` and ``mfu``: ``FlopCounterMode`` over one call per task,
with the kernel operators' formulas (``ops/flops.py``), summed, and the
FLOPs over the three ``*_ms`` against ``PEAK_FLOPS`` keyed by the device's
name (``tools/benchmark.py``); ``mfu`` is None off the H100. The root's
FLOPs come from XLA's ``cost_analysis``, which also counts elementwise
work, so the two harnesses' FLOPs are not comparable.

``vs_baseline`` / ``infer_vs_baseline`` divide by the root's estimated A100
throughputs (``baseline_note``). The line is printed whatever the training
half does: a failure there gives ``train_bench_error`` and the inference
headline, as at the root. A failure of the inference half raises. There is
no fallback to the CPU: ``--device cpu`` is for the tests.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFG = "configs/multi/MTL_synthetic_flagship_devaug.py"
INFER_CFG = "configs/multi/MTL_slvlcls_swin-t-p4-w7_1x1_resisc_dior_potsdam.py"

# the root's estimated A100 (PyTorch, fp16) throughputs of the same mix:
# inference ~19 img/s, training ~31 img/s, from public figures (the
# reference publishes no throughput)
A100_BASELINE_IMG_S = 19.0
A100_TRAIN_BASELINE_IMG_S = 31.0
BASELINE_NOTE = ("A100 denominators are estimates from public figures "
                 "(reference publishes no throughput)")

CLS_BS, DET_BS, SEG_BS = 16, 1, 2
SIZES = {"cls": 224, "det": 800, "seg": 512}  # the root's input sides
WARMUP, ITERS = 3, 10
TASKS = ("cls", "det", "seg")


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def steady_state_mix(recs, compile_cutoff_s: float = 2.0):
    """(mix_seconds, per_task_means) from metrics.jsonl records.

    Records must be interval-aligned (log interval == steps_per_dispatch:
    each record covers one group of same-task steps). Per-task means over
    records below ``compile_cutoff_s`` drop one-time first-call costs
    without biasing the mix toward the faster tasks; returns (None,
    partial) when fewer than all three tasks produced records.
    """
    per_task = {}
    for r in recs:
        if "time" not in r:
            continue
        task = next((k.split(".")[0] for k in r
                     if "." in k and k.split(".")[0] in
                     ("cls", "det", "seg")), None)
        if task:
            per_task.setdefault(task, []).append(r["time"])
    means = {}
    for t, ts in per_task.items():
        clean = [x for x in ts if x < compile_cutoff_s] or ts
        means[t] = sum(clean) / len(clean)
    if len(means) != 3:
        return None, means
    return sum(means.values()), means


def _composed(path: str):
    """The composed config of a repo path, each dataset's file inlined."""
    from rscotr_tpu_torch.config import Config
    from rscotr_tpu_torch.data.build import load_data_cfg
    full = os.path.join(ROOT, path)
    return load_data_cfg(Config.fromfile(full).to_dict(), config_root=ROOT,
                         filename=full)


def train_headline(path: str, n_iters: int, device: str):
    """(img/s, s per iteration) of ``n_iters`` iterations of
    ``apis.train_model`` on ``path``."""
    from rscotr_tpu_torch.apis import train_model
    cfg = _composed(path)
    cfg["runner"]["max_iters"] = n_iters
    cfg["evaluation"] = dict(interval=10 ** 9)
    cfg["checkpoint_config"] = dict(interval=10 ** 9)
    k_disp = int((cfg.get("runner") or {}).get("steps_per_dispatch", 1))
    cfg["log_config"] = dict(interval=max(k_disp, 1))
    imgs_per_unit = CLS_BS + DET_BS + SEG_BS
    wd = tempfile.mkdtemp(prefix="bench_train_")
    try:
        t0 = time.perf_counter()
        train_model(cfg, wd, validate=False, num_devices=1, device=device)
        log(f"train_model {path}: {n_iters} iterations in "
            f"{time.perf_counter() - t0:.1f} s")
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            recs = [json.loads(x) for x in f if x.strip()]
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    mix_s, means = steady_state_mix(recs)
    if mix_s is not None:
        log(f"steady-state s per step {means}")
        return imgs_per_unit / mix_s, mix_s / 3.0
    # a degenerate run: the raw mean
    times = [r["time"] for r in recs if "time" in r]
    times = times[max(1, len(times) // 4):]
    s_iter = float(np.mean(times))
    return imgs_per_unit / (3.0 * s_iter), s_iter


def _inputs(device, sizes):
    """The root's inputs, float32 normal from seed 0, and ITERS variants
    of each (images + i * 1e-3), on ``device``."""
    g = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g)

    base = {
        "cls": (normal(CLS_BS, sizes["cls"], sizes["cls"], 3),),
        "det": (normal(DET_BS, sizes["det"], sizes["det"], 3),
                torch.tensor([[sizes["det"]] * 2] * DET_BS,
                             dtype=torch.int32),
                torch.ones(DET_BS, 4)),
        "seg": (normal(SEG_BS, sizes["seg"], sizes["seg"], 3),),
    }
    return {t: [tuple((a + np.float32(i) * 1e-3 if a.is_floating_point()
                       and a.dim() > 2 else a).to(device) for a in args)
                for i in range(ITERS)]
            for t, args in base.items()}


def _device_ms(fn, calls, device) -> float:
    """Device time per call over ``calls`` (the profiler's device kernels
    and copies); wall time per call on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for args in calls:
            fn(*args)
        return (time.perf_counter() - t0) / len(calls) * 1e3
    from torch.profiler import ProfilerActivity, profile

    from rscotr_tpu_torch.tools.profile_quad_seg import _dev_time
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args in calls:
            fn(*args)
        torch.cuda.synchronize(device)
    busy_us = sum(_dev_time(e) for e in prof.key_averages()
                  if getattr(e, "device_type", None) ==
                  torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return busy_us / 1e3 / len(calls)


def inference_fields(path: str, device, sizes) -> dict:
    """The root's inference keys: per task ms, dispatch ms and FLOPs, the
    img/s of the mix and its MFU."""
    from rscotr_tpu_torch.apis import derive_cls_hw
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.ops.window_attention import window_attention
    from rscotr_tpu_torch.tools.benchmark import count_flops, frozen, \
        peak_flops
    cfg = _composed(path)
    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(0),
                        cls_hw=derive_cls_hw(cfg))
    model.eval()
    infer = make_infer_steps(model, max_per_img=300)
    variants = _inputs(device, sizes)

    def sync(out):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    for _ in range(WARMUP):
        for t in TASKS:
            sync(infer[t](*variants[t][0]))
    task_ms, dispatch_ms, flops, launches = {}, {}, {}, {}
    for t in TASKS:
        before = (ms_deform_attn.launches, window_attention.launches)
        t0 = time.perf_counter()
        for args in variants[t]:
            out = infer[t](*args)
        sync(out)
        dispatch_ms[t] = (time.perf_counter() - t0) / ITERS * 1e3
        launches[t] = {"K1": (ms_deform_attn.launches - before[0]) / ITERS,
                       "K2": (window_attention.launches - before[1]) / ITERS}
        task_ms[t] = _device_ms(infer[t], variants[t], device)
        with frozen(model):
            flops[t] = count_flops(lambda: infer[t](*variants[t][0]))[1]
    log("launches per inference call " + json.dumps(launches))
    unit_s = sum(task_ms.values()) / 1e3
    img_s = (CLS_BS + DET_BS + SEG_BS) / unit_s
    unit_flops = sum(flops.values())
    peak = peak_flops(device)
    return dict(img_s=img_s, task_ms=task_ms, dispatch_ms=dispatch_ms,
                unit_flops=unit_flops,
                mfu=(unit_flops / unit_s) / peak if peak else None)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="The flagship MTL's training and inference throughput "
                    "(one JSON line)")
    ap.add_argument("--device", default="cuda",
                    help="where it runs (default: the card; cpu for tests)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (--device cpu is for tests)")
    train_img_s = train_s_iter = train_err = None
    # the training log (the port's logger writes to stdout) goes to stderr:
    # stdout carries the one line
    with contextlib.redirect_stdout(sys.stderr):
        try:
            n_iters = int(os.environ.get("RSCOTR_BENCH_TRAIN_ITERS", "160"))
            train_img_s, train_s_iter = train_headline(TRAIN_CFG, n_iters,
                                                       args.device)
        except Exception as e:  # noqa: BLE001 - the line comes regardless
            train_err = f"{type(e).__name__}: {e}"
            log(f"training half failed: {train_err}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        inf = inference_fields(INFER_CFG, device, SIZES)
    img_s, mfu = inf["img_s"], inf["mfu"]
    out = {
        "metric": "img/s/chip MTL production training wall-clock "
                  "(RESISC45+DIOR+Potsdam mix, devaug + K-scan defaults)",
        "unit": "img/s",
        "infer_img_s": round(img_s, 2),
        "infer_vs_baseline": round(img_s / A100_BASELINE_IMG_S, 3),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "unit_gflops": round(inf["unit_flops"] / 1e9, 1),
        **{f"{t}_ms": round(inf["task_ms"][t], 2) for t in TASKS},
        **{f"{t}_dispatch_ms": round(inf["dispatch_ms"][t], 2)
           for t in TASKS},
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "baseline_note": BASELINE_NOTE,
    }
    if train_img_s is not None:
        # the mix spans three iterations, one per task
        out["value"] = round(train_img_s, 2)
        out["vs_baseline"] = round(train_img_s / A100_TRAIN_BASELINE_IMG_S,
                                   3)
        out["train_s_per_iter"] = round(train_s_iter, 4)
    else:
        # the inference headline, so that a line always comes
        out["metric"] = "img/s/chip MTL inference (RESISC45+DIOR+Potsdam mix)"
        out["value"] = round(img_s, 2)
        out["vs_baseline"] = round(img_s / A100_BASELINE_IMG_S, 3)
        out["train_bench_error"] = train_err
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
