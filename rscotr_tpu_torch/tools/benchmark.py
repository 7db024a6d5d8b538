"""Benchmark a config's inference and training step on the card (PyTorch
counterpart of the root ``tools/benchmark.py``, with its flags and its
report's keys)::

    python -m rscotr_tpu_torch.tools.benchmark CONFIG [--tasks cls det seg]
        [--train] [--iters N] [--warmup N] [--cls-bs 16 --det-size 800 ...]
        [--cfg-options model.backbone.with_cp=True] [--eval-loop]
        [--device cuda]

Prints (and returns) a JSON report: per task the request's ``infer_ms``,
``infer_gflops``, ``infer_temp_mb`` and ``infer_mfu``, and with ``--train``
the step's (forward, backward and update) ``train_*`` keys. The batches are
the root tool's (``tools/_bench_common.py``: seeded, drawn in its order),
the weights random from seed 0.

* Times: CUDA events around the timed loop of ``--iters`` calls, each on
  a distinct pre-staged batch; ``--warmup`` calls before it, outside the
  window (host wall time on the CPU).
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one more call,
  outside the timed window. It counts the matmuls, convolutions and
  attention products, and the four kernel operators (K1, K1b, K2, K2b)
  through the formulas of ``ops/flops.py``; elementwise work is left out.
  XLA's ``cost_analysis``, which the root tool reads, counts elementwise
  work too, so the two tools' GFLOPs are not comparable. Each kernel
  operator's share is reported under ``{infer,train}_kernel_flops``.
* MFU: FLOPs over time over the published dense bf16 tensor-core peak of
  the named card (``PEAK_FLOPS``, keyed by the device name as the root
  tool's is keyed by TPU kind); no ``*_mfu`` key on another device or on
  the CPU.
* ``*_temp_mb``: the peak memory allocated during one call (one more,
  outside the timed window) less what was allocated before it, on the
  card; the root tool reads XLA's plan for the program's temporaries. 0.0
  on the CPU, as the root tool gives 0.0 where XLA has no analysis.

``--eval-loop`` times the end-to-end evaluation of the config's val split
instead, as the root tool does: the host pipeline alone, the whole
``single_device_test`` loop (after one untimed batch), and the metrics;
``--iters`` batches per dataset.

``--scan`` is refused: it timed the steps inside one jitted ``lax.scan`` to
amortise the TPU's per-call dispatch; its counterpart on the card,
CUDA-graph replay of the steps, is not built yet.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from rscotr_tpu_torch.utils.config import DictAction

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# published dense bf16 tensor-core peak, by a lower-case part of the device
# name: the H100 SXM (its name reads "NVIDIA H100 80GB HBM3")
PEAK_FLOPS = {"h100 80gb hbm3": 989e12}
KERNEL_OPS = ("msda_fwd", "msda_bwd", "window_attn_fwd", "window_attn_bwd")
SCAN_REFUSED = (
    "--scan is not supported by the port: it timed the steps inside one "
    "jitted lax.scan to amortise the TPU's per-call dispatch; its "
    "counterpart on the card, CUDA-graph replay of the steps, waits for "
    "ROADMAP's perf item 1. Time without --scan.")


def peak_flops(device: torch.device) -> float:
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device).lower()
    for key, val in PEAK_FLOPS.items():
        if key in name:
            return val
    return 0.0


@contextlib.contextmanager
def frozen(model):
    """The model's parameters with ``requires_grad`` off for the duration:
    ``FlopCounterMode``'s module tracker hooks every module input that
    requires grad, which fails under ``torch.inference_mode`` (a request)
    where a parameter is handed to a submodule."""
    was = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in was:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, r in was:
            p.requires_grad_(r)


def count_flops(fn):
    """(fn's result, total FLOPs, {kernel operator: FLOPs}) of one call of
    ``fn`` under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn()
    counts = fc.get_flop_counts().get("Global", {})
    per_op = {name: int(counts.get(getattr(torch.ops.rscotr_torch, name),
                                   0)) for name in KERNEL_OPS}
    return out, float(fc.get_total_flops()), per_op


def temp_mb(fn, device: torch.device) -> float:
    """The peak memory allocated during one call of ``fn`` less what was
    allocated before it (MiB); 0.0 off the card."""
    if device.type != "cuda":
        fn()
        return 0.0
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) - base) / 2 ** 20


def time_ms(fn, batches, warmup: int, iters: int,
            device: torch.device) -> float:
    """Mean ms of ``fn(batch)`` over ``batches[:iters]`` after ``warmup``
    untimed calls: CUDA events on the card, host wall time on the CPU."""
    for i in range(warmup):
        fn(batches[i % len(batches)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(batches[i])
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(batches[i])
    return (time.perf_counter() - t0) / iters * 1e3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Benchmark a config's inference and training step")
    ap.add_argument("config")
    ap.add_argument("--tasks", nargs="+", default=None,
                    choices=["cls", "det", "seg"])
    ap.add_argument("--train", action="store_true",
                    help="also time the train step (fwd+bwd+update)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--eval-loop", action="store_true",
                    help="benchmark the end-to-end eval loop on the "
                         "config's val split instead; --iters = batches "
                         "per dataset")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--scan", action="store_true",
                    help="refused: see the module's docstring")
    for t in ("cls", "det", "seg"):
        ap.add_argument(f"--{t}-bs", type=int)
        ap.add_argument(f"--{t}-size", type=int)
    ap.add_argument("--cfg-options", nargs="+", action=DictAction,
                    help="dotted config overrides, e.g. "
                         "model.shared_encoder.with_cp=True")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    return ap.parse_args(argv)


def _eval_loop(cfg, model, tasks, iters: int) -> dict:
    """The root tool's --eval-loop report, per val dataset."""
    from rscotr_tpu_torch.apis import derive_img_norm
    from rscotr_tpu_torch.data.build import build_dataloaders, build_datasets
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.engine.test import (evaluate_results,
                                              single_device_test)
    val_ds = build_datasets(cfg["data"], split="val") or \
        build_datasets(cfg["data"], split="test")
    val_ds = {n: d for n, d in val_ds.items() if d.task in tasks}
    loaders = build_dataloaders(val_ds, cfg["data"], train=False)
    test_cfg = cfg["model"].get("test_cfg") or {}
    infer = make_infer_steps(
        model, max_per_img=(test_cfg.get("det") or {}).get(
            "max_per_img", 300),
        img_norm=derive_img_norm(cfg), seg_test_cfg=test_cfg.get("seg"))
    model.eval()
    ev = {}
    for name, dl in loaders.items():
        # (a) the host pipeline alone: draw + collate, discarded
        t0 = time.perf_counter()
        for bi, b in enumerate(iter(dl)):
            if bi >= iters:
                break
        t_host = time.perf_counter() - t0
        # one untimed batch, then (b) the whole loop (t_host is a part of
        # t_total, not added to it)
        single_device_test(infer, {name: dl}, max_batches=1)
        t0 = time.perf_counter()
        res = single_device_test(infer, {name: dl}, max_batches=iters)
        t_total = time.perf_counter() - t0
        # (c) the metrics on the host results
        t0 = time.perf_counter()
        evaluate_results({name: val_ds[name]}, res, {val_ds[name].task: {}})
        t_metric = time.perf_counter() - t0
        n = max(len(res[name]), 1)
        ev[name] = {
            "task": val_ds[name].task,
            "images": n,
            "img_per_s": round(n / t_total, 2),
            "total_s": round(t_total, 4),
            "host_pipeline_s": round(t_host, 4),
            "host_share": round(t_host / t_total, 3),
            "metric_s": round(t_metric, 4),
        }
    return ev


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.scan:
        raise SystemExit(SCAN_REFUSED)

    from rscotr_tpu_torch.apis import (derive_cls_hw, derive_img_norm,
                                       make_step_config)
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.tools._bench_common import (derive_shapes,
                                                      make_batch_fns)
    from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict

    cfg = load_cfg(args.config)
    if args.cfg_options:
        cfg = merge_from_dict(cfg, args.cfg_options)
    cfg = load_data_cfg(cfg, config_root=ROOT, filename=args.config)
    device = torch.device(args.device)
    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(0),
                        cls_hw=derive_cls_hw(cfg))
    tasks = args.tasks or [t for t, key in
                           (("cls", "cls_head"), ("det", "bbox_head"),
                            ("seg", "seg_head"))
                           if cfg["model"].get(key) is not None]
    shapes = derive_shapes(cfg, {
        t: {"bs": getattr(args, f"{t}_bs"),
            "size": getattr(args, f"{t}_size")}
        for t in ("cls", "det", "seg")})
    rng = np.random.default_rng(0)
    mk_batch = make_batch_fns(shapes, rng, device=device)
    # the root tool draws one batch per task to initialise its model: the
    # same draws keep the timed batches equal to its own
    for t in ("cls", "det", "seg"):
        mk_batch[t](0)

    peak = peak_flops(device)
    report = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "backend": device.type, "tasks": {}}

    if args.eval_loop:
        report["eval_loop"] = _eval_loop(cfg, model, tasks, args.iters)
        print(json.dumps(report, indent=2), flush=True)
        return report

    def measure(prefix, fn, batches):
        ms = time_ms(fn, batches, args.warmup, args.iters, device)
        with frozen(model) if prefix == "infer" else contextlib.nullcontext():
            _, fl, per_op = count_flops(lambda: fn(batches[0]))
        entry = {f"{prefix}_ms": round(ms, 3),
                 f"{prefix}_gflops": round(fl / 1e9, 2),
                 f"{prefix}_temp_mb": round(
                     temp_mb(lambda: fn(batches[0]), device), 1),
                 f"{prefix}_kernel_flops": per_op}
        if peak:
            entry[f"{prefix}_mfu"] = round(fl / (ms / 1e3) / peak, 4)
        return entry

    test_cfg = cfg["model"].get("test_cfg") or {}
    infer = make_infer_steps(
        model, max_per_img=(test_cfg.get("det") or {}).get(
            "max_per_img", 300),
        img_norm=derive_img_norm(cfg))
    infer_args = {
        "cls": lambda b: (b["img"],),
        "det": lambda b: (b["img"], b["img_hw"], b["scale_factor"]),
        "seg": lambda b: (b["img"],),
    }
    model.eval()
    for t in tasks:
        batches = [mk_batch[t](i) for i in range(args.iters)]
        f, take = infer[t], infer_args[t]
        report["tasks"][t] = measure("infer", lambda b, f=f, take=take:
                                     f(*take(b)), batches)

    if args.train:
        step_cfg = make_step_config(cfg)
        lr_cfg = dict(cfg.get("lr_config") or {})
        lr_cfg.setdefault("max_iters", 1000)
        optimizer = build_optimizer(cfg["optimizer"],
                                    model.named_parameters(),
                                    lr_config=lr_cfg)
        cls_head_cfg = cfg["model"].get("cls_head") or {}
        masks = task_param_masks(
            [n for n, _ in model.named_parameters()],
            cls_uses_encoder=cls_head_cfg.get("type") == "MlvlClsHead")
        for t in tasks:
            batches = [mk_batch[t](i) for i in range(args.iters)]
            step = make_train_step(model, optimizer, t, step_cfg,
                                   masks.get(t))

            def run(b, step=step):
                # one fixed draw a call, as the root tool's fixed key
                return step(b, torch.Generator().manual_seed(0))

            report["tasks"][t].update(measure("train", run, batches))

    print(json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
