"""Time the flagship's exported serving programs against the live steps on
one CUDA device: where an artifact request's host time goes.

    python -m rscotr_tpu_torch.tools.profile_export

Builds the flagship MTL (random weights, seed 0) on the card, exports its
cls 16x224^2, det 4x800^2 and seg 4x512^2 steps (uint8 in) with
``export.export_inference``, saves them with ``save_artifact`` into a
temporary directory and times three ways of running each request on the
same inputs, in turns (each way twice, in the order A B C C B A): ``live``
(``make_infer_steps``), ``artifact`` (``load_artifact``: the graph run with
the weights bound once and the trace's metadata checks dropped) and
``module`` (``torch.export.load(...).module()`` called with the weights on
every request: its pytree flatten and guard checks over every input, and
every ``_assert_tensor_metadata`` node). Each timing is the median of 20
warm calls, CUDA events around the call, beside the host's wall time per
call; then torch.profiler over 3 warm requests of ``live`` and
``artifact``: device time, busy share, device kernels and aten ops per
call. Prints the card's nvidia-smi line. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FLAGSHIP_CFG = (Path(__file__).resolve().parents[2] /
                "configs/multi/MTL_synthetic_flagship.py")
BUCKETS = {"cls": (16, 224), "det": (4, 800), "seg": (4, 512)}
ORDER = ("live", "artifact", "module", "module", "artifact", "live")


def _time(fn, inputs, n=20, warmup=3):
    """(median CUDA-event ms, median host ms) of ``n`` warm calls."""
    for _ in range(warmup):
        fn(*inputs)
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn(*inputs)
        end.record()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    return float(np.median(dev)), float(np.median(host))


def _profile(fn, inputs, n=3):
    """(device ms, busy share, device kernels, aten ops) per call."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*inputs)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    ev = list(prof.key_averages())
    kern = [e for e in ev if getattr(e, "device_type", None) ==
            torch.autograd.DeviceType.CUDA]
    dev = sum(getattr(e, "self_device_time_total", 0.0)
              for e in kern) / 1e3
    aten = sum(e.count for e in ev if e.key.startswith("aten::"))
    return (dev / n, dev / wall, sum(e.count for e in kern) / n, aten / n)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_export: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(FLAGSHIP_CFG.parents[2]))
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.export import (export_inference, load_artifact,
                                         save_artifact)
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_cfg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = load_cfg(str(FLAGSHIP_CFG))
    model = build_model(cfg["model"], device="cuda",
                        generator=torch.Generator().manual_seed(0))
    shapes = {t: dict(bs=bs, size=s) for t, (bs, s) in BUCKETS.items()}
    live = make_infer_steps(model, max_per_img=300,
                            seg_test_cfg=cfg["model"]["test_cfg"]["seg"])
    weights = list(model.state_dict().values())
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="rscotr_profile_export_") as d:
        programs = export_inference(
            model, shapes, max_per_img=300,
            seg_test_cfg=cfg["model"]["test_cfg"]["seg"],
            img_dtype=torch.uint8)
        save_artifact(d, programs, model.state_dict(), shapes)
        fns, _ = load_artifact(d, device="cuda")
        modules = {t: torch.export.load(f"{d}/{t}.pt2").module()
                   for t in BUCKETS}
        for task, (bs, size) in BUCKETS.items():
            img = torch.as_tensor(rng.integers(
                0, 256, (bs, size, size, 3), dtype=np.uint8)).cuda()
            inputs = (img,) if task != "det" else (
                img, torch.full((bs, 2), size, dtype=torch.int32,
                                device="cuda"),
                torch.ones((bs, 4), device="cuda"))

            @torch.inference_mode()
            def module(*x, _m=modules[task]):
                return _m(weights, *x)

            ways = {"live": live[task], "artifact": fns[task],
                    "module": module}
            nodes = len(fns[task].program.graph.nodes)
            asserts = sum(
                n.target is torch.ops.aten._assert_tensor_metadata.default
                for n in modules[task].graph.nodes)
            times = {}
            for way in ORDER:
                times.setdefault(way, []).append(_time(ways[way], inputs))
            print(f"== {task} {bs}x{size}^2: graph {nodes} nodes without "
                  f"its {asserts} metadata checks  [{smi}]", flush=True)
            for way in ("live", "artifact", "module"):
                print(f"  {way:<8} " + " / ".join(
                    f"{dev:.3f} ms (host {host:.3f})"
                    for dev, host in times[way]), flush=True)
            for way in ("live", "artifact"):
                dev, busy, kern, aten = _profile(ways[way], inputs)
                print(f"  {way:<8} profiler: device {dev:.3f} ms per call, "
                      f"{100 * busy:.1f}% busy, {kern:.0f} device kernels "
                      f"+ copies, {aten:.0f} aten ops", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
