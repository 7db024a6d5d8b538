"""Profile the quad-gather MSDA against the K1 path, and the flagship's seg
requests, with torch.profiler on one CUDA device.

    python -m rscotr_tpu_torch.tools.profile_quad_seg

For each case: the wall time per call with the profiler on, the device time
summed over device kernels and copies (and its share of the wall time: how
busy the card is), the device kernels and aten ops per call, then the ten
device kernels and six aten ops with the most device time. Cases:
``ms_deform_attn(impl="quad")`` and ``impl="kernel"`` at the det encoder
(B=1, Q=Nv=13,294, 8 heads, 4 levels, 4 points, D=32, bf16), forward and
forward + backward, 5 calls each; the flagship MTL (random weights, seed 0)
serving seg 1x512^2 and 4x512^2 in whole mode, 3 requests each. Every case
runs 3 times before the profiler starts. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

FLAGSHIP_CFG = (Path(__file__).resolve().parents[2] /
                "configs/multi/MTL_synthetic_flagship.py")
DET_SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))


def _dev_time(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def report(name: str, prof, wall_ms: float, n: int) -> None:
    ev = list(prof.key_averages())
    kern = [e for e in ev if getattr(e, "device_type", None) ==
            torch.autograd.DeviceType.CUDA]
    busy = sum(_dev_time(e) for e in kern) / 1e3 / n
    kcount = sum(e.count for e in kern) / n
    aten = [e for e in ev if e.key.startswith("aten::")]
    ops = sum(e.count for e in aten) / n
    print(f"== {name}: wall {wall_ms / n:.3f} ms per call (profiler on), "
          f"device kernels {busy:.3f} ms ({100 * busy * n / wall_ms:.1f}% "
          f"busy), {kcount:.0f} device kernels + copies, {ops:.0f} aten ops "
          "per call", flush=True)
    for e in sorted(kern, key=_dev_time, reverse=True)[:10]:
        print(f"   {_dev_time(e) / 1e3 / n:8.4f} ms  x{e.count / n:6.1f}  "
              f"{e.key[:80]}", flush=True)
    for e in sorted(aten, key=_dev_time, reverse=True)[:6]:
        print(f"   op {_dev_time(e) / 1e3 / n:8.4f} ms  x{e.count / n:6.1f}  "
              f"{e.key[:60]}", flush=True)


def profile_calls(name: str, fn, n: int = 5, warmup: int = 3) -> None:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report(name, prof, wall, n)


def profile_msda(device: torch.device) -> None:
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    g = torch.Generator(device=device).manual_seed(2)
    Nv = sum(h * w for h, w in DET_SHAPES)
    v = torch.randn(1, Nv, 8, 32, device=device, generator=g).bfloat16()
    loc = torch.rand(1, Nv, 8, 4, 4, 2, device=device, generator=g) * 1.4 \
        - 0.2
    w = torch.rand(1, Nv, 8, 4, 4, device=device, generator=g)
    w = (w / w.sum((-1, -2), keepdim=True)).bfloat16()
    d = torch.randn(1, Nv, 256, device=device, generator=g).bfloat16()
    leaves = tuple(t.requires_grad_() for t in (v, loc, w))
    for impl in ("quad", "kernel"):
        def fwd():
            with torch.no_grad():
                ms_deform_attn(v, DET_SHAPES, loc, w, impl=impl)

        def fwd_bwd():
            out = ms_deform_attn(v, DET_SHAPES, loc, w, impl=impl)
            torch.autograd.grad(out, leaves, d)

        profile_calls(f"MSDA impl={impl} forward", fwd)
        profile_calls(f"MSDA impl={impl} forward+backward", fwd_bwd)


def profile_seg(device: torch.device) -> None:
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_model_cfg
    cfg = load_model_cfg(str(FLAGSHIP_CFG))
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    steps = make_infer_steps(model, seg_test_cfg=cfg["test_cfg"]["seg"])
    rng = np.random.default_rng(0)
    for B in (1, 4):
        img = rng.integers(0, 256, (B, 512, 512, 3)).astype(np.uint8)
        profile_calls(f"seg {B}x512^2 request", lambda: steps["seg"](img),
                      n=3)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from rscotr_tpu_torch.ops import kernel_lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernel_lib.build()
    device = torch.device("cuda")
    profile_msda(device)
    profile_seg(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
