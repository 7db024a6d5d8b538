"""Profile the quad-gather MSDA against the K1 path, and the flagship's
serving requests, with torch.profiler on one CUDA device.

    python -m rscotr_tpu_torch.tools.profile_quad_seg

For each case: the wall time per call with the profiler on, the device time
summed over device kernels and copies (and its share of the wall time: how
busy the card is), the device kernels and aten ops per call, then the ten
device kernels with the most device time and the port's own kernels below
them, and the six aten ops with the most device time. Cases:
``ms_deform_attn(impl="quad")`` and ``impl="kernel"`` at the det encoder
(B=1, Q=Nv=13,294, 8 heads, 4 levels, 4 points, D=32, bf16), forward and
forward + backward, 5 calls each; the flagship MTL (random weights, seed 0)
serving the requests of ``chip_smoke.py``: cls 16x224^2, det 1x800^2, det
4x800^2 (four image sizes padded to 800^2), seg 4x512^2 and seg 1x512^2 in
whole mode, 3 requests each. Every case runs 3 times before the profiler
starts. Exits 1 without a CUDA device.
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
# device kernel names of csrc/*.cu
PORT_KERNELS = ("msda_", "window_attn", "scatter_add", "ws_",
                "weighted_gather")


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
    ranked = sorted(kern, key=_dev_time, reverse=True)
    # the ten with the most device time, then the port's own kernels
    for e in ranked[:10] + [e for e in ranked[10:]
                            if e.key.removeprefix("void ").startswith(
                                PORT_KERNELS)]:
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


def profile_serving(device: torch.device) -> None:
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_model_cfg
    cfg = load_model_cfg(str(FLAGSHIP_CFG))
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    steps = make_infer_steps(model, max_per_img=300,
                             seg_test_cfg=cfg["test_cfg"]["seg"])
    rng = np.random.default_rng(0)

    def img(B, side):
        return rng.integers(0, 256, (B, side, side, 3)).astype(np.uint8)

    det4_hw = np.array([[800, 800], [800, 704], [640, 800], [512, 600]],
                       np.int32)
    reqs = {
        "cls 16x224^2": ("cls", (img(16, 224),)),
        "det 1x800^2": ("det", (img(1, 800), np.array([[800, 800]], np.int32),
                                np.ones((1, 4), np.float32))),
        "det 4x800^2": ("det", (img(4, 800), det4_hw,
                                np.ones((4, 4), np.float32))),
        "seg 4x512^2": ("seg", (img(4, 512),)),
        "seg 1x512^2": ("seg", (img(1, 512),)),
    }
    for name, (task, args) in reqs.items():
        profile_calls(f"{name} request", lambda: steps[task](*args), n=3)


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
    profile_serving(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
