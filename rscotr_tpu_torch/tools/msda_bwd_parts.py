"""Time the parts of the MSDA backward kernel K1b (``csrc/msda_bwd.cu``) on
one CUDA device, by switching them off or swapping them.

    python -m rscotr_tpu_torch.tools.msda_bwd_parts

At the flagship det encoder (B=1, Q=Nv=13,294, 8 heads, 4 levels, 4 points,
D=32, bf16; locations in [-0.2, 1.2]) it builds the kernel library three
times (as it stands, with ``-DMSDA_BWD_SCALAR_RED`` and with
``-DMSDA_BWD_NO_RED``) and reports the device time of one launch (CUDA
events around 50 launches that add into one accumulator) of

- the lane-per-channel body with scalar atomics (``BODY_LANE``), which is
  the fusion alone;
- the vector body with four scalar atomics a lane: what lanes over 4
  channels, a point per lane group and coalesced point data buy;
- the vector body as built (one 16-byte vector reduction a lane): what the
  vector atomics buy;
- the vector body without its reductions: what the atomics cost at all;

the last two again with locations in [0, 1], as a model's mostly are:
nearly every corner is then on the map, where [-0.2, 1.2] leaves about half
of them off it and skipped; then, with and without the reductions, the
vector body on a single level of each of the encoder's four map sizes at
the same number of sampling points (L=1, P=16): if many points adding into
the few cells of a coarse map serialized, the coarse maps would cost more
than the fine one, and only with the reductions on. Last, the whole ``ms_deform_attn_bwd`` beside
its parts (the accumulator's zero fill, the kernel, the cast). Exits 1
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys

import torch

from rscotr_tpu_torch.ops import kernel_lib
from rscotr_tpu_torch.ops import ms_deform_attn as msda

DET_SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def library(lib):
    """Run the wrappers on ``lib`` instead of the default build."""
    kept, kernel_lib._LIB = kernel_lib._LIB, lib
    try:
        yield
    finally:
        kernel_lib._LIB = kept


def inputs(shapes, Q, P, g, H=8, D=32, dtype=torch.bfloat16,
           span=(-0.2, 1.2)):
    Nv = sum(h * w for h, w in shapes)
    v = torch.randn(1, Nv, H, D, device="cuda", generator=g).to(dtype)
    loc = torch.rand(1, Q, H, len(shapes), P, 2, device="cuda",
                     generator=g) * (span[1] - span[0]) + span[0]
    w = torch.rand(1, Q, H, len(shapes), P, device="cuda", generator=g)
    w = (w / w.sum((-1, -2), keepdim=True)).to(dtype)
    d_out = torch.randn(1, Q, H * D, device="cuda", generator=g).to(dtype)
    return v, shapes, loc, w, d_out


def kernel_ms(args, body) -> float:
    acc = torch.zeros(args[0].shape, dtype=torch.float32, device="cuda")
    return device_ms(lambda: msda._msda_bwd_cuda(*args, acc=acc, body=body))


def main() -> int:
    if not torch.cuda.is_available():
        print("msda_bwd_parts: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {name: kernel_lib.bind(kernel_lib.build(defines).path)
            for name, defines in (("as built", ()),
                                  ("scalar red", ("MSDA_BWD_SCALAR_RED",)),
                                  ("no red", ("MSDA_BWD_NO_RED",)))}
    g = torch.Generator(device="cuda").manual_seed(0)
    Q = sum(h * w for h, w in DET_SHAPES)
    det = inputs(DET_SHAPES, Q, 4, g)
    print("K1b at the det encoder (B=1 Q=Nv=13294 H=8 L=4 P=4 D=32 bf16), ms "
          "per launch:")
    for name, lib, body in (
            ("lane body, scalar atomics", "as built", msda.BODY_LANE),
            ("vector body, 4 scalar atomics a lane", "scalar red",
             msda.BODY_VEC),
            ("vector body, one 16-byte reduction a lane (as built)",
             "as built", msda.BODY_VEC),
            ("vector body, no reductions", "no red", msda.BODY_VEC)):
        with library(libs[lib]):
            print(f"  {name:<54} {kernel_ms(det, body):.4f}", flush=True)
    inside = inputs(DET_SHAPES, Q, 4, g, span=(0.0, 1.0))
    for name, lib in (("as built", "as built"),
                      ("no reductions", "no red")):
        with library(libs[lib]):
            print(f"  vector body, locations in [0, 1], {name:<22} "
                  f"{kernel_ms(inside, msda.BODY_VEC):.4f}", flush=True)
    print("vector body on one level, Q=13294 P=16 (the det encoder's number "
          "of points), ms per launch with / without the reductions:")
    for hw in DET_SHAPES:
        one = inputs((hw,), Q, 16, g)
        with library(libs["as built"]):
            on = kernel_ms(one, msda.BODY_VEC)
        with library(libs["no red"]):
            off = kernel_ms(one, msda.BODY_VEC)
        print(f"  level {hw[0]:>3} x {hw[1]:<3} ({hw[0] * hw[1] * 8:>6} "
              f"accumulator rows) {on:.4f} / {off:.4f}", flush=True)
    with library(libs["as built"]):
        v = det[0]
        acc = torch.zeros(v.shape, dtype=torch.float32, device="cuda")
        print("the whole ms_deform_attn_bwd at the det encoder, ms: "
              f"{device_ms(lambda: msda.ms_deform_attn_bwd(*det)):.4f} "
              f"(zero fill {device_ms(lambda: torch.zeros_like(acc)):.4f}, "
              f"kernel {kernel_ms(det, msda.BODY_VEC):.4f}, cast "
              f"{device_ms(lambda: acc.to(v.dtype)):.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
