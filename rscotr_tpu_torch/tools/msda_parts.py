"""Time the MSDA kernels K1 (``csrc/msda_fwd.cu``) and K1b
(``csrc/msda_bwd.cu``) on one CUDA device with parts of their work switched
off by their inputs.

    python -m rscotr_tpu_torch.tools.msda_parts

At the flagship det encoder (B=1, Q=Nv=13,294, 8 heads, 4 levels, 4 points,
D=32, bf16) it reports the device time of one launch (a CUDA graph of 20
launches, the median of 5 replays) of K1's vector body, K1's
lane-per-channel body and K1b's vector body (adding into one accumulator),
with the corners on the map counted, on

- locations in [0, 1], as a model's are: nearly every corner on the map;
- locations in [-0.2, 1.2]: about half the corners off the map, skipped;
- every location in [2, 3], off the map: no corner row is loaded (nor, in
  K1b, reduced into), and what is left is the task's set-up, its point
  data, the shuffles, the sums and the outputs;
- every location at 0.5: each (b, h) reads the same 4 corner rows of each
  level, so K1's loads hit in L1 and the L2's bandwidth is out of the way
  (K1b's reductions all land on those rows).

Exits 1 without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from rscotr_tpu_torch.ops import ms_deform_attn as msda

DET_SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))
SPANS = {"locations in [0, 1]": (0.0, 1.0),
         "locations in [-0.2, 1.2]": (-0.2, 1.2),
         "off the map, [2, 3]: no corner loads": (2.0, 3.0),
         "all at 0.5: corner loads hit in L1": (0.5, 0.5)}


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls in one CUDA graph, the
    median over ``reps`` replays (CUDA events)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    graph.reset()
    return float(np.median(times))


def inputs(span, g, B=1, H=8, D=32, P=4, shapes=DET_SHAPES,
           dtype=torch.bfloat16):
    Nv = sum(h * w for h, w in shapes)
    v = torch.randn(B, Nv, H, D, device="cuda", generator=g).to(dtype)
    loc = torch.rand(B, Nv, H, len(shapes), P, 2, device="cuda",
                     generator=g) * (span[1] - span[0]) + span[0]
    w = torch.rand(B, Nv, H, len(shapes), P, device="cuda", generator=g)
    w = (w / w.sum((-1, -2), keepdim=True)).to(dtype)
    return v, shapes, loc, w


def corners_on_map(shapes, loc) -> int:
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device=loc.device)[:, None]
    x0 = torch.floor(loc * wh - 0.5)
    on = [((x0 + d >= 0) & (x0 + d < wh)).long() for d in (0, 1)]
    return int(sum((on[dy][..., 1] * on[dx][..., 0]).sum()
                   for dy in (0, 1) for dx in (0, 1)))


def main() -> int:
    if not torch.cuda.is_available():
        print("msda_parts: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    print("at the det encoder (B=1 Q=Nv=13294 H=8 L=4 P=4 D=32 bf16), ms "
          "per launch: K1 vector body / K1 lane body / K1b vector body",
          flush=True)
    for name, span in SPANS.items():
        v, shapes, loc, w = inputs(span, g)
        d_out = torch.randn(v.shape[0], loc.shape[1], v.shape[2] * v.shape[3],
                            device="cuda", generator=g).to(v.dtype)
        acc = torch.zeros(v.shape, dtype=torch.float32, device="cuda")
        k1 = graph_ms(lambda: msda._ms_deform_attn_cuda(v, shapes, loc, w))
        lane = graph_ms(lambda: msda._ms_deform_attn_cuda(
            v, shapes, loc, w, body=msda.BODY_LANE))
        k1b = graph_ms(lambda: msda._msda_bwd_cuda(v, shapes, loc, w, d_out,
                                                   acc=acc))
        print(f"  {name:<38} {k1:.4f} / {lane:.4f} / {k1b:.4f}  "
              f"({corners_on_map(shapes, loc)} corners on the map)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
