"""Time the MSDA kernels K1 (``csrc/msda_fwd.cu``) and K1b
(``csrc/msda_bwd.cu``), and the quad-gather backward's K5
(``csrc/msda_ws.cu``) and K3' (``csrc/scatter_add.cu``), on one CUDA device
with parts of their work switched off by their inputs.

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

Then K3', the launch alone into one zeroed accumulator, vector and scalar
body, at the det encoder's quad-row updates (G=8, K=212,704, C=128, bf16,
into 13,294 rows): the plain backward's updates and rows at locations in
[0, 1] and [-0.2, 1.2]; random updates with every index out of range (the
loads alone, no reduction), spread evenly (index k on row pi(k mod 13,294)
for a random permutation pi: every row takes 16 updates, none twice in a
warp) and all on one row (the worst contention); the [0, 1] rows of one
group alone (G=1), and folded onto 169 rows a group (index mod 169: an
86.5 KB table, more updates on each row). And K5, both bodies, at g (8,
13294, 16, 128) bf16, beside a copy of g into d_g (``Tensor.copy_``: the
bytes K5 must move, without its weights and sums).

Exits 1 without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from rscotr_tpu_torch.ops import ms_deform_attn as msda
from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE
from rscotr_tpu_torch.ops.msda_ws import _ws_bwd_cuda
from rscotr_tpu_torch.ops.scatter_mm import _scatter_add_cuda

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


def scatter_parts(g) -> None:
    """K3' at the det encoder with its reductions spread, piled up or gone,
    ms per launch (vector / scalar body)."""
    Nv = sum(h * w for h, w in DET_SHAPES)
    print("K3' at the det encoder (G=8 K=212704 C=128 bf16 into 13294 rows), "
          "ms per launch: vector body / scalar body", flush=True)
    cases = {}
    for span in ((0.0, 1.0), (-0.2, 1.2)):
        v, shapes, loc, w = inputs(span, g)
        d_out = torch.randn(1, Nv, 256, device="cuda", generator=g).to(
            v.dtype)
        d_g, gidx = msda.msda_bwd_rows_torch(v, shapes, loc, w, d_out)[:2]
        cases[f"plain backward's rows, locations in [{span[0]}, {span[1]}]"] \
            = d_g.contiguous(), gidx.contiguous()
    upd = torch.randn(d_g.shape, device="cuda", generator=g).to(d_g.dtype)
    G, K = gidx.shape
    perm = torch.randperm(Nv, device="cuda", generator=g)
    spread = perm[torch.arange(K, device="cuda") % Nv]
    for name, idx in (
            ("every index out of range: loads only", torch.full_like(
                gidx, -1)),
            ("spread evenly: 16 updates a row", spread.expand(G, K)),
            ("every index on one row", torch.zeros_like(gidx))):
        cases[name] = upd, idx.int().contiguous()
    d_g, gidx = cases["plain backward's rows, locations in [0.0, 1.0]"]
    cases["the same rows, one group alone (G=1)"] = d_g[:1], gidx[:1]
    cases["the same rows folded onto 169 rows a group"] = \
        d_g, (gidx % 169).contiguous()
    acc = torch.zeros(G, Nv, d_g.shape[-1], device="cuda")
    for name, (u, idx) in cases.items():
        out = acc[:u.shape[0]]
        vec = graph_ms(lambda: _scatter_add_cuda(u, idx, out))
        scalar = graph_ms(lambda: _scatter_add_cuda(u, idx, out,
                                                    body=BODY_LANE))
        print(f"  {name:<50} {vec:.4f} / {scalar:.4f}", flush=True)


def ws_bwd_parts(g) -> None:
    """K5 at the det encoder, ms per launch (vector / warp-per-row body),
    beside a plain copy of the same bytes."""
    Nv = sum(h * w for h, w in DET_SHAPES)
    gq = torch.randn(8, Nv, 16, 128, device="cuda",
                     generator=g).to(torch.bfloat16)
    wt = torch.rand(8, Nv, 64, device="cuda", generator=g).to(torch.bfloat16)
    dq = torch.randn(8, Nv, 32, device="cuda", generator=g)
    vec = graph_ms(lambda: _ws_bwd_cuda(gq, wt, dq))
    row = graph_ms(lambda: _ws_bwd_cuda(gq, wt, dq, body=BODY_LANE))
    print(f"K5 at the det encoder (g (8, 13294, 16, 128) bf16), ms per "
          f"launch: vector body {vec:.4f}, warp-per-row body {row:.4f}",
          flush=True)
    d_g = torch.empty_like(gq)
    print(f"  copy of g into d_g (Tensor.copy_, {2 * gq.nbytes / 1e6:.1f} MB "
          f"moved): {graph_ms(lambda: d_g.copy_(gq)):.4f}", flush=True)


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
    del v, loc, w, d_out, acc
    scatter_parts(g)
    ws_bwd_parts(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
