"""Drive the PyTorch port (rscotr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from rscotr_tpu_torch/csrc (one nvcc
   per source, in parallel);
3. kernels: K1 (MSDA forward) and K2 (Swin window attention) against their
   plain PyTorch versions at the flagship's shapes (the det and seg
   encoders at B=1 and B=4, the det decoder at 600 and 800 queries; the
   Swin stages of det 800^2, cls 224^2 and seg 512^2), in float32 and
   bfloat16, with kernel and plain times from CUDA events. K1 with both of
   its bodies on the same tensors: the vector body, which every model-path
   launch takes, and the lane-per-channel body (the first kernel), at
   locations in [0, 1] as a model's are and in [-0.2, 1.2], where about
   half the corners are off the map; a modelled-L2 line (corner rows
   loaded, counted from the locations) beside each timed case; also at the
   zoo's encoders (the paper MTL's cls encoder, RSCoTrSeg-R50's 3-level
   one). K2 also
   with q, k, v as strided views of the fused qkv
   projection, with a window count that the per-block run of windows does
   not divide, and at a head width that takes its CUDA-core instantiation
   in bf16. Each timed kernel stands beside its bound (the larger of bytes
   moved once over 3.35 TB/s and operations over the published peak);
4. backward kernels: K1b (the whole MSDA backward in one launch, the
   value-gradient scatter fused in) and K2b (window attention backward),
   through ``torch.autograd.grad`` of the CUDA Functions, against the plain
   decomposition at the flagship's shapes (K1b at the det and seg encoders
   and the train decoder, at a head width of 64, at one that takes its
   lane-per-channel body, with locations that clamp at the map's edge, and
   at the zoo's encoders;
   K2b at K2's extra cases too), float32 and bfloat16, timed, with bounds;
   K3' (the scatter alone, which the quad-gather path runs) on the quad-row
   updates of the plain backward at the det encoder (locations in [0, 1]
   and [-0.2, 1.2]) and the train decoder, its vector body and its scalar
   body forced on the same tensors, timed at the det encoder beside one
   ``index_add_`` call, its library yardstick;
5. quad-gather MSDA at the det encoder: ``ms_deform_attn(impl="quad")``
   forward + backward once (K4, K5 and K3' launches counted; K4, K5 and
   K3' must take their vector bodies), K4 (corner-weighted sum) and K5 (its
   gradients), each with both bodies on the same tensors, against their
   plain versions, the quad path's output and gradients against the K1
   path's, float32 and bfloat16; K4, K5 and both paths timed, with their
   peak memory, K4 beside one ``torch.bmm``, its library yardstick;
6. K6 through the probe tool (``rscotr_tpu_torch.tools.
   probe_msda_weighted_gather_mm``): its parity check, K6 against its plain
   version at the four det-encoder level shapes, float32 and bfloat16, then
   the tool's per-level timing against the plain gather x weight (K6
   launches counted);
7. slice parity: the tiny config's cls, det and seg (whole and slide mode)
   tasks on the CPU (plain versions) and on the card (kernels), float32,
   TF32 off;
8. training parity: the tiny config trains cls, det, det, cls on the CPU
   and on the card from the same weights and batches; every loss term per
   step and the final parameters are compared;
9. serving: the flagship MTL (Swin-T, 6-layer shared MSDA encoder,
   600-query DINO head, 9-layer Mask2Former head; bf16 compute, random
   weights from a seed) answers cls 16x224^2, det 1x800^2, det 4x800^2,
   seg 4x512^2 and seg 1x512^2 requests; outputs are checked, kernel
   launches counted (every K1 launch must take the vector body), median
   latency (CUDA events) and peak memory reported;
10. training: the flagship trains cls 16x224^2 (mixup / cutmix), det
    1x800^2 (18 GT boxes padded to 100, 5 CDN groups: 200 DN + 600 matching
    queries) and seg 4x512^2 (uint8 labels in [0, 5) with a band of the
    ignore index 255) interleaved under the per-task masks, drop path 0.2;
    losses and grad norms are checked finite, the masked modules
    bit-identical, kernel launches counted per step (every K1 and K1b
    launch on the vector body); median step time (CUDA events around the
    whole step, host matcher included), the host matcher's time and peak
    memory reported;
11. the model zoo at full width and depth, bf16, random weights: the
    paper's MTL (``MlvlClsHead`` scheme 5, whose cls path runs the shared
    encoder) answers 3 cls 16x224^2 requests and takes 3 cls steps under
    the mask of ``cls_uses_encoder=True``; DINO-R50 (an MTL with a
    ResNet-50 backbone and the det head) 3 det 1x800^2 requests and 3 det
    steps; RSCoTrSeg-R50 (the standalone segmentor, its own 3-level
    encoder) 3 seg 2x512^2 requests and 3 seg steps without a task mask.
    Each path's timed calls follow 2 untimed warm-up calls, checked and
    counted as they are. Each config is a copy with its loaders' on-device augmentation off
    (ROADMAP M6). Every request and step runs with the kernel counts at 0
    and is checked
    against the counts the code gives (all K1 / K1b launches on the vector
    body); outputs checked, median time and peak memory reported. K1 and
    K1b are held against their plain versions at these paths' new encoder
    shapes in phases 3 and 4 (B=16, Q=Nv=1,045, L=4; B=2, Q=Nv=5,376,
    L=3);
12. library yardsticks of K2 and K2b, last because cuDNN keeps workspace
    once it has run under graph capture: ``scaled_dot_product_attention``
    with the additive bias + mask, and its autograd backward, on the timed
    stages' own tensors (rebuilt from their seed), under every backend that
    takes them; the fastest is the yardstick. The port never calls it.

The line before the last is {"kernels": [...]}: eight kernels, each with
``launches`` (the main path's run: the flagship's training), K1, K1b, K2
and K2b also ``launches_paths`` (each zoo path's and each flagship task's
run, counted from 0), ``max_abs_err``, ``ms`` and ``plain_ms``
(kernel and plain version, same inputs), ``bound_ms`` / ``bound_by`` (the
least time the card could take, computed from this run's tensors),
``library_ms`` / ``library`` (the one-call yardstick, null where there is
none; timed here, called nowhere in the port; for K2 and K2b the fastest
SDPA backend, named in ``library_backend``). K2 and K2b are shorter than
their wrapper's host time, so their ``ms`` and ``library_ms`` are device
times from a CUDA-graph replay, ``eager_ms`` is the eager-call time, and
``stages`` holds all three timed stage shapes. K1's ``ms`` is device time
too, at the det encoder with locations in [0, 1], beside ``eager_ms``,
``lane_ms`` (the lane body on the same tensors) and ``vec_launches`` /
``vec_launches_serving`` (the launches that took the vector body); its
``stages`` hold [-0.2, 1.2], det encoder B=4, seg encoder B=1 and B=4 and
the train decoder (Q=800). K1b's are device times too,
beside ``eager_ms`` and ``whole_ms`` (the whole ``ms_deform_attn_bwd``: zero
fill, kernel, cast), timed at locations in [0, 1], as a model's are; its
``stages`` also hold the time at the [-0.2, 1.2] locations of the other
kernel cases, where half the corners are off the map and skipped. K4's and
K5's ``ms`` are device times too, beside ``eager_ms``, ``row_ms`` (the
warp-per-row body, the first kernel, on the same tensors) and
``vec_launches``; K4's ``library_ms`` is device time too. K3''s ``ms`` is
the device time of the launch alone, adding into a zeroed accumulator, at
locations in [0, 1], beside ``eager_ms``, ``whole_ms`` / ``whole_eager_ms``
(``scatter_add_mm`` with its zero fill), ``scalar_ms`` (the scalar body on
the same tensors), ``vec_launches`` and ``stages`` (also [-0.2, 1.2], where
about half the sampling points clamp onto edge cells); its ``library_ms``
is device time too. The last line is {"ok": true, "device": {...}}. Without a CUDA device the script exits 1
before printing any result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TINY_CFG = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
FLAGSHIP_CFG = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")
PAPER_CFG = os.path.join(
    ROOT, "configs/multi/MTL_swin-t-p4-w7_1x1_resisc_dior_potsdam.py")
DINO_R50_CFG = os.path.join(ROOT,
                            "configs/det/dino_4scale_r50_1x1_50e_dior.py")
RSEG_R50_CFG = os.path.join(
    ROOT, "configs/seg/RSCoTrSeg_3scale_r50_512x512_80k_potsdam_IRRG_all.py")
# untimed calls before each zoo path's timed ones
ZOO_WARMUP = 2

# K1 / K2 against the plain version on the same inputs. float32: kernel and
# plain differ only in summation order. bfloat16: the plain version runs in
# float32 on the same bf16-rounded inputs; the kernel, like the Pallas K1,
# keeps corner weights and sums in f32 and rounds once at the output, so the
# bound is one bf16 ulp of the result (2^-7 relative) plus 1e-3.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# backward kernels against the plain decomposition on the same inputs. The
# gradients are sums taken in another order (warp reductions, and f32
# atomics whose order changes from run to run), so the bound is scaled by
# the largest reference entry: |got - ref| <= atol * max|ref| + rtol * |ref|;
# bf16 outputs may differ by one bf16 ulp (2^-7 relative).
BTOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2.0 ** -7)}
# K2 / K2b in bf16 round P (and dS) to bf16 as operands of the tensor-core
# products, and so does the plain version. The two f32 values of an entry
# differ in their last bits (other summation order in the softmax), so where
# one lies on a rounding boundary the two bf16 operands differ by one bf16
# ulp, 2^-7 relative. That is rare, so of the n operand x factor terms that
# sum to one output at most P_FLIPS are taken to be off at once: on top of
# TOL / BTOL the bf16 comparisons allow P_FLIPS * P_ULP * max_j (|operand_ij|
# |factor_jd|) (``k2_ulp_slack``): the terms are P |v| for the output,
# P^T |dO| for dV, scale |dS| |k| for dQ and scale |dS|^T |q| for dK; nothing
# more for d_rel_bias (f32 dS) and nothing for f32 inputs, which round
# nowhere. The log line of each comparison gives the share of outputs that
# lie outside TOL / BTOL alone.
P_ULP = 2.0 ** -7
P_FLIPS = 2
# slice parity, CPU (plain versions) vs card (kernels), float32
SLICE_TOL = 1e-4
# training parity, CPU vs card, float32, TF32 off. The sums run in another
# order (cuBLAS, warp reductions, f32 atomics whose order changes from run
# to run), and Adam turns the float noise of a near-zero gradient element
# into an update of up to +-lr, so: loss terms and grad_norm per step at
# rtol 2e-3 / atol 2e-4; after the last step, at most 1e-3 of all parameter
# elements outside 2e-4 + 5e-3 * |w|, and none further than the most such
# sign flips can move an element, 2 * lr * steps = 8e-4 (tiny config, lr
# 1e-4, 4 steps). A composition bug (weight, avg factor, mask) moves whole
# tensors by O(lr * steps) and fails the first bound.
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
PARAM_ATOL, PARAM_RTOL, PARAM_FRAC, PARAM_MAX = 2e-4, 5e-3, 1e-3, 8e-4

# flagship shapes: det 800^2 and seg 512^2 encoder levels (strides 8..64)
# and Swin stages (maps padded to a multiple of the 7-wide window)
DET_SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))
SEG_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
# the paper MTL's cls encoder at 224^2 (levels low -> high resolution, the
# order the pixel decoders hand the encoder) and RSCoTrSeg-R50's 3-level
# encoder at 512^2
CLS_SHAPES = ((4, 4), (7, 7), (14, 14), (28, 28))
RSEG_SHAPES = ((16, 16), (32, 32), (64, 64))
K2_SHAPES = {  # name: (B, nW, H, shifted)
    "det800.s0": (1, 841, 3, True), "det800.s1": (1, 225, 6, True),
    "det800.s2": (1, 64, 12, True), "det800.s3": (1, 16, 24, True),
    "cls224.s0": (16, 64, 3, True), "cls224.s1": (16, 16, 6, True),
    "cls224.s2": (16, 4, 12, True), "cls224.s3": (16, 1, 24, False),
    "seg512.s0": (4, 361, 3, True), "seg512.s1": (4, 100, 6, True),
    "seg512.s2": (4, 25, 12, True), "seg512.s3": (4, 9, 24, True),
}


TIMED_K2 = ("det800.s0", "cls224.s0", "seg512.s0")

# published peaks of one H100 SXM, dense (NVIDIA's data sheet): device memory
# rate, bf16 tensor-core rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16 tensor": 989e12, "f32": 67e12}


def bound(tensors, flops: float, rate: str):
    """The least time the card could take: (ms, "bytes" or "operations").
    ``tensors`` are the call's inputs and outputs (or their size in bytes),
    each moved once at the device-memory rate; ``flops`` the operations
    these inputs need, at the published peak of ``rate``."""
    nbytes = tensors if isinstance(tensors, int) else sum(
        t.numel() * t.element_size() for t in tensors if t is not None)
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[rate]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
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


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, the median over ``reps`` replays (CUDA events). Unlike
    ``cuda_ms`` the host's cost of issuing a call stays out of the number,
    which matters once a kernel is shorter than its wrapper's host time."""
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
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    graph.reset()   # hand the capture's memory pool back
    return float(np.median(times))


def check_close(name, got, ref, dtype, slack=None) -> float:
    atol, rtol = TOL[dtype]
    got = got.float()
    err = (got - ref).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    over = err - rtol * ref.abs()
    excess = (over - (0 if slack is None else slack)).max().item()
    max_err = err.max().item()
    share = "" if slack is None else \
        f"; {(over > atol).float().mean().item():.1e} of outputs need P_FLIPS"
    log(f"  {name:<34} {str(dtype)[6:]:<8} max_abs_err {max_err:.3e}  "
        f"(tol {atol:g} + {rtol:g}*|ref|{share})")
    if excess > atol:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max_abs_err {max_err:.3e})")
    return max_err


def timed_wa_inputs(name):
    """The bf16 inputs (and d_out) of a timed K2 / K2b stage, from a seed of
    their own: ``library_phase``, which runs last, rebuilds the same
    tensors for the library call."""
    B, nW, H, shifted = K2_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(100 + TIMED_K2.index(name))
    inputs = wa_inputs(B, nW, H, shifted, torch.bfloat16, g)
    d_out = torch.randn(inputs[0].shape, device="cuda",
                        generator=g).to(torch.bfloat16)
    return inputs + (d_out,)


def library_phase(times, btimes) -> None:
    """Fill ``library_ms`` of the timed K2 / K2b stages. It runs after every
    other phase: under graph capture cuDNN's SDPA keeps ~100 MiB of
    workspace allocated for good, which would otherwise sit in the peak
    memory that the serving and training phases report."""
    log("library phase: scaled_dot_product_attention on the timed K2 / K2b "
        "inputs")
    for name in TIMED_K2:
        fwd, bwd = sdpa_yardstick(name, *timed_wa_inputs(name))
        times[f"K2 {name}"].update(library_ms=fwd[0],
                                   library_backend=fwd[1])
        btimes[f"K2b {name}"].update(library_ms=bwd[0],
                                     library_backend=bwd[1])
    log_times({k: r for t in (times, btimes) for k, r in t.items()
               if k.startswith("K2")})


def k2_ulp_slack(q, k, v, bias, mask, scale, d_out=None):
    """What P_FLIPS entries of P (and dS), one bf16 ulp off, may move the
    bf16 kernels' results by (see P_ULP): a tensor for the forward output,
    or, given ``d_out``, one per gradient (dq, dk, dv, d_rel_bias)."""
    from rscotr_tpu_torch.ops.window_attention import _probs

    def largest_term(operand, factor, over_rows=False):
        # operand (..., i, j), factor (..., j, d) -> max_j of the (i, d)
        # terms; ``over_rows``: factor (..., i, d) -> max_i of the (j, d)
        if over_rows:
            return (operand[..., None] * factor[..., :, None, :]).amax(-3)
        return (operand[..., None] * factor[..., None, :, :]).amax(-2)

    allow = P_FLIPS * P_ULP
    p = _probs(q, k, bias, mask, scale)
    if d_out is None:
        return allow * largest_term(p, v.float().abs())
    do = d_out.float()
    dp = torch.einsum("bwhqd,bwhkd->bwhqk", do, v.float())
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).abs()
    return (allow * scale * largest_term(ds, k.float().abs()),
            allow * scale * largest_term(ds, q.float().abs(), True),
            allow * largest_term(p, do.abs(), True), None)


def k2_cases():
    """(name, (B, nW, H, shifted), wa_inputs keywords) of every K2 / K2b
    comparison: the twelve flagship stage shapes, then q, k, v as strided
    views of the fused projection (head widths 32 and 64), 1,805 tiles per
    head, which the runs of windows per block (11 forward, 21 backward) do
    not divide, and a head width that takes the CUDA-core instantiation in
    bf16 too."""
    cases = [(name, shape, {}) for name, shape in K2_SHAPES.items()]
    cases.append(("fused-qkv views", (2, 9, 3, True), dict(fused_qkv=True)))
    cases.append(("fused-qkv hd=64", (2, 9, 3, True),
                  dict(fused_qkv=True, hd=64)))
    cases.append(("ragged 5x361", (5, 361, 3, True), dict(fused_qkv=True)))
    cases.append(("cuda-core hd=24", (2, 9, 3, True), dict(hd=24)))
    return cases


# the earlier bodies of K1, K4, K5 and K3', timed on the same tensors
OLD_BODIES = {"lane_ms": "lane body", "row_ms": "warp-per-row body",
              "scalar_ms": "scalar body"}


def log_times(times) -> None:
    for name, r in times.items():
        lib = r.get("library_ms")
        via = f" ({r['library_backend']})" if "library_backend" in r else ""
        eager = f" (eager {r['eager_ms']:.4f})" if "eager_ms" in r else ""
        for key, body in OLD_BODIES.items():
            if key in r:
                eager += f"; {body} {r[key]:.4f} ms"
        if "whole_ms" in r:
            eager += (f"; whole wrapper {r['whole_ms']:.4f} ms "
                      f"(eager {r['whole_eager_ms']:.4f})")
        log(f"  time bf16 {name:<28} kernel {r['ms']:.4f} ms{eager}   plain "
            f"{r['plain_ms']:.4f} ms   bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})   library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}{via}")


def msda_inputs(B, Q, dtype, g, H=8, D=32, P=4, shapes=DET_SHAPES,
                span=(-0.2, 1.2)):
    L = len(shapes)
    Nv = sum(h * w for h, w in shapes)
    v = torch.randn(B, Nv, H, D, device="cuda", generator=g).to(dtype)
    # locations straddle the border to exercise the validity masking
    loc = torch.rand(B, Q, H, L, P, 2, device="cuda", generator=g) * (
        span[1] - span[0]) + span[0]
    w = torch.rand(B, Q, H, L, P, device="cuda", generator=g)
    w = (w / w.sum((-1, -2), keepdim=True)).to(dtype)
    return v, shapes, loc, w


def wa_inputs(B, nW, H, shifted, dtype, g, n=49, hd=32, fused_qkv=False):
    """``fused_qkv``: q, k, v as the strided views of one (B * nW, n, 3 * H
    * hd) projection that the Swin block passes (swin.py, WindowMSA)."""
    from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
    if fused_qkv:
        qkv = torch.randn(B * nW, n, 3, H, hd, device="cuda",
                          generator=g).to(dtype).permute(2, 0, 3, 1, 4)
        q, k, v = (t.unflatten(0, (B, nW)) for t in qkv.unbind(0))
    else:
        q, k, v = (torch.randn(B, nW, H, n, hd, device="cuda",
                               generator=g).to(dtype) for _ in range(3))
    bias = torch.randn(H, n, n, device="cuda", generator=g) * 0.02
    mask = None
    if shifted:
        side = int(round(nW ** 0.5)) * 7
        mask = torch.as_tensor(_shift_attn_mask(side, side, 7, 3),
                               device="cuda")
    return q, k, v, bias, mask, hd ** -0.5


def sdpa_yardstick(name, q, k, v, bias, mask, scale, d_out):
    """The library yardstick of K2 and K2b: one
    ``F.scaled_dot_product_attention`` call (and its autograd backward for
    q, k, v) on the same inputs, under every backend that takes them; the
    additive ``bias[h] + mask[w]`` is built once in q's dtype outside the
    timed region, its last axis padded to a multiple of 8 in memory for the
    fused backends. Device time by ``graph_ms``, as the kernels'. Timed
    here only: the port never calls it. Returns the fastest of each as
    ((forward ms, backend), (backward ms, backend))."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from rscotr_tpu_torch.ops.window_attention import window_attention_torch
    B, nW, H, n, hd = q.shape
    add = bias[None, None]
    if mask is not None:
        add = add + mask[None, :, None]
    buf = torch.zeros(B * nW, H, n, -(-n // 8) * 8, dtype=q.dtype,
                      device=q.device)
    buf[..., :n] = add.expand(B, nW, H, n, n).reshape(B * nW, H, n, n)
    attn = buf[..., :n]
    qq, kk, vv = (t.detach().reshape(B * nW, H, n, hd).contiguous()
                  .requires_grad_() for t in (q, k, v))
    do = d_out.reshape(qq.shape)
    ref = window_attention_torch(q.float(), k.float(), v.float(), bias, mask,
                                 scale)

    def fwd():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn,
                                              scale=scale)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qq, kk, vv), do)

    fwd_ms, bwd_ms = {}, {}
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.MATH):
        # a backend that does not take these inputs raises: reported, not
        # timed (this is a yardstick, no path of the port)
        try:
            with sdpa_kernel(backend):
                with torch.no_grad():
                    e = (fwd().float().reshape(ref.shape) - ref).abs().max(
                        ).item()
                    f_ms = graph_ms(fwd)
                # the backward alone: forward + backward less the forward
                # (in grad mode), each captured whole so that both run on
                # the capture's stream
                b_ms = graph_ms(fwd_bwd) - graph_ms(fwd)
        except RuntimeError:
            log(f"  library {name:<12} SDPA {backend.name} refused the "
                "inputs")
            continue
        if not e < 5e-2:
            fail(f"SDPA yardstick {name} {backend.name}: not the same "
                 f"function (max abs diff {e:.3e} from the plain version)")
        fwd_ms[backend.name], bwd_ms[backend.name] = f_ms, b_ms
        log(f"  library {name:<12} SDPA {backend.name:<20} forward "
            f"{fwd_ms[backend.name]:.4f} ms, backward (dq, dk, dv; no bias "
            f"gradient) {bwd_ms[backend.name]:.4f} ms; max abs diff from "
            f"plain {e:.2e}")
    best = [min((ms, b) for b, ms in t.items()) for t in (fwd_ms, bwd_ms)]
    log(f"  library {name:<12} fastest: forward {best[0][1]} "
        f"{best[0][0]:.4f} ms, backward {best[1][1]} {best[1][0]:.4f} ms")
    return best


def index_add_yardstick(d_g, gidx, num_rows, want):
    """The library yardstick of K3': one bare ``index_add_`` of the f32
    updates into the f32 (G * num_rows + 1, C) table (the spare row takes
    the out-of-range updates, which K3' drops; cast, index arithmetic and
    zeroing are outside the timed region). Device time by ``graph_ms``, as
    the kernel's. Timed here only."""
    G, K, C = d_g.shape
    src = d_g.float().reshape(G * K, C)
    idx = gidx.long()
    valid = (idx >= 0) & (idx < num_rows)
    base = torch.arange(G, device=d_g.device)[:, None] * num_rows
    flat = torch.where(valid, idx + base, G * num_rows).reshape(-1)
    out = torch.zeros(G * num_rows + 1, C, device=d_g.device)
    out.index_add_(0, flat, src)
    e = (out[:-1].reshape(want.shape) - want).abs().max().item()
    if not e <= 1e-4 * want.abs().max().item():
        fail(f"index_add_ yardstick: not the same function ({e:.3e})")
    ms = graph_ms(lambda: out.index_add_(0, flat, src))
    log(f"  library K3' index_add_ of f32 (G*K, C) = ({G * K}, {C}) into "
        f"({G * num_rows + 1}, {C}): {ms:.4f} ms")
    return ms


def bmm_yardstick(gq, wt, want):
    """The library yardstick of K4: one ``torch.bmm`` of the weights in
    k-major order, (R, 1, 4 KP), by g's rows as (R, 4 KP, D), R = G Q (a
    row of g is (KP, 4, D) contiguous; the reorder of the weights is outside
    the timed call), with a float32 output where the installed torch's bmm
    takes ``out_dtype``, else in g's dtype. Device time by ``graph_ms``, as
    the kernel's. Timed here only: (ms, what was called)."""
    G, Q, KP, C4 = gq.shape
    R, D = G * Q, C4 // 4
    a = wt.view(R, 4, KP).transpose(1, 2).reshape(R, 1, 4 * KP)
    b = gq.view(R, 4 * KP, D)
    lib = "torch.bmm(wt k-major (R, 1, 4 KP), g (R, 4 KP, D)"
    try:
        got = torch.bmm(a, b, out_dtype=torch.float32)
        lib += ", out_dtype=torch.float32)"

        def call():
            return torch.bmm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        got = torch.bmm(a, b)
        lib += f") with a {str(gq.dtype)[6:]} output: this torch's bmm " \
               "takes no out_dtype"

        def call():
            return torch.bmm(a, b)
    check_close("library K4 torch.bmm", got.view(G, Q, D), want, gq.dtype)
    ms = graph_ms(call)
    log(f"  library K4 {lib}: {ms:.4f} ms")
    return ms, lib


def corners_on_map(shapes, loc) -> int:
    """How many of the sampling points' 4 x points bilinear corners lie on
    their level's map: the corner rows K1 and K1b load."""
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device=loc.device)[:, None]
    x0 = torch.floor(loc * wh - 0.5)                  # (B, Q, H, L, P, 2)
    on = [((x0 + d >= 0) & (x0 + d < wh)).long() for d in (0, 1)]
    return int(sum((on[dy][..., 1] * on[dx][..., 0]).sum()
                   for dy in (0, 1) for dx in (0, 1)))


# K1 cases: name -> (B, Q, levels, location span, timed). The timed cases
# use a model's locations, [0, 1], where nearly every corner is on the map;
# the det encoder is also timed at [-0.2, 1.2], the span of the first
# kernel's earlier times, where about half the corners are off the map and
# skipped.
K1_SPAN = (-0.2, 1.2)
K1_CASES = {
    "det-encoder B=1 loc in [0, 1]": (1, None, DET_SHAPES, (0.0, 1.0), True),
    "det-encoder B=1": (1, None, DET_SHAPES, K1_SPAN, True),
    "det-encoder B=4 loc in [0, 1]": (4, None, DET_SHAPES, (0.0, 1.0), True),
    "det-encoder B=4": (4, None, DET_SHAPES, K1_SPAN, False),
    "decoder B=1 Q=600": (1, 600, DET_SHAPES, K1_SPAN, False),
    "train decoder B=1 Q=800 loc in [0, 1]": (1, 800, DET_SHAPES, (0.0, 1.0),
                                              True),
    "seg-encoder B=1 loc in [0, 1]": (1, None, SEG_SHAPES, (0.0, 1.0), True),
    "seg-encoder B=1": (1, None, SEG_SHAPES, K1_SPAN, False),
    "seg-encoder B=4 loc in [0, 1]": (4, None, SEG_SHAPES, (0.0, 1.0), True),
    "seg-encoder B=4": (4, None, SEG_SHAPES, K1_SPAN, False),
    "paper cls-encoder B=16": (16, None, CLS_SHAPES, K1_SPAN, False),
    "RSCoTrSeg-R50 encoder B=2 L=3": (2, None, RSEG_SHAPES, K1_SPAN, False),
}
K1_HEADLINE = "det-encoder B=1 loc in [0, 1]"


def k1_phase(err, times):
    """K1 against its plain version at the flagship's shapes, both bodies
    on the same tensors: the vector body (what ``msda_fwd_body`` picks, and
    every model-path launch takes) and the lane-per-channel body (the
    parent's kernel, ``body=BODY_LANE``). The timed cases give device times
    of both by graph replay, the eager time, the plain version's, the bound
    and the modelled L2 traffic."""
    from rscotr_tpu_torch.ops.ms_deform_attn import (
        BODY_LANE, BODY_VEC, _ms_deform_attn_cuda, ms_deform_attn,
        ms_deform_attn_torch, msda_fwd_body)
    g = torch.Generator(device="cuda").manual_seed(0)
    log("kernel phase: K1 msda_fwd, vector and lane bodies, vs "
        "ms_deform_attn_torch")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (B, Q, lvls, span, timed) in K1_CASES.items():
            Q = Q or sum(h * w for h, w in lvls)
            v, shapes, loc, w = msda_inputs(B, Q, dtype, g, shapes=lvls,
                                            span=span)
            if msda_fwd_body(v.shape[-1], [v.data_ptr(), loc.data_ptr()]) \
                    != BODY_VEC:
                fail(f"K1 {name}: the case does not take the vector body")
            before = (ms_deform_attn.launches, ms_deform_attn.vec_launches)
            got = ms_deform_attn(v, shapes, loc, w)
            lane = _ms_deform_attn_cuda(v, shapes, loc, w, body=BODY_LANE)
            torch.cuda.synchronize()
            if (ms_deform_attn.launches, ms_deform_attn.vec_launches) != \
                    (before[0] + 2, before[1] + 1):
                fail(f"K1 {name}: not one vector and one lane launch")
            ref = ms_deform_attn_torch(v.float(), shapes, loc, w.float())
            e = check_close(f"K1 {name}", got, ref, dtype)
            check_close(f"K1 {name} (lane body)", lane, ref, dtype)
            err["K1"][bf] = max(err["K1"][bf], e)
            if not (timed and bf):
                continue
            D = v.shape[-1]
            on_map = corners_on_map(shapes, loc)
            # one multiply-add per channel of each corner on the map
            ms, by = bound((v, loc, w, got), 2.0 * D * on_map, "f32")

            def vec():
                return ms_deform_attn(v, shapes, loc, w)

            def lane_body():
                return _ms_deform_attn_cuda(v, shapes, loc, w,
                                            body=BODY_LANE)

            times[f"K1 {name}"] = dict(
                ms=graph_ms(vec), eager_ms=cuda_ms(vec, 50),
                lane_ms=graph_ms(lane_body),
                plain_ms=cuda_ms(
                    lambda: ms_deform_attn_torch(v, shapes, loc, w), 10),
                bound_ms=ms, bound_by=by, library_ms=None)
            # a model of the L2 traffic, not a reading: one row load per
            # corner on the map
            rows = on_map * D * v.element_size()
            rate = rows / 1e9 / times[f"K1 {name}"]["ms"]
            log(f"  K1 {name}: {on_map} corners on the map, {rows / 1e6:.1f}"
                " MB of corner rows from L2 (modelled from the corner count,"
                f" no counter read): {rate:.2f} TB/s over the vector body's "
                "time")


def kernel_phase():
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}   # [f32, bf16]
    times = {}
    k1_phase(err, times)
    log("kernel phase: K2 window_attn vs window_attention_torch (the plain "
        "version at the kernel's dtype: for bf16 it rounds P where the "
        "kernel does)")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (B, nW, H, shifted), kw in k2_cases():
            for masked in sorted({False, shifted}):
                timed = bool(bf and masked == shifted and name in TIMED_K2)
                if timed:
                    q, k, v, bias, mask, scale, _ = timed_wa_inputs(name)
                else:
                    q, k, v, bias, mask, scale = wa_inputs(
                        B, nW, H, masked, dtype, g, **kw)
                before = window_attention.launches
                got = window_attention(q, k, v, bias, mask, scale)
                torch.cuda.synchronize()
                if window_attention.launches != before + 1:
                    fail(f"K2 {name}: the wrapper counted no launch")
                ref = window_attention_torch(q, k, v, bias, mask, scale)
                e = check_close(
                    f"K2 {name} {'masked' if masked else ''}", got,
                    ref.float(), dtype,
                    k2_ulp_slack(q, k, v, bias, mask, scale) if bf else None)
                err["K2"][bf] = max(err["K2"][bf], e)
                if timed:
                    n, hd = q.shape[-2:]
                    tiles = B * nW * H
                    ms, by = bound((q, k, v, bias, mask, got),
                                   4.0 * n * n * hd * tiles, "bf16 tensor")
                    def run():
                        return window_attention(q, k, v, bias, mask, scale)

                    # ms: device time (graph replay), as library_ms; the
                    # kernel is shorter than its wrapper's host time, which
                    # eager_ms (events around eager calls) includes
                    times[f"K2 {name}"] = dict(
                        ms=graph_ms(run), eager_ms=cuda_ms(run, 50),
                        plain_ms=cuda_ms(lambda: window_attention_torch(
                            q, k, v, bias, mask, scale), 20),
                        bound_ms=ms, bound_by=by, library_ms=None)
    log_times(times)
    return err, times


def quad_phase():
    """K4 / K5 and the quad-gather MSDA at the det encoder: the main path's
    run (``impl="quad"`` forward + backward, bf16, which also launches K3',
    the value-gradient scatter of this path; K4, K5 and K3' must take their
    vector bodies), K4 / K5 against their plain versions (both bodies of
    each), the quad path against the K1 path, times (K4 also its library
    yardstick) and peak memory."""
    from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.ops.msda_ws import (_ws_bwd_cuda, _ws_fwd_cuda,
                                              ws_bwd, ws_bwd_torch, ws_fwd,
                                              ws_fwd_torch)
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    g = torch.Generator(device="cuda").manual_seed(2)
    Nv = sum(h * w for h, w in DET_SHAPES)
    G, KP, D = 8, 16, 32
    log("quad phase: ms_deform_attn(impl=\"quad\") at the det encoder B=1 "
        "Q=Nv=13294 H=8 L=4 P=4 D=32")
    # -- the main path's run: one quad forward + backward, bf16 ----------
    v, shapes, loc, w = msda_inputs(1, Nv, torch.bfloat16, g)
    leaves = tuple(t.requires_grad_() for t in (v, loc, w))
    d_out = torch.randn(1, Nv, 8 * D, device="cuda",
                        generator=g).to(torch.bfloat16)
    for fn in (ws_fwd, ws_bwd, scatter_add_mm):
        fn.launches = 0
    ws_fwd.vec_launches = ws_bwd.vec_launches = 0
    scatter_add_mm.vec_launches = 0
    out = ms_deform_attn(v, shapes, loc, w, impl="quad")
    grads = torch.autograd.grad(out, leaves, d_out)
    torch.cuda.synchronize()
    launches = {"K4": ws_fwd.launches, "K5": ws_bwd.launches,
                "K3'": scatter_add_mm.launches,
                "K4 vec": ws_fwd.vec_launches,
                "K5 vec": ws_bwd.vec_launches,
                "K3' vec": scatter_add_mm.vec_launches}
    log(f"  launches in the main path's run: {launches} (want 1 each: K4, "
        "K5 and K3' on their vector bodies)")
    if set(launches.values()) != {1}:
        fail(f"quad path: kernel launches {launches} != 1 each")
    if not (torch.isfinite(out).all() and
            all(torch.isfinite(t).all() for t in grads)):
        fail("quad path: non-finite output or gradient")
    del out, grads

    log("quad phase: K4 ws_fwd vs ws_fwd_torch, K5 ws_bwd vs ws_bwd_torch "
        "at g (8, 13294, 16, 128)")
    err = {"K4": [0.0, 0.0], "K5": [0.0, 0.0]}   # [f32, bf16]
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        gq = torch.randn(G, Nv, KP, 4 * D, device="cuda",
                         generator=g).to(dtype)
        # the quad path hands K4 / K5 its slot weights in value's dtype
        wt = torch.rand(G, Nv, 4 * KP, device="cuda", generator=g).to(dtype)
        dq = torch.randn(G, Nv, D, device="cuda", generator=g)
        vec = ws_fwd.vec_launches
        k4_out = ws_fwd(gq, wt)
        k4_row = _ws_fwd_cuda(gq, wt, body=BODY_LANE)
        torch.cuda.synchronize()
        if ws_fwd.vec_launches != vec + 1:
            fail("K4 det-encoder: not one launch on the vector body")
        k4_ref = ws_fwd_torch(gq, wt)
        err["K4"][bf] = check_close("K4 det-encoder", k4_out, k4_ref, dtype)
        check_close("K4 det-encoder (warp-per-row body)", k4_row, k4_ref,
                    dtype)
        del k4_row
        vec = ws_bwd.vec_launches
        got = ws_bwd(gq, wt, dq)
        row = _ws_bwd_cuda(gq, wt, dq, body=BODY_LANE)
        torch.cuda.synchronize()
        if ws_bwd.vec_launches != vec + 1:
            fail("K5 det-encoder: not one launch on the vector body")
        ref = ws_bwd_torch(gq, wt, dq)
        # d_g is one f32 product rounded once to g's dtype on both sides
        if not (torch.equal(got[0], ref[0]) and torch.equal(row[0], ref[0])):
            fail("K5 d_g differs from its plain version")
        err["K5"][bf] = check_grads("K5 det-encoder", got, ref,
                                    ("d_g", "d_wt"), dtype)
        check_grads("K5 det-encoder (warp-per-row body)", row, ref,
                    ("d_g", "d_wt"), dtype)
        del row
        if bf:
            # K4: one multiply-add per element of g; K5: one product for
            # d_g and one multiply-add for d_wt per element of g
            # ms: device time (graph replay); eager_ms: events around eager
            # calls, the wrapper's host time included
            ms, by = bound((gq, wt, k4_out), 2.0 * gq.numel(), "f32")
            lib_ms, lib = bmm_yardstick(gq, wt, k4_ref)
            times["K4 det-encoder"] = dict(
                ms=graph_ms(lambda: ws_fwd(gq, wt)),
                eager_ms=cuda_ms(lambda: ws_fwd(gq, wt), 50),
                row_ms=graph_ms(lambda: _ws_fwd_cuda(gq, wt,
                                                     body=BODY_LANE)),
                plain_ms=cuda_ms(lambda: ws_fwd_torch(gq, wt), 10),
                bound_ms=ms, bound_by=by, library_ms=lib_ms, library=lib)
            ms, by = bound((gq, wt, dq) + tuple(got), 3.0 * gq.numel(),
                           "f32")
            times["K5 det-encoder"] = dict(
                ms=graph_ms(lambda: ws_bwd(gq, wt, dq)),
                eager_ms=cuda_ms(lambda: ws_bwd(gq, wt, dq), 50),
                row_ms=graph_ms(lambda: _ws_bwd_cuda(gq, wt, dq,
                                                     body=BODY_LANE)),
                plain_ms=cuda_ms(lambda: ws_bwd_torch(gq, wt, dq), 10),
                bound_ms=ms, bound_by=by, library_ms=None)
        del got, ref, k4_out, k4_ref, gq, wt, dq

    # f32: the two paths sum in other orders (BTOL); bf16: the quad path
    # rounds its slot weights to bf16 before K4 (as JAX's
    # _ms_deform_attn_xla) and d_wt back to bf16 after K5, the K1 path keeps
    # corner weights in f32, and both round the output: two bf16 ulps of the
    # largest entry
    log("quad phase: impl=\"quad\" vs impl=\"kernel\" (K1, K1b), "
        "forward and torch.autograd.grad")
    qtol = {torch.float32: BTOL[torch.float32], torch.bfloat16: (2.0 ** -6,
                                                                 0.0)}
    for dtype in (torch.float32, torch.bfloat16):
        v, shapes, loc, w = msda_inputs(1, Nv, dtype, g)
        leaves = tuple(t.requires_grad_() for t in (v, loc, w))
        d_out = torch.randn(1, Nv, 8 * D, device="cuda", generator=g).to(dtype)
        res = {}
        for impl in ("quad", "kernel"):
            o = ms_deform_attn(v, shapes, loc, w, impl=impl)
            res[impl] = (o.detach(),) + torch.autograd.grad(o, leaves, d_out)
        torch.cuda.synchronize()
        check_grads("quad vs kernel", res["quad"], res["kernel"],
                    ("out", "d_value", "d_loc", "d_attn"), dtype,
                    tol=qtol[dtype])
        del res
        if dtype == torch.bfloat16:
            for impl in ("quad", "kernel"):
                def fwd():
                    with torch.no_grad():
                        ms_deform_attn(v, shapes, loc, w, impl=impl)

                def fwd_bwd():
                    o = ms_deform_attn(v, shapes, loc, w, impl=impl)
                    torch.autograd.grad(o, leaves, d_out)

                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fwd_bwd()
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
                times[f"MSDA {impl}"] = (cuda_ms(fwd, 20),
                                         cuda_ms(fwd_bwd, 20), peak)
    log_times({k: r for k, r in times.items() if k[:2] in ("K4", "K5")})
    for impl in ("quad", "kernel"):
        fwd, fwd_bwd, peak = times[f"MSDA {impl}"]
        log(f"  time bf16 MSDA impl={impl:<6} forward {fwd:.4f} ms, forward "
            f"+ backward {fwd_bwd:.4f} ms; peak {peak:.1f} MiB above the "
            "inputs")
    return err, times, launches


def k6_phase():
    """K6 through the probe tool: its parity check, K6 against its plain
    version at the tool's det-encoder level shapes, then the tool's
    per-level timing (the main path's run)."""
    from rscotr_tpu_torch.tools import probe_msda_weighted_gather_mm as probe
    dev = torch.device("cuda")
    log("K6 phase: probe_msda_weighted_gather_mm parity check")
    probe.parity(dev)
    log("K6 phase: weighted_gather_mm vs weighted_gather_mm_torch at G=8, "
        "K=53376, C=128, indices in [-2, Nv + 2)")
    g = torch.Generator(device="cuda").manual_seed(3)
    err = [0.0, 0.0]                               # [f32, bf16]
    for h, wd in probe.LEVELS:
        nv = h * wd
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(8, nv, 128, device="cuda",
                                generator=g).to(dtype)
            idx = torch.randint(-2, nv + 2, (8, 53376), device="cuda",
                                generator=g, dtype=torch.int32)
            w = torch.rand(8, 53376, device="cuda", generator=g)
            got = probe.weighted_gather_mm(table, idx, w, acc_dtype=dtype)
            torch.cuda.synchronize()
            ref = probe.weighted_gather_mm_torch(table, idx, w,
                                                 acc_dtype=dtype)
            d = (got - ref).abs()
            e = d.max().item()
            log(f"  K6 nv={nv:<6} {str(dtype)[6:]:<8} max_abs_err {e:.3e} "
                f"(tol {probe.PLAIN_RTOL:g}*|ref|: the same one product)")
            if (d - probe.PLAIN_RTOL * ref.abs()).max().item() > 0:
                fail(f"K6 nv={nv}: kernel disagrees with its plain version")
            err[dtype == torch.bfloat16] = max(err[dtype == torch.bfloat16],
                                               e)
    # -- the main path's run: the tool's per-level timing -----------------
    log("K6 phase: the probe's per-level timing (K6 vs production_level_"
        "slice, bf16, 20 x 8 chained calls per level)")
    iters, chain = 20, 8
    probe.weighted_gather_mm.launches = 0
    levels = probe.time_levels(dev, iters=iters, chain=chain)
    launches = probe.weighted_gather_mm.launches
    want = len(probe.LEVELS) * (iters + 1) * chain
    log(f"  launches in the main path's run: K6 {launches} (want {want})")
    if launches != want:
        fail(f"K6: {launches} launches in the probe's timing, want {want}")
    return err, levels, launches


def tiny_inputs():
    rng = np.random.default_rng(0)
    cls_img = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    det_img = rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    hw = np.array([[128, 128], [100, 120]], np.int32)
    return cls_img, det_img, hw


def tiny_seg_inputs():
    """A 2 x 64^2 batch (whole mode) and a 1 x 64 x 96 one (slide mode: two
    64^2 windows at stride 32). Seed 3 keeps every attention-mask logit of
    the seed-0 tiny model at least 1.7e-3 from the threshold."""
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            rng.integers(0, 256, (1, 64, 96, 3)).astype(np.uint8))


SEG_SLIDE = dict(mode="slide", crop_size=(64, 64), stride=(32, 32))


def seg_mask_margin(model, imgs, seg_test_cfg):
    """The smallest |resized mask logit| entering any attention-mask
    threshold of the seg head over ``infer["seg"]`` of each image batch (a
    logit within float error of 0 would flip a mask bit between devices)."""
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models.heads import mask2former_head as m2f
    seen = []
    resize = m2f._interpolate

    def spy(x, hw):
        out = resize(x, hw)
        seen.append(out.abs().min().item())
        return out

    m2f._interpolate = spy
    try:
        steps = make_infer_steps(model, seg_test_cfg=seg_test_cfg)
        for img in imgs:
            steps["seg"](img)
    finally:
        m2f._interpolate = resize
    return min(seen)


def slice_parity_phase():
    from rscotr_tpu_torch.engine import device_normalize, make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_model_cfg
    log("slice parity phase: tiny config (cls, det, seg), CPU (plain) vs "
        "CUDA (kernels), float32, TF32 off")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_model_cfg(TINY_CFG)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    cls_img, det_img, hw = tiny_inputs()
    seg_whole, seg_slide = tiny_seg_inputs()
    slide = (seg_slide[:, :, :64], seg_slide[:, :, 32:])
    margin = min(seg_mask_margin(cpu, (seg_whole,), cfg["test_cfg"]["seg"]),
                 seg_mask_margin(cpu, slide, None))
    log(f"  seg: smallest |resized mask logit| at an attention-mask "
        f"threshold {margin:.3e} (must exceed 10 x {SLICE_TOL:g})")
    if not margin > 10 * SLICE_TOL:
        fail("slice parity: a seg attention-mask logit lies within 10x the "
             "tolerance of the threshold; pick other inputs")
    sf = np.ones((2, 4), np.float32)
    results = {}
    for key, model in (("cpu", cpu), ("cuda", gpu)):
        dev = next(model.parameters()).device
        steps = make_infer_steps(model, max_per_img=50,
                                 seg_test_cfg=cfg["test_cfg"]["seg"])
        slide_steps = make_infer_steps(model, seg_test_cfg=SEG_SLIDE)
        with torch.inference_mode():
            img_hw = torch.as_tensor(hw, device=dev)
            img = device_normalize(torch.as_tensor(det_img, device=dev),
                                   None, img_hw)
            all_cls, all_coords, _, _ = model.forward_det(img, img_hw)
        det, labels = steps["det"](det_img, hw, sf)
        results[key] = dict(
            cls=steps["cls"](cls_img), all_cls=all_cls,
            all_coords=all_coords, det=det, labels=labels,
            seg_whole=steps["seg_logits"](seg_whole),
            seg_slide=slide_steps["seg_logits"](seg_slide),
            seg_labels=(steps["seg"](seg_whole),
                        slide_steps["seg"](seg_slide)))
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    for key in ("cls", "all_cls", "all_coords", "det", "seg_whole",
                "seg_slide"):
        a, b = results["cpu"][key], results["cuda"][key].cpu()
        e = (a - b).abs().max().item()
        tol = SLICE_TOL * (max(hw.max(), 1) if key == "det" else 1)
        log(f"  {key:<11} shape {tuple(a.shape)} max_abs_err {e:.3e} "
            f"(tol {tol:g})")
        if not e <= tol:
            fail(f"slice parity: {key} differs between CPU and CUDA")
    if not torch.equal(results["cpu"]["labels"],
                       results["cuda"]["labels"].cpu()):
        fail("slice parity: det labels differ between CPU and CUDA")
    # seg labels: equal wherever the top two logits are more than 10x the
    # tolerance apart (elsewhere either label is right)
    for mode, logits, a, b in (
            ("whole", results["cpu"]["seg_whole"],
             *[r["seg_labels"][0].cpu() for r in results.values()]),
            ("slide", results["cpu"]["seg_slide"],
             *[r["seg_labels"][1].cpu() for r in results.values()])):
        top2 = logits.topk(2, -1).values
        clear = top2[..., 0] - top2[..., 1] > 10 * SLICE_TOL
        log(f"  seg labels ({mode}) {tuple(a.shape)}: equal on the "
            f"{clear.float().mean().item():.4f} of pixels whose top two "
            "logits are more than 10x the tolerance apart")
        if clear.float().mean() < 0.99 or not torch.equal(a[clear],
                                                          b[clear]):
            fail(f"slice parity: seg labels ({mode}) differ between CPU and "
                 "CUDA")


def check_grads(name, gots, refs, names, dtype, tol=None,
                slacks=None) -> float:
    """Hold each gradient against its plain version; one log line per case
    with each gradient's max abs error / max|ref|. Returns the largest
    max abs error. ``tol`` (atol scale, rtol) defaults to ``BTOL``;
    ``slacks``: per gradient, a tensor of further allowance or None."""
    atol, rtol = tol or BTOL[dtype]
    parts, worst = [], 0.0
    for i, (gname, got, ref) in enumerate(zip(names, gots, refs)):
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            fail(f"{name} {gname}: non-finite kernel gradient")
        err = (got - ref).abs()
        scale = ref.abs().max().item()
        max_err = err.max().item()
        slack = 0 if slacks is None or slacks[i] is None else slacks[i]
        over = err - rtol * ref.abs()
        if (over - slack).max().item() > atol * scale:
            fail(f"{name} {gname}: kernel gradient disagrees with the plain "
                 f"version (max_abs_err {max_err:.3e})")
        share = "" if slacks is None or slacks[i] is None else \
            f" ({(over > atol * scale).float().mean().item():.1e} need " \
            "P_FLIPS)"
        parts.append(f"{gname} {max_err:.2e}/{scale:.3g}{share}")
        worst = max(worst, max_err)
    log(f"  {name:<34} {str(dtype)[6:]:<8} max_abs_err/max|ref|: "
        f"{', '.join(parts)}  (tol {atol:g}*max|ref| + {rtol:g}*|ref|)")
    return worst


def backward_phase():
    from rscotr_tpu_torch.ops.ms_deform_attn import (
        BODY_LANE, BODY_VEC, _msda_bwd_cuda, ms_deform_attn,
        ms_deform_attn_bwd, ms_deform_attn_bwd_torch, msda_bwd_body,
        msda_bwd_rows_torch)
    from rscotr_tpu_torch.ops.scatter_mm import (_scatter_add_cuda,
                                                 scatter_add_mm,
                                                 scatter_add_mm_torch)
    from rscotr_tpu_torch.ops.window_attention import (
        window_attention, window_attention_bwd, window_attention_bwd_torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    err = {k: [0.0, 0.0] for k in ("K1b", "K3", "K2b")}   # [f32, bf16]
    times = {}
    Nv = sum(h * w for h, w in DET_SHAPES)
    seg_nv = sum(h * w for h, w in SEG_SHAPES)
    log("backward phase: K1b msda_bwd (autograd through ms_deform_attn: one "
        "launch, the value-gradient scatter fused in) vs "
        "ms_deform_attn_bwd_torch")
    # name: msda_inputs arguments, the body the launch must take, timed.
    # The timed det-encoder case runs twice: with the locations of every
    # other kernel case, [-0.2, 1.2], which leave about half the corners
    # off the map (skipped), and with [0, 1], where nearly every corner is
    # loaded and reduced, as a model's locations mostly are.
    cases = {
        "det-encoder B=1": (dict(B=1, Q=Nv), BODY_VEC, True),
        "det-encoder B=1 loc in [0, 1]": (dict(B=1, Q=Nv, span=(0.0, 1.0)),
                                          BODY_VEC, True),
        "train decoder B=1 Q=800": (dict(B=1, Q=800), BODY_VEC, True),
        "seg-encoder B=4": (dict(B=4, Q=seg_nv, shapes=SEG_SHAPES),
                            BODY_VEC, False),
        "head width 64 Q=4000 H=4": (dict(B=1, Q=4000, H=4, D=64), BODY_VEC,
                                     False),
        "head width 24 Q=4000 (lane body)": (dict(B=1, Q=4000, D=24),
                                             BODY_LANE, False),
        "edge locations [-0.1, 1.1]": (dict(B=1, Q=4000, span=(-0.1, 1.1)),
                                       BODY_VEC, False),
        "paper cls-encoder B=16": (dict(
            B=16, Q=sum(h * w for h, w in CLS_SHAPES), shapes=CLS_SHAPES),
            BODY_VEC, False),
        "RSCoTrSeg-R50 encoder B=2 L=3": (dict(
            B=2, Q=sum(h * w for h, w in RSEG_SHAPES), shapes=RSEG_SHAPES),
            BODY_VEC, False),
    }
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (kw, body, timed) in cases.items():
            v, shapes, loc, w = msda_inputs(dtype=dtype, g=g, **kw)
            if msda_bwd_body(v.shape[-1], [v.data_ptr()]) != body:
                fail(f"K1b {name}: not the body the case is meant for")
            v, loc, w = (t.requires_grad_() for t in (v, loc, w))
            out = ms_deform_attn(v, shapes, loc, w)
            d_out = torch.randn(out.shape, device="cuda",
                                generator=g).to(dtype)
            before = (ms_deform_attn_bwd.launches, scatter_add_mm.launches)
            got = torch.autograd.grad(out, (v, loc, w), d_out)
            torch.cuda.synchronize()
            if (ms_deform_attn_bwd.launches, scatter_add_mm.launches) != \
                    (before[0] + 1, before[1]):
                fail(f"K1b {name}: the backward is not one K1b launch")
            v, loc, w = v.detach(), loc.detach(), w.detach()
            ref = ms_deform_attn_bwd_torch(v, shapes, loc, w, d_out)
            e = check_grads(f"K1b {name}", got, ref,
                            ("d_value", "d_loc", "d_attn"), dtype)
            err["K1b"][bf] = max(err["K1b"][bf], e)
            if not timed:
                continue
            if bf:
                args = (v, shapes, loc, w, d_out)
                D = v.shape[-1]
                on_map = corners_on_map(shapes, loc)
                # per corner on the map: D multiply-adds for <V_c, d_out>,
                # D products and D atomic adds for d_value
                ms, by = bound((v, loc, w, d_out) + got, 4.0 * D * on_map,
                               "f32")
                # a model of the L2 traffic, not a reading: each corner
                # row loaded, each accumulator row read and written by its
                # reduction
                l2 = on_map * D * (v.element_size() + 8)
                log(f"  K1b {name}: {on_map} corners on the map; corner "
                    f"rows loaded {on_map * D * v.element_size() / 1e6:.1f} "
                    f"MB, accumulator rows reduced into "
                    f"{on_map * D * 8 / 1e6:.1f} MB (read + write), "
                    f"{1e3 * l2 / HBM_BYTES_PER_S:.4f} ms at the device-"
                    "memory rate (modelled from the corner count)")
                acc = torch.zeros(v.shape, device="cuda")

                def kernel():
                    _msda_bwd_cuda(*args, acc=acc)

                times[f"K1b {name}"] = dict(
                    ms=graph_ms(kernel), eager_ms=cuda_ms(kernel, 50),
                    whole_ms=graph_ms(lambda: ms_deform_attn_bwd(*args)),
                    whole_eager_ms=cuda_ms(
                        lambda: ms_deform_attn_bwd(*args), 50),
                    plain_ms=cuda_ms(
                        lambda: ms_deform_attn_bwd_torch(*args), 5),
                    bound_ms=ms, bound_by=by, library_ms=None)
                del acc
            if name.startswith("edge") or kw.get("shapes") in (CLS_SHAPES,
                                                               RSEG_SHAPES):
                continue
            # K3' alone, on the plain backward's quad-row updates (C = 4 D):
            # the vector body, and the scalar body forced on the same tensors
            d_g, gidx = msda_bwd_rows_torch(v, shapes, loc, w, d_out)[:2]
            d_g, gidx = d_g.contiguous(), gidx.contiguous()
            rows = v.shape[1]
            vec = scatter_add_mm.vec_launches
            d_qt = scatter_add_mm(d_g, gidx, rows)
            scalar = _scatter_add_cuda(d_g, gidx, torch.zeros_like(d_qt),
                                       body=BODY_LANE)
            torch.cuda.synchronize()
            if scatter_add_mm.vec_launches != vec + 1:
                fail(f"K3' {name}: not one launch on the vector body")
            want = scatter_add_mm_torch(d_g, gidx, rows)
            e = check_grads(f"K3' {name}", [d_qt], [want], ("d_qt",),
                            torch.float32)
            check_grads(f"K3' {name} (scalar body)", [scalar], [want],
                        ("d_qt",), torch.float32)
            err["K3"][bf] = max(err["K3"][bf], e)
            del scalar, want
            # timed at the det encoder, both location spans: the kernel
            # alone into a zeroed accumulator as ``ms``, the whole wrapper
            # (zero fill and kernel) as ``whole_ms``
            if bf and kw["Q"] == Nv and kw["B"] == 1:
                acc = torch.zeros_like(d_qt)

                def kernel():
                    _scatter_add_cuda(d_g, gidx, acc)

                # one f32 add per update element
                ms, by = bound((d_g, gidx, d_qt), float(d_g.numel()), "f32")
                times[f"K3' {name}"] = dict(
                    ms=graph_ms(kernel), eager_ms=cuda_ms(kernel, 20),
                    scalar_ms=graph_ms(lambda: _scatter_add_cuda(
                        d_g, gidx, acc, body=BODY_LANE)),
                    whole_ms=graph_ms(lambda: scatter_add_mm(d_g, gidx,
                                                             rows)),
                    whole_eager_ms=cuda_ms(
                        lambda: scatter_add_mm(d_g, gidx, rows), 20),
                    plain_ms=cuda_ms(
                        lambda: scatter_add_mm_torch(d_g, gidx, rows), 5),
                    bound_ms=ms, bound_by=by,
                    library_ms=index_add_yardstick(d_g, gidx, rows, d_qt))
                del acc
            del d_g, gidx, d_qt
    log("backward phase: K2b window_attn_bwd (autograd through "
        "window_attention) vs window_attention_bwd_torch")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (B, nW, H, shifted), kw in k2_cases():
            for masked in sorted({False, shifted}):
                timed = bool(bf and masked == shifted and name in TIMED_K2)
                if timed:
                    q, k, v, bias, mask, scale, d_out = timed_wa_inputs(name)
                else:
                    q, k, v, bias, mask, scale = wa_inputs(
                        B, nW, H, masked, dtype, g, **kw)
                    d_out = torch.randn(q.shape, device="cuda",
                                        generator=g).to(dtype)
                q, k, v, bias = (t.requires_grad_() for t in (q, k, v, bias))
                out = window_attention(q, k, v, bias, mask, scale)
                before = window_attention_bwd.launches
                got = torch.autograd.grad(out, (q, k, v, bias), d_out)
                torch.cuda.synchronize()
                if window_attention_bwd.launches != before + 1:
                    fail(f"K2b {name}: the wrapper counted no launch")
                q, k, v, bias = (t.detach() for t in (q, k, v, bias))
                ref = window_attention_bwd_torch(q, k, v, bias, mask, scale,
                                                 d_out)
                e = check_grads(
                    f"K2b {name}{' masked' if masked else ''}", got, ref,
                    ("dq", "dk", "dv", "d_rel_bias"), dtype,
                    slacks=k2_ulp_slack(q, k, v, bias, mask, scale, d_out)
                    if bf else None)
                err["K2b"][bf] = max(err["K2b"][bf], e)
                if timed:
                    args = (q, k, v, bias, mask, scale, d_out)
                    n, hd = q.shape[-2:]
                    # five n x n x hd products per tile: S, dP, dV, dQ, dK
                    ms, by = bound((q, k, v, bias, mask, d_out) + got,
                                   10.0 * n * n * hd * B * nW * H,
                                   "bf16 tensor")
                    times[f"K2b {name}"] = dict(
                        ms=graph_ms(lambda: window_attention_bwd(*args)),
                        eager_ms=cuda_ms(
                            lambda: window_attention_bwd(*args), 20),
                        plain_ms=cuda_ms(
                            lambda: window_attention_bwd_torch(*args), 5),
                        bound_ms=ms, bound_by=by, library_ms=None)
    log_times(times)
    return err, times


def tiny_train_batches(cdn):
    rng = np.random.default_rng(5)
    cls = dict(img=rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
               gt_label=rng.integers(0, 45, 2).astype(np.int32))
    G = cdn.max_gt
    hw = np.array([[128, 128], [100, 120]], np.int32)
    boxes = np.zeros((2, G, 4), np.float32)
    labels = np.zeros((2, G), np.int32)
    valid = np.zeros((2, G), bool)
    for b, n in enumerate((3, 6)):
        xy = rng.uniform(0, 70, (n, 2))
        wh = rng.uniform(8, 40, (n, 2))
        boxes[b, :n] = np.concatenate([xy, np.minimum(xy + wh,
                                                      hw[b, ::-1])], 1)
        labels[b, :n] = rng.integers(0, 20, n)
        valid[b, :n] = True
    det = dict(img=rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8),
               img_hw=hw, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid)
    shape = (2, 2 * cdn.num_groups, cdn.single_pad)
    noises = [dict(
        dn_noise_p=rng.uniform(size=shape).astype(np.float32),
        dn_noise_new_label=rng.integers(0, 20, shape).astype(np.int32),
        dn_noise_sign=(rng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
        dn_noise_part=rng.uniform(size=shape + (4,)).astype(np.float32))
        for _ in range(2)]
    return cls, det, noises


def train_parity_phase():
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn_bwd
    from rscotr_tpu_torch.ops.window_attention import window_attention_bwd
    from rscotr_tpu_torch.utils.config import load_cfg
    log("training parity phase: tiny config trains cls, det, det, cls on "
        "the CPU (plain) and on CUDA (kernels), float32, TF32 off, mixup "
        "on (same CPU generator seed), CDN noise injected")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_cfg(TINY_CFG)
    step_cfg = make_step_config(cfg)
    cls_b, det_b, noises = tiny_train_batches(step_cfg.cdn)
    logs, models = {}, {}
    init = None
    for dev in ("cpu", "cuda"):
        model = build_model(cfg["model"], tasks=("cls", "det"), device=dev,
                            generator=torch.Generator().manual_seed(0))
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init, strict=True)
        opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                              lr_config=cfg["lr_config"],
                              grad_clip=cfg["optimizer_config"]["grad_clip"])
        masks = task_param_masks(n for n, _ in model.named_parameters())
        steps = {t: make_train_step(model, opt, t, step_cfg, masks[t])
                 for t in ("cls", "det")}
        gen = torch.Generator().manual_seed(0)
        logs[dev] = []
        k1b = ms_deform_attn_bwd.launches
        k2b = window_attention_bwd.launches
        for i, task in enumerate(("cls", "det", "det", "cls")):
            batch = cls_b if task == "cls" else dict(det_b, **noises[i - 1])
            lv = steps[task](batch, gen)
            logs[dev].append((task, {k: float(v) for k, v in lv.items()}))
        if dev == "cuda" and (ms_deform_attn_bwd.launches == k1b or
                              window_attention_bwd.launches == k2b):
            fail("training parity: the CUDA run launched no backward "
                 "kernel")
        models[dev] = model
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    for i, ((task, want), (_, got)) in enumerate(zip(logs["cpu"],
                                                     logs["cuda"])):
        worst = max((abs(got[k] - want[k]) - TRAIN_RTOL * abs(want[k]), k)
                    for k in want)
        log(f"  step {i} {task}: {len(want)} terms, loss {want['loss']:.6f}"
            f" vs {got['loss']:.6f}, grad_norm {want['grad_norm']:.5f} vs "
            f"{got['grad_norm']:.5f}; worst excess {worst[0]:.2e} "
            f"({worst[1]}, tol {TRAIN_ATOL:g})")
        if set(got) != set(want) or worst[0] > TRAIN_ATOL:
            fail(f"training parity: step {i} ({task}) differs")
    sd_cpu = models["cpu"].state_dict()
    n_out, n_all, worst = 0, 0, (0.0, "")
    for n, p in models["cuda"].state_dict().items():
        ref = sd_cpu[n]
        d = (p.cpu() - ref).abs()
        n_out += int((d > PARAM_ATOL + PARAM_RTOL * ref.abs()).sum())
        n_all += d.numel()
        worst = max(worst, (d.max().item(), n))
    log(f"  final params: {n_out} of {n_all} elements outside {PARAM_ATOL:g}"
        f" + {PARAM_RTOL:g}*|w| (allowed {PARAM_FRAC:g} of them); max abs "
        f"diff {worst[0]:.2e} ({worst[1]}, allowed {PARAM_MAX:g})")
    if n_out > PARAM_FRAC * n_all or worst[0] > PARAM_MAX:
        fail("training parity: final parameters differ")


def serving_phase():
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.ops.msda_ws import ws_fwd
    from rscotr_tpu_torch.ops.window_attention import window_attention
    from rscotr_tpu_torch.utils.config import load_model_cfg
    log("serving phase: flagship MTL (cls + det + seg), bf16, random "
        "weights (seed 0)")
    cfg = load_model_cfg(FLAGSHIP_CFG)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  built {n_params} params on cuda in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = make_infer_steps(model, max_per_img=300,
                             seg_test_cfg=cfg["test_cfg"]["seg"])
    if cfg["test_cfg"]["seg"].get("mode", "whole") != "whole":
        fail("flagship seg test_cfg: expected whole mode")
    rng = np.random.default_rng(0)
    reqs = {
        "cls 16x224^2": ("cls", (rng.integers(
            0, 256, (16, 224, 224, 3)).astype(np.uint8),)),
        "det 1x800^2": ("det", (
            rng.integers(0, 256, (1, 800, 800, 3)).astype(np.uint8),
            np.array([[800, 800]], np.int32), np.ones((1, 4), np.float32))),
        "det 4x800^2": ("det", (
            rng.integers(0, 256, (4, 800, 800, 3)).astype(np.uint8),
            np.array([[800, 800], [800, 704], [640, 800], [512, 600]],
                     np.int32), np.ones((4, 4), np.float32))),
        "seg 4x512^2": ("seg", (rng.integers(
            0, 256, (4, 512, 512, 3)).astype(np.uint8),)),
        "seg 1x512^2": ("seg", (rng.integers(
            0, 256, (1, 512, 512, 3)).astype(np.uint8),)),
    }
    # -- the main path's run: one request of each kind, counted -----------
    # K1: 6 encoder + 6 decoder layers per det forward, 6 encoder layers per
    # seg forward (the pixel decoder); K2: 12 Swin blocks per backbone pass
    # (every K1 launch takes the vector body: head width 32)
    want = {"cls": (0, 12), "det": (12, 12), "seg": (6, 12)}
    ms_deform_attn.launches = 0
    ms_deform_attn.vec_launches = 0
    window_attention.launches = 0
    k4 = ws_fwd.launches
    outs = {}
    for name, (task, args) in reqs.items():
        k1, k2 = ms_deform_attn.launches, window_attention.launches
        vec = ms_deform_attn.vec_launches
        outs[name] = steps[task](*args)
        got = (ms_deform_attn.launches - k1, window_attention.launches - k2)
        vec = ms_deform_attn.vec_launches - vec
        log(f"  launches in {name}: K1 {got[0]} ({vec} vector body), K2 "
            f"{got[1]} (want {want[task][0]}, all vector body, "
            f"{want[task][1]})")
        if got != want[task] or vec != got[0]:
            fail(f"{name}: kernel launches {got} ({vec} K1 vector body) != "
                 f"{want[task]}")
    torch.cuda.synchronize()
    if ws_fwd.launches != k4:
        fail("serving launched K4: the quad-gather path is not the model's")
    launches = {"K1": ms_deform_attn.launches, "K2": window_attention.launches,
                "K1 vec": ms_deform_attn.vec_launches}
    log(f"  launches in the main path's run: K1 {launches['K1']} "
        f"({launches['K1 vec']} vector body), K2 {launches['K2']}")

    probs = outs["cls 16x224^2"].float()
    if tuple(probs.shape) != (16, 45) or not torch.isfinite(probs).all() or \
            (probs.sum(-1) - 1).abs().max() > 1e-3:
        fail(f"cls output invalid: shape {tuple(probs.shape)}")
    log(f"  cls: probs {tuple(probs.shape)}, finite, rows sum to 1 "
        f"(max dev {(probs.sum(-1) - 1).abs().max().item():.2e})")
    for name in ("det 1x800^2", "det 4x800^2"):
        det, labels = outs[name]
        hw = torch.as_tensor(reqs[name][1][1], device="cuda")
        B = hw.shape[0]
        box, score = det[..., :4], det[..., 4]
        lim = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                          -1)[:, None].float()
        ok = (tuple(det.shape) == (B, 300, 5)
              and tuple(labels.shape) == (B, 300)
              and bool(torch.isfinite(det).all())
              and bool(((box >= 0) & (box <= lim)).all())
              and bool(((score >= 0) & (score <= 1)).all())
              and bool(((labels >= 0) & (labels < 20)).all()))
        if not ok:
            fail(f"{name}: output invalid")
        log(f"  {name}: det {tuple(det.shape)}, labels {tuple(labels.shape)}"
            f", finite, boxes inside the image, labels in [0, 20), top "
            f"score {score.max().item():.4f}")
    # scheme 2: one logit channel per query (100), argmaxed over all of them
    C = cfg["seg_head"]["num_queries"]
    for name in ("seg 4x512^2", "seg 1x512^2"):
        labels = outs[name]
        B = reqs[name][1][0].shape[0]
        if tuple(labels.shape) != (B, 512, 512) or \
                labels.dtype != torch.int64 or \
                not bool(((labels >= 0) & (labels < C)).all()):
            fail(f"{name}: labels invalid: {tuple(labels.shape)} "
                 f"{labels.dtype}")
        log(f"  {name}: labels {tuple(labels.shape)} in [0, {C}), "
            f"{labels.unique().numel()} distinct")
    logits = steps["seg_logits"](*reqs["seg 1x512^2"][1])
    if tuple(logits.shape) != (1, 512, 512, C) or \
            logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        fail(f"seg logits invalid: {tuple(logits.shape)} {logits.dtype}")
    log(f"  seg 1x512^2: logits {tuple(logits.shape)} float32, finite")
    del logits

    # -- latency and memory ----------------------------------------------
    lat = {}
    for name, (task, args) in reqs.items():
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(23):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            steps[task](*args)
            end.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        lat[name] = (float(np.median(times)), peak)
        log(f"  latency {name:<12} median {lat[name][0]:.3f} ms over "
            f"{len(times)} requests (min {min(times):.3f}, max "
            f"{max(times):.3f}); peak memory {peak:.1f} MiB")
    return launches, lat


def flagship_det_batch(rng):
    """det 1x800^2, 18 valid GT boxes padded to max_gt = 100, and the
    collate's zero-width ``dn_wide`` marker at ladder width 20."""
    n, G = 18, 100
    xy = rng.uniform(0, 700, (n, 2))
    wh = rng.uniform(16, 200, (n, 2))
    boxes = np.zeros((1, G, 4), np.float32)
    boxes[0, :n] = np.concatenate([xy, np.minimum(xy + wh, 800)], 1)
    labels = np.zeros((1, G), np.int32)
    labels[0, :n] = rng.integers(0, 20, n)
    valid = np.zeros((1, G), bool)
    valid[0, :n] = True
    return dict(img=rng.integers(0, 256, (1, 800, 800, 3)).astype(np.uint8),
                img_hw=np.array([[800, 800]], np.int32), gt_bboxes=boxes,
                gt_labels=labels, gt_valid=valid,
                dn_wide=np.zeros((0, 20), np.float32))


def seg_train_batch(rng, B, hw=512):
    """Seg labels as the Potsdam loader gives them: uint8 classes in [0, 5)
    with a band of the ignore index 255 (the padded border of a crop)."""
    labels = rng.integers(0, 5, (B, hw, hw)).astype(np.uint8)
    labels[:, hw - 40:] = 255
    return dict(img=rng.integers(0, 256, (B, hw, hw, 3)).astype(np.uint8),
                gt_semantic_seg=labels)


def train_phase():
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.models.heads import dino_loss as dl
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_bwd)
    from rscotr_tpu_torch.ops.msda_ws import ws_bwd, ws_fwd
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_bwd)
    from rscotr_tpu_torch.utils.config import load_cfg
    log("training phase: flagship MTL (cls + det + seg), bf16 compute, f32 "
        "params, drop path 0.2, random weights (seed 0)")
    cfg = load_cfg(FLAGSHIP_CFG)
    model = build_model(cfg["model"], device="cuda",
                        generator=torch.Generator().manual_seed(0))
    step_cfg = make_step_config(cfg)
    cdn = step_cfg.cdn
    log(f"  cls mixup/cutmix {step_cfg.cls_use_augments}; CDN "
        f"{cdn.num_groups} groups x {cdn.single_pad}, pad {cdn.pad_size} + "
        f"{cdn.num_queries} matching queries; max_gt {cdn.max_gt}")
    if not step_cfg.cls_use_augments or cdn.pad_size + cdn.num_queries != 800:
        fail("flagship step config: expected augments and 200 + 600 queries")
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=cfg["lr_config"],
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    names = [n for n, _ in model.named_parameters()]
    masks = task_param_masks(names)
    tasks = ("cls", "det", "seg")
    steps = {t: make_train_step(model, opt, t, step_cfg, masks[t])
             for t in tasks}
    rng = np.random.default_rng(0)
    batches = {"cls": dict(
        img=rng.integers(0, 256, (16, 224, 224, 3)).astype(np.uint8),
        gt_label=rng.integers(0, 45, 16).astype(np.int32)),
        "det": flagship_det_batch(rng), "seg": seg_train_batch(rng, 4)}
    frozen = {"cls": ("bbox_head.", "neck.", "shared_encoder.", "seg_head."),
              "det": ("cls_head.", "seg_head."),
              "seg": ("cls_head.", "bbox_head.")}
    params = dict(model.named_parameters())
    # host matcher time: the LAP solves inside dino_loss
    lap = []
    solve = dl.hungarian_batched

    def timed_solve(*a):
        t0 = time.perf_counter()
        out = solve(*a)
        lap.append((time.perf_counter() - t0) * 1e3)
        return out

    dl.hungarian_batched = timed_solve
    counters = {"K1": ms_deform_attn, "K1b": ms_deform_attn_bwd,
                "K3'": scatter_add_mm, "K4": ws_fwd, "K5": ws_bwd,
                "K2": window_attention, "K2b": window_attention_bwd}
    # K3', K4 and K5 run on the quad-gather path only: K1 and K1b do their
    # work on this one
    quad = {"K3'": 0, "K4": 0, "K5": 0}
    # seg: K1 / K1b from the pixel decoder's 6 encoder layers
    want = {"det": {"K1": 12, "K1b": 12, **quad, "K2": 12, "K2b": 12},
            "cls": {"K1": 0, "K1b": 0, **quad, "K2": 12, "K2b": 12},
            "seg": {"K1": 6, "K1b": 6, **quad, "K2": 12, "K2b": 12}}
    gen = torch.Generator().manual_seed(0)
    # -- the main path's run: 2 warm-up + 10 timed steps of each task ----
    for fn in counters.values():
        fn.launches = 0
    ms_deform_attn.vec_launches = 0
    ms_deform_attn_bwd.vec_launches = 0
    times = {t: [] for t in tasks}
    peak = {t: 0.0 for t in tasks}
    per_task = {t: {} for t in tasks}
    schedule = list(tasks) * 12
    try:
        for i, task in enumerate(schedule):
            snap = {n: p.detach().clone() for n, p in params.items()
                    if n.startswith(frozen[task])}
            before = {k: fn.launches for k, fn in counters.items()}
            vec = (ms_deform_attn.vec_launches,
                   ms_deform_attn_bwd.vec_launches)
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lv = steps[task](batches[task], gen)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            got = {k: fn.launches - before[k] for k, fn in counters.items()}
            for k, v in got.items():
                per_task[task][k] = per_task[task].get(k, 0) + v
            if got != want[task]:
                fail(f"{task} step {i}: kernel launches {got} != "
                     f"{want[task]}")
            if (ms_deform_attn.vec_launches - vec[0],
                    ms_deform_attn_bwd.vec_launches - vec[1]) != \
                    (got["K1"], got["K1b"]):
                fail(f"{task} step {i}: a K1 or K1b launch took the lane "
                     "body")
            vals = {k: float(v) for k, v in lv.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                fail(f"{task} step {i}: non-finite loss terms {vals}")
            moved = [n for n, p in snap.items()
                     if not torch.equal(p, params[n])]
            if moved:
                fail(f"{task} step {i}: masked parameters moved: "
                     f"{moved[:5]}")
            if i >= 2 * len(tasks):
                times[task].append(ms)
                peak[task] = max(peak[task],
                                 torch.cuda.max_memory_allocated() / 2 ** 20)
            if i < 2 or i >= len(schedule) - 2:
                log(f"  step {i} {task}: {len(vals)} terms, loss "
                    f"{vals['loss']:.4f}, grad_norm {vals['grad_norm']:.3f}"
                    f", {ms:.1f} ms, launches {got}, masked "
                    f"{len(snap)} tensors bit-identical")
    finally:
        dl.hungarian_batched = solve
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["K1 vec"] = ms_deform_attn.vec_launches
    launches["K1b vec"] = ms_deform_attn_bwd.vec_launches
    launches["per task"] = per_task
    log(f"  launches in the main path's run ({len(schedule)} steps): "
        f"{launches}")
    # the one device-to-host copy of the matching costs, alone
    cost = torch.randn(7, 1, 100, 600, device="cuda")
    copy_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost.cpu()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    res = {}
    for task in tasks:
        med = float(np.median(times[task]))
        res[task] = dict(median_ms=med, min_ms=min(times[task]),
                         max_ms=max(times[task]), steps=len(times[task]),
                         peak_mib=peak[task])
        log(f"  train step {task}: median {med:.2f} ms over "
            f"{len(times[task])} steps (min {min(times[task]):.2f}, max "
            f"{max(times[task]):.2f}); peak memory {peak[task]:.0f} MiB")
    lap_med = float(np.median(lap[4:]))
    res["det"]["lap_ms"] = lap_med
    res["det"]["cost_copy_ms"] = float(np.median(copy_ms))
    log(f"  det host matcher: LAP {lap_med:.2f} ms median per step "
        f"(7 x 100 x 600, 18 valid rows), cost copy alone "
        f"{np.median(copy_ms):.3f} ms (1.68 MB); "
        f"{100 * lap_med / res['det']['median_ms']:.1f}% of the det step")
    return launches, res


def without_device_augment(cfg):
    """A copy of a composed config with its loaders' on-device augmentation
    options off (ROADMAP M6: ``make_step_config`` refuses them), and the
    options it turned off."""
    cfg = copy.deepcopy(cfg)
    off = []
    for name, entry in cfg.get("data", {}).items():
        loader = entry.get("loader", {})
        for key in ("cls_device_augment", "det_device_augment",
                    "seg_device_augment"):
            if loader.get(key):
                loader[key] = False
                off.append(f"{name}.loader.{key}")
    return cfg, off


def zoo_phase():
    """The zoo's paths at full width and depth, bf16 compute, random
    weights (seed 0): the paper's MTL (MlvlClsHead scheme 5, cls through
    the shared encoder), DINO-R50 (an MTL with a ResNet-50 backbone and
    the det head only) and RSCoTrSeg-R50 (the standalone segmentor with its
    own 3-level encoder). Each request and step runs with the kernel counts
    set to 0 just before it and read just after, against the counts the
    code gives; every K1 / K1b launch must take the vector body. Each path
    first runs ``ZOO_WARMUP`` untimed calls (cuDNN's algorithm search and
    the allocator's first growth fall there), checked and counted as the
    timed ones."""
    from rscotr_tpu_torch.apis import derive_cls_hw, make_step_config
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_bwd)
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_bwd)
    from rscotr_tpu_torch.utils.config import load_cfg
    counters = {"K1": ms_deform_attn, "K1b": ms_deform_attn_bwd,
                "K2": window_attention, "K2b": window_attention_bwd}
    rng = np.random.default_rng(1)
    launches, calls, res = {}, {}, {}

    def counted(name, want, fn):
        """Run ``fn`` with every count at 0, check the launches, and return
        (fn's result, device ms by CUDA events)."""
        for c in counters.values():
            c.launches = 0
        ms_deform_attn.vec_launches = ms_deform_attn_bwd.vec_launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        vec = (ms_deform_attn.vec_launches, ms_deform_attn_bwd.vec_launches)
        if got != want or vec != (got["K1"], got["K1b"]):
            fail(f"{name}: kernel launches {got} (vector body K1 {vec[0]}, "
                 f"K1b {vec[1]}) != {want}, all on the vector body")
        for k, v in got.items():
            launches.setdefault(name, {})[k] = \
                launches.get(name, {}).get(k, 0) + v
        calls[name] = calls.get(name, 0) + 1
        return out, start.elapsed_time(end)

    def report(name, times, extra=""):
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        res[name] = dict(median_ms=float(np.median(times)), n=len(times),
                         min_ms=min(times), max_ms=max(times),
                         peak_mib=peak)
        log(f"  {name}: median {res[name]['median_ms']:.2f} ms over "
            f"{len(times)} after {ZOO_WARMUP} untimed (min {min(times):.2f}, "
            f"max {max(times):.2f}); peak memory {peak:.0f} MiB; launches "
            f"per call "
            f"{ {k: v // calls[name] for k, v in launches[name].items()} }"
            f"{extra}")

    def steps_for(cfg, model, task, mask):
        opt = build_optimizer(
            cfg["optimizer"], model.named_parameters(),
            lr_config=cfg.get("lr_config"),
            grad_clip=(cfg.get("optimizer_config") or {}).get("grad_clip"))
        return make_train_step(model, opt, task, make_step_config(cfg), mask)

    def train(name, model, step, batch, n, want, watch):
        gen = torch.Generator().manual_seed(0)
        params = dict(model.named_parameters())
        before = params[watch].detach().clone()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(ZOO_WARMUP + n):
            lv, ms = counted(name, want, lambda: step(batch, gen))
            vals = {k: float(v) for k, v in lv.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                fail(f"{name}: non-finite loss terms {vals}")
            if i >= ZOO_WARMUP:
                times.append(ms)
        if torch.equal(before, params[watch]):
            fail(f"{name}: {watch} did not move")
        report(name, times, f"; loss {vals['loss']:.4f}, grad_norm "
               f"{vals['grad_norm']:.3f}, {watch} moved")

    # -- the paper MTL: MlvlClsHead scheme 5, cls 16x224^2 ----------------
    cfg, off = without_device_augment(load_cfg(PAPER_CFG))
    hw = derive_cls_hw(cfg)
    log(f"zoo phase: paper MTL (MlvlClsHead scheme "
        f"{cfg['model']['cls_head']['scheme']}, cls_hw {hw}), cls task, "
        f"bf16, random weights (seed 0); a copy of the config with {off} "
        "off (ROADMAP M6)")
    model = build_model(cfg["model"], tasks=("cls",), device="cuda",
                        generator=torch.Generator().manual_seed(0),
                        cls_hw=hw)
    n = model.cls_head.out_proj.weight.shape[1]
    if n != 16:
        fail(f"paper MTL: out_proj over {n} tokens, want 16 (4^2 at 224^2)")
    infer = make_infer_steps(model)
    img = rng.integers(0, 256, (16, 224, 224, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ZOO_WARMUP + 3):
        probs, ms = counted("paper MTL cls 16x224^2 request",
                            {"K1": 6, "K1b": 0, "K2": 12, "K2b": 0},
                            lambda: infer["cls"](img))
        if i >= ZOO_WARMUP:
            times.append(ms)
    if tuple(probs.shape) != (16, 45) or not torch.isfinite(probs).all() or \
            (probs.sum(-1) - 1).abs().max() > 1e-3:
        fail(f"paper MTL cls output invalid: {tuple(probs.shape)}")
    report("paper MTL cls 16x224^2 request", times,
           "; probs (16, 45) finite, rows sum to 1")
    head = cfg["model"]["cls_head"]
    # the cls mask as the JAX package's train_model computes it
    mask = task_param_masks(
        [k for k, _ in model.named_parameters()],
        cls_uses_encoder=head.get("type") == "MlvlClsHead")["cls"]
    batch = dict(img=img, gt_label=rng.integers(0, 45, 16).astype(np.int32))
    train("paper MTL cls 16x224^2 step", model,
          steps_for(cfg, model, "cls", mask), batch, 3,
          {"K1": 6, "K1b": 6, "K2": 12, "K2b": 12},
          "shared_encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, probs
    torch.cuda.empty_cache()

    # -- DINO-R50: det 1x800^2 --------------------------------------------
    cfg, off = without_device_augment(load_cfg(DINO_R50_CFG))
    log(f"zoo phase: DINO-R50 det (MTL, ResNet-50, det head), bf16, random "
        f"weights (seed 0); a copy of the config with {off} off "
        "(ROADMAP M6)")
    model = build_model(cfg["model"], device="cuda",
                        generator=torch.Generator().manual_seed(0))
    infer = make_infer_steps(model, max_per_img=300)
    img = rng.integers(0, 256, (1, 800, 800, 3)).astype(np.uint8)
    img_hw = np.array([[800, 800]], np.int32)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ZOO_WARMUP + 3):
        (det, labels), ms = counted(
            "DINO-R50 det 1x800^2 request",
            {"K1": 12, "K1b": 0, "K2": 0, "K2b": 0},
            lambda: infer["det"](img, img_hw, np.ones((1, 4), np.float32)))
        if i >= ZOO_WARMUP:
            times.append(ms)
    if tuple(det.shape) != (1, 300, 5) or not torch.isfinite(det).all() or \
            not bool(((labels >= 0) & (labels < 20)).all()):
        fail(f"DINO-R50 det output invalid: {tuple(det.shape)}")
    report("DINO-R50 det 1x800^2 request", times,
           "; det (1, 300, 5) finite, labels in [0, 20)")
    mask = task_param_masks([k for k, _ in model.named_parameters()])["det"]
    train("DINO-R50 det 1x800^2 step", model,
          steps_for(cfg, model, "det", mask), flagship_det_batch(rng), 3,
          {"K1": 12, "K1b": 12, "K2": 0, "K2b": 0},
          "shared_encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, det, labels
    torch.cuda.empty_cache()

    # -- RSCoTrSeg-R50: seg 2x512^2 ---------------------------------------
    cfg, off = without_device_augment(load_cfg(RSEG_R50_CFG))
    log(f"zoo phase: RSCoTrSeg-R50 seg (ResNet-50, own 3-level encoder), "
        f"bf16, random weights (seed 0); a copy of the config with {off} "
        "off (ROADMAP M6)")
    model = build_model(cfg["model"], device="cuda",
                        generator=torch.Generator().manual_seed(0))
    C = cfg["model"]["decode_head"]["num_queries"]
    infer = make_infer_steps(model,
                             seg_test_cfg=cfg["model"]["test_cfg"]["seg"])
    img = rng.integers(0, 256, (2, 512, 512, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ZOO_WARMUP + 3):
        labels, ms = counted("RSCoTrSeg-R50 seg 2x512^2 request",
                             {"K1": 6, "K1b": 0, "K2": 0, "K2b": 0},
                             lambda: infer["seg"](img))
        if i >= ZOO_WARMUP:
            times.append(ms)
    if tuple(labels.shape) != (2, 512, 512) or \
            not bool(((labels >= 0) & (labels < C)).all()):
        fail(f"RSCoTrSeg-R50 labels invalid: {tuple(labels.shape)}")
    report("RSCoTrSeg-R50 seg 2x512^2 request", times,
           f"; labels (2, 512, 512) in [0, {C}), "
           f"{labels.unique().numel()} distinct")
    # no task mask: the standalone encoder trains (ROADMAP C6)
    train("RSCoTrSeg-R50 seg 2x512^2 step", model,
          steps_for(cfg, model, "seg", None), seg_train_batch(rng, 2), 3,
          {"K1": 6, "K1b": 6, "K2": 0, "K2b": 0},
          "encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, labels
    torch.cuda.empty_cache()
    return launches, res


def kernels_line(times, btimes, qtimes, err, berr, qerr, k6err, k6levels,
                 launches):
    """The ``{"kernels": [...]}`` object: eight kernels, each with its
    launches on the main path, its error against the plain version, its
    time beside the plain version's, its bound and its library yardstick."""
    det_enc = "det encoder B=1 Q=Nv=13294 H=8 L=4 P=4 D=32 bf16"
    # K1b's time depends on how many corners lie on the map: the headline is
    # the case with a model's locations, [0, 1]
    k1b = btimes["K1b det-encoder B=1 loc in [0, 1]"]
    k3 = btimes["K3' det-encoder B=1 loc in [0, 1]"]
    ws_at = "det encoder g (8, 13294, 16, 128) bf16, wt (8, 13294, 64) bf16"
    det_s0 = "det 800^2 stage 0 B=1 nW=841 H=3 n=49 hd=32 shifted bf16"
    sdpa = ("F.scaled_dot_product_attention(q, k, v, attn_mask=bias + mask, "
            "scale=scale)")
    # K6's inputs are made inside the probe, which reports what it timed:
    # the bytes of table, idx, w and the output, one multiply per output
    k6 = k6levels[10000]
    k6_bound, k6_by = bound(k6["bytes"], float(k6["out_elements"]), "f32")

    def entry(name, source, replaces, key, r, errs, timed_at, library=None,
              **more):
        return dict(
            name=name, route="cuda", source=f"rscotr_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches[key], max_abs_err=errs[0],
            max_abs_err_bf16=errs[1], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], library=library, timed_at=timed_at,
            **{f: r[f] for f in ("eager_ms", "library_backend") if f in r},
            **more)

    def stages(table, kernel):
        return {name[len(kernel) + 1:]: r for name, r in table.items()
                if name.startswith(kernel + " ")}

    pallas = "rscotr_tpu/ops/pallas/"
    k1 = times[f"K1 {K1_HEADLINE}"]
    return {"kernels": [
        entry("msda_fwd", "msda_fwd.cu",
              pallas + "ms_deform_attn_kernel.py:138", "K1",
              k1, err["K1"], det_enc + ", locations in [0, 1]",
              lane_ms=k1["lane_ms"], launches_serving=launches["K1 serving"],
              launches_paths=launches["paths"]["K1"],
              vec_launches=launches["K1 vec"],
              vec_launches_serving=launches["K1 vec serving"],
              stages=stages(times, "K1")),
        entry("window_attn", "window_attn.cu",
              pallas + "window_attention.py:116", "K2",
              times["K2 det800.s0"], err["K2"], det_s0, library=sdpa,
              launches_serving=launches["K2 serving"],
              launches_paths=launches["paths"]["K2"],
              stages=stages(times, "K2")),
        entry("msda_bwd", "msda_bwd.cu",
              pallas + "ms_deform_attn_kernel.py:138", "K1b",
              k1b, berr["K1b"], det_enc + ", locations in [0, 1]",
              replaces_part="backward (JAX: autodiff of _ms_deform_attn_xla,"
                            " rscotr_tpu/ops/ms_deform_attn.py:270)",
              fuses="scatter_add (K3') on the model path",
              vec_launches=launches["K1b vec"],
              launches_paths=launches["paths"]["K1b"],
              whole_ms=k1b["whole_ms"], whole_eager_ms=k1b["whole_eager_ms"],
              stages=stages(btimes, "K1b")),
        entry("scatter_add", "scatter_add.cu", pallas + "scatter_mm.py:168",
              "K3'", k3, berr["K3"],
              "det encoder d_g (8, 212704, 128) bf16 -> (8, 13294, 128) f32, "
              "the plain backward's quad-row updates at locations in [0, 1]; "
              "ms: the launch alone into a zeroed accumulator",
              library="Tensor.index_add_(0, rows, f32 updates)",
              launches_at="the quad-gather MSDA (impl=\"quad\") backward",
              launches_train_run=launches["K3' training"],
              vec_launches=launches["K3' vec"], scalar_ms=k3["scalar_ms"],
              whole_ms=k3["whole_ms"], whole_eager_ms=k3["whole_eager_ms"],
              stages=stages(btimes, "K3'")),
        entry("window_attn_bwd", "window_attn_bwd.cu",
              pallas + "window_attention.py:116", "K2b",
              btimes["K2b det800.s0"], berr["K2b"], det_s0,
              library="torch.autograd.grad of " + sdpa + " for q, k, v",
              replaces_part="backward (JAX: autodiff of the einsum path, "
                            "rscotr_tpu/models/backbones/swin.py:130)",
              launches_paths=launches["paths"]["K2b"],
              stages=stages(btimes, "K2b")),
        entry("ws_fwd", "msda_ws.cu", pallas + "msda_ws.py:110", "K4",
              qtimes["K4 det-encoder"], qerr["K4"], ws_at,
              library=qtimes["K4 det-encoder"]["library"],
              vec_launches=launches["K4 vec"],
              row_ms=qtimes["K4 det-encoder"]["row_ms"]),
        entry("ws_bwd", "msda_ws.cu", pallas + "msda_ws.py:135", "K5",
              qtimes["K5 det-encoder"], qerr["K5"], ws_at,
              vec_launches=launches["K5 vec"],
              row_ms=qtimes["K5 det-encoder"]["row_ms"]),
        entry("weighted_gather", "weighted_gather.cu",
              "tools/probe_msda_weighted_gather_mm.py:103", "K6",
              dict(ms=k6["weighted_mm"], plain_ms=k6["prod_gather"],
                   bound_ms=k6_bound, bound_by=k6_by, library_ms=None),
              k6err, "G=8 K=53376 Nv=10000 C=128 bf16",
              plain="production_level_slice (gather, then x w in f32)",
              levels=k6levels),
    ]}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from rscotr_tpu_torch.ops import kernel_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    info = kernel_lib.build()
    log(f"build: {'compiled' if info.compiled else 'cached'} "
        f"{info.path.name} with nvcc in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    err, times = kernel_phase()
    berr, btimes = backward_phase()
    qerr, qtimes, qlaunches = quad_phase()
    k6err, k6levels, k6launches = k6_phase()
    slice_parity_phase()
    train_parity_phase()
    slaunches, lat = serving_phase()
    launches, train = train_phase()
    zlaunches, zoo = zoo_phase()
    library_phase(times, btimes)
    # K3' is launched by the quad-gather path; the training run launches it
    # 0 times (train_phase checks every step), K1b doing its work there
    launches.update({"K1 serving": slaunches["K1"],
                     "K1 vec serving": slaunches["K1 vec"],
                     "K2 serving": slaunches["K2"], "K6": k6launches,
                     "K3' training": launches["K3'"]}, **qlaunches)
    # the launches of each path beside the main path, per kernel
    zlaunches.update({f"flagship {t} steps (12)": n
                      for t, n in launches.pop("per task").items()})
    launches["paths"] = {k: {path: n[k] for path, n in zlaunches.items()}
                         for k in ("K1", "K1b", "K2", "K2b")}

    log(f"summary ({smi}): " + "; ".join(
        f"serve {n} {ms:.3f} ms, peak {mb:.0f} MiB"
        for n, (ms, mb) in lat.items()) + "; " + "; ".join(
        f"train {t} {r['median_ms']:.2f} ms, peak {r['peak_mib']:.0f} MiB"
        for t, r in train.items()) + "; " + "; ".join(
        f"{n} {r['median_ms']:.2f} ms, peak {r['peak_mib']:.0f} MiB"
        for n, r in zoo.items()) + "; " + "; ".join(
        f"MSDA impl={i} fwd+bwd {qtimes[f'MSDA {i}'][1]:.4f} ms"
        for i in ("quad", "kernel")))
    log(smi)
    print(json.dumps(kernels_line(times, btimes, qtimes, err, berr, qerr,
                                  k6err, k6levels, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
