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
11. on-device augmentation (``augment_phase``): the stages of
    ``ops/device_augment.py`` on the card against the same stages on the
    CPU, on records the port's planners drew for
    ``MTL_synthetic_flagship_devaug.py``'s synthetic sets: cls 16 x 256^2
    -> 224^2 (RandomResizedCrop, flip, 2 RandAugment slots, erase), det 1
    x 800^2 (the two-stage resample), seg 2 x 512^2 (the resize + crop +
    flip matrices, PhotoMetricDistortion). Each part is fed the CPU's
    output of the part before it and held to ``AUG_TOL`` (at most 1 uint8
    level on at most 0.5% of the values); each whole stage end to end
    (``run_stage``, as the step calls it) is held to ``AUG_TOL`` too, run
    again with ``allow_tf32`` on (bit-equal: the resample products hold
    full float32), timed (CUDA events, and the host's time to issue it)
    and profiled (device time, kernels per call);
12. the model zoo at full width and depth, bf16, random weights: the
    paper's MTL (``MlvlClsHead`` scheme 5, whose cls path runs the shared
    encoder) answers 3 cls 16x224^2 requests and takes 3 cls steps under
    the mask of ``cls_uses_encoder=True``; DINO-R50 (an MTL with a
    ResNet-50 backbone and the det head) 3 det 1x800^2 requests and 3 det
    steps; RSCoTrSeg-R50 (the standalone segmentor, its own 3-level
    encoder) 3 seg 2x512^2 requests and 3 seg steps without a task mask.
    Each path's timed calls follow 2 untimed warm-up calls, checked and
    counted as they are. Each config runs as written, its on-device
    augmentation on: the train batch comes from its train pipeline through
    the port's planner and aug collate over a synthetic set (cls 16 x
    256^2 sources, det 1 x 800^2 into DINO-R50's (800, 1344) bucket, seg 2
    x 512^2), and each step runs the augment stage. Every request and step
    runs with the kernel counts at 0 and is checked
    against the counts the code gives (all K1 / K1b launches on the vector
    body); outputs checked, median time and peak memory reported. K1 and
    K1b are held against their plain versions at these paths' new encoder
    shapes in phases 3 and 4 (B=16, Q=Nv=1,045, L=4; B=2, Q=Nv=5,376,
    L=3);
13. evaluation (``eval_phase``): the flagship saved with the port's
    ``save_checkpoint`` and loaded back through ``resolve_checkpoint(
    work_dir/latest.pth)`` into a model of another seed, its cls, det and
    seg outputs bit-equal to the saver's; then the port's
    ``tools/test.py`` (``rscotr_tpu_torch.tools.test.main``) on that
    checkpoint over the whole synthetic val sets (cls 4 x 8 x 224^2, det 2
    x 4 x 800^2, seg 2 x 4 x 512^2), launches counted per batch (K1 / K2:
    cls 0 / 12, det 12 / 12, seg 6 / 12, every K1 on the vector body, no
    backward or quad-path kernel), the metric keys (``resisc.accuracy_top-1``,
    ``dior.bbox_mAP`` and its classwise keys, ``potsdam.mIoU``,
    ``potsdam.mFscore``) and finite values checked, and per dataset the
    median batch time after one untimed batch, images/s, the loader's and
    the infer step's share of the wall time and the peak memory reported;
    the seg logits path (crop and resize on the host) timed once; the tiny
    config's ``make_val_step`` for cls, det and seg on the CPU and on the
    card, float32, TF32 off, every log var within SLICE_TOL;
14. the co-training loop (``loop_phase``): the port's ``tools/train.py``
    (``rscotr_tpu_torch.tools.train.main``) on the flagship config as
    written (round_robin, ``steps_per_dispatch=16``: JAX's grouped order)
    for 48 iterations in a temporary work dir: the task of every step
    against the order the port's grouping derives without a step (16 cls,
    16 det, 16 seg), every iteration's launches (cls K2 / K2b 12; det K1 /
    K1b / K2 / K2b 12; seg K1 / K1b 6, K2 / K2b 12; every K1 / K1b on the
    vector body, no quad-path kernel), every loss term and grad_norm
    finite, ``iter_48.pth``, ``last_checkpoint``, ``best_checkpoint.pth``
    and ``metrics.jsonl`` (steps 5, 10, ..., 45, 48), the eval hook at step
    48 over the whole val sets with the eval phase's per-batch counts and
    metric keys; then a resume from ``iter_48.pth`` to 52: model and
    optimizer state bit-equal to the file, start at step 48 with the
    optimizer's schedule clock at 48, 4 cls steps counted as above.
    Reported per task: the median step time (CUDA events around the step
    call) and host wall after each group's first step, the median
    data_time, the peak memory; the loop's data-wait share, the
    checkpoint save and load times, the eval hook's time, the phase's;
15. co-training with the paper's augmentation (``aug_loop_phase``): the
    port's ``tools/train.py`` on ``MTL_synthetic_flagship_devaug.py`` (the
    three augment tails in the steps, on the card) and on
    ``MTL_synthetic_flagship_hostaug.py`` (the same tails on the host: PIL
    RandAugment, resize, crop, photometric in the loader threads), each as
    written for 48 iterations (16 cls, 16 det, 16 seg), in the order
    devaug, hostaug, hostaug, devaug; all ``--no-validate``. Every
    iteration's task and K1 / K1b / K2 / K2b launches (on the vector body)
    checked as in the loop phase, every loss term finite, the totals, a
    parameter of the backbone and of each head moved; reported as the loop
    phase's, per run the data-wait share over all steps and after step 1
    (the steady wait) beside each group's collection, the two configs' runs
    side by side, and each augment stage's time as a share of its task's
    devaug step;
16. library yardsticks of K2 and K2b, last because cuDNN keeps workspace
    once it has run under graph capture: ``scaled_dot_product_attention``
    with the additive bias + mask, and its autograd backward, on the timed
    stages' own tensors (rebuilt from their seed), under every backend that
    takes them; the fastest is the yardstick. The port never calls it.

The line before the last is {"kernels": [...]}: eight kernels, each with
``launches`` (the main path's run: the flagship's training), K1, K1b, K2
and K2b also ``launches_paths`` (each zoo path's, each flagship task's,
the flagship eval's run, each loop step's per task and the loop's whole
run, the same for the first devaug and hostaug runs, counted from 0), ``max_abs_err``, ``ms`` and ``plain_ms``
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
# on-device augmentation: the flagship with all three augment tails on the
# card, and its twin with them on the host (PIL in the loader threads)
DEVAUG_CFG = os.path.join(ROOT,
                          "configs/multi/MTL_synthetic_flagship_devaug.py")
HOSTAUG_CFG = os.path.join(ROOT,
                           "configs/multi/MTL_synthetic_flagship_hostaug.py")
# an augment part on the card against the CPU, on the same inputs: at most
# this many uint8 levels, on at most this share of the values (the float32
# resample products sum in another order on each; a sin or tan of the
# rotation may differ in its last bit)
AUG_TOL = (1.0, 0.005)
# iterations of each devaug and hostaug run (steps_per_dispatch 16 as
# written: 16 cls, 16 det, 16 seg)
AUG_ITERS = 48
# the quad-gather path's kernels, which no model path launches
QUAD = ("K3'", "K4", "K5")

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
    counters = kernel_counters()
    # K3', K4 and K5 run on the quad-gather path only: K1 and K1b do their
    # work on this one
    quad = {"K3'": 0, "K4": 0, "K5": 0}
    # seg: K1 / K1b from the pixel decoder's 6 encoder layers
    want = {"det": {"K1": 12, "K1b": 12, **quad, "K2": 12, "K2b": 12},
            "cls": {"K1": 0, "K1b": 0, **quad, "K2": 12, "K2b": 12},
            "seg": {"K1": 6, "K1b": 6, **quad, "K2": 12, "K2b": 12}}
    gen = torch.Generator().manual_seed(0)
    # -- the main path's run: 2 warm-up + 10 timed steps of each task ----
    zero_counts(counters)
    times = {t: [] for t in tasks}
    peak = {t: 0.0 for t in tasks}
    per_task = {t: {} for t in tasks}
    schedule = list(tasks) * 12
    try:
        for i, task in enumerate(schedule):
            snap = {n: p.detach().clone() for n, p in params.items()
                    if n.startswith(frozen[task])}
            before = launch_counts(counters)
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lv = steps[task](batches[task], gen)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            now = launch_counts(counters)
            got = {k: now[k] - before[k] for k in counters}
            for k, v in got.items():
                per_task[task][k] = per_task[task].get(k, 0) + v
            if got != want[task]:
                fail(f"{task} step {i}: kernel launches {got} != "
                     f"{want[task]}")
            if (now["K1 vec"] - before["K1 vec"],
                    now["K1b vec"] - before["K1b vec"]) != \
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
    launches = launch_counts(counters)
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


def kernel_counters():
    """The wrappers whose ``launches`` count their kernels' launches."""
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_bwd)
    from rscotr_tpu_torch.ops.msda_ws import ws_bwd, ws_fwd
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_bwd)
    return {"K1": ms_deform_attn, "K1b": ms_deform_attn_bwd,
            "K2": window_attention, "K2b": window_attention_bwd,
            "K3'": scatter_add_mm, "K4": ws_fwd, "K5": ws_bwd}


def launch_counts(counters):
    """Each kernel's count, and K1's and K1b's launches on the vector
    body."""
    return dict({k: c.launches for k, c in counters.items()},
                **{"K1 vec": counters["K1"].vec_launches,
                   "K1b vec": counters["K1b"].vec_launches})


def zero_counts(counters):
    for c in counters.values():
        c.launches = 0
    counters["K1"].vec_launches = counters["K1b"].vec_launches = 0


def aug_batch(cfg, name, seed=0):
    """The first training batch of dataset ``name`` of a composed config,
    its train pipeline and loader options as written, run over the
    config's synthetic set (or, for a config of real data, a synthetic set
    of the task at the loader's sizes): with a device-augment option the
    port's planner draws the records and its aug collate batches them."""
    from rscotr_tpu_torch.data import build_dataloaders
    from rscotr_tpu_torch.data.build import derive_dn_ladder
    from rscotr_tpu_torch.data.datasets import (SyntheticClsDataset,
                                                SyntheticDetDataset,
                                                SyntheticSegDataset)
    entry = cfg["data"][name]
    opts = entry.get("loader", {})
    train = entry["data"]["train"]
    if train["type"].startswith("Synthetic"):
        from rscotr_tpu_torch.data import build_datasets
        ds = build_datasets({name: entry})[name]
    else:
        n = 4 * entry["data"].get("samples_per_gpu", 1)
        ds = {"cls": lambda: SyntheticClsDataset(
                  length=n, img_size=opts.get("cls_src_size", 256),
                  num_classes=45, seed=seed),
              "det": lambda: SyntheticDetDataset(
                  length=n, img_size=800, num_classes=20, max_boxes=18,
                  seed=seed),
              "seg": lambda: SyntheticSegDataset(
                  length=n, img_size=opts.get("seg_size", 512),
                  num_classes=6, seed=seed)}[entry["task"]]()
        ds.pipeline_cfg = train["pipeline"]
        ds.task, ds.dataset_name = entry["task"], name
    loader = build_dataloaders({name: ds}, cfg["data"], train=True,
                               seed=seed, num_threads=4,
                               det_dn_ladder=derive_dn_ladder(cfg))[name]
    return next(iter(loader))


def augment_phase():
    """The on-device augmentation stages on the card against the same
    stages on the CPU (their plain reference there), on records the port's
    planners drew for the devaug config's synthetic sets (seeded numpy):
    cls 16 x 256^2 -> 224^2 with 2 RandAugment slots, det 1 x 800^2, seg 2
    x 512^2. Each part is fed the CPU's output of the part before it, so a
    difference is the part's own and is not carried through an op that
    amplifies it (Equalize's and AutoContrast's LUTs, the HSV hue): at most
    ``AUG_TOL[0]`` level, on at most ``AUG_TOL[1]`` of the values. Each
    whole stage end to end, as the step runs it (``run_stage``), is held to
    ``AUG_TOL`` too. The stages hold full float32 whatever the TF32 flag
    says: run again with ``allow_tf32`` on, each output is bit-equal. Then each stage's time (CUDA events, 10 runs after 3), the
    host's time to issue one, and a profile of 3 (device time, kernels and
    aten ops per call)."""
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.ops import device_augment as D
    from rscotr_tpu_torch.tools.profile_quad_seg import profile_calls
    cfg = as_written(DEVAUG_CFG)
    step_cfg = make_step_config(cfg)
    ccfg, dcfg, scfg = (step_cfg.device_aug, step_cfg.det_device_aug,
                        step_cfg.seg_device_aug)
    log(f"augment phase: {DEVAUG_CFG.split('configs/')[1]}'s planners on "
        f"its synthetic sets; {ccfg}, {dcfg}, {scfg}")
    res = {}

    def on(dev, batch):
        t = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if isinstance(v, np.ndarray)}
        return t, {k[len("aug_"):]: v for k, v in t.items()
                   if k.startswith("aug_")}

    def part(name, fn, *args):
        """``fn`` on the CPU tensors ``args`` and on their copies on the
        card; returns the CPU's output."""
        want = fn(*args)
        got = fn(*[{k: v.cuda() for k, v in a.items()} if isinstance(a, dict)
                   else a.cuda() if isinstance(a, torch.Tensor) else a
                   for a in args]).cpu()
        d = (got - want).abs()
        share = (d > 0).float().mean().item()
        log(f"  {name:<34} card vs CPU: max {d.max().item():.0f} level(s),"
            f" {100 * share:.4f}% of {d.numel()} values differ")
        if d.max().item() > AUG_TOL[0] or share > AUG_TOL[1]:
            fail(f"augment {name}: card vs CPU max {d.max().item()}, "
                 f"{share:.2e} of values differ (tolerance {AUG_TOL})")
        return want

    # -- cls: RandomResizedCrop, flip, 2 slots, erase -------------------
    batch = aug_batch(cfg, "resisc")
    img, aug = on("cpu", batch)
    x = part("cls random_resized_crop", lambda i, a: D.random_resized_crop(
        i.float(), a["crop_y"], a["crop_x"], a["crop_h"], a["crop_w"],
        ccfg.out_size), img["img"], aug)
    x = torch.where(aug["flip"][:, None, None, None], x.flip(2), x)
    for p in range(ccfg.num_policies):
        x = part(f"cls RandAugment slot {p} "
                 f"({len(set(aug['op_id'][:, p].tolist()))} ops)",
                 lambda i, a, p=p: D.apply_rand_augment_slot(
                     i, a["op_id"][:, p], a["op_m"][:, p], ccfg.fill),
                 x, aug)
    part("cls random_erase", lambda i, a: D.random_erase(
        i, a["erase_on"], a["erase_y"], a["erase_x"], a["erase_h"],
        a["erase_w"], ccfg.erase_fill, ccfg.erase_fill_std), x, aug)
    stages = {"cls": (batch, "16x256^2 -> 224^2, 2 slots")}

    # -- det: resize / crop / resize in the bucket -------------------------
    batch = aug_batch(cfg, "dior")
    out_hw = batch["out_template"].shape[1:3]
    img, aug = on("cpu", batch)
    part("det two-stage resample", lambda i, a: D.det_device_augment(
        i, a, out_hw, dcfg), img["img"], aug)
    stages["det"] = (batch, f"1x800^2 -> {out_hw[0]}x{out_hw[1]}")

    # -- seg: ratio resize + crop + flip, then photometric ------------------
    batch = aug_batch(cfg, "potsdam")
    img, aug = on("cpu", batch)
    # the photometric record made neutral: the stage is its resample alone
    neutral = dict(aug, pm_bright=torch.zeros_like(aug["pm_bright"]),
                   pm_c_pre=torch.ones_like(aug["pm_c_pre"]),
                   pm_hsv_on=torch.zeros_like(aug["pm_hsv_on"]),
                   pm_c_post=torch.ones_like(aug["pm_c_post"]))
    x = part("seg resize + crop + flip", lambda i, a: D.seg_device_augment(
        i, a, scfg), img["img"], neutral)
    part("seg photometric_distortion", lambda i, a: D.photometric_distortion(
        i, {k[3:]: v for k, v in a.items() if k.startswith("pm_")}), x, aug)
    stages["seg"] = (batch, "2x512^2")

    # -- whole stages: end to end, TF32 on, device time ---------------------
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for task, (batch, what) in stages.items():
        want = D.run_stage(task, on("cpu", batch)[0], step_cfg)
        card = on("cuda", batch)[0]

        def fn():
            return D.run_stage(task, card, step_cfg)

        got = fn()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_tf32 = fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        if not torch.equal(got, got_tf32):
            fail(f"augment {task}: the stage moved under allow_tf32")
        d = (got.cpu() - want).abs()
        ms = cuda_ms(fn, 10)
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        res[task] = dict(ms=ms, host_ms=host_ms, what=what,
                         max=d.max().item(),
                         differ=(d > 0).float().mean().item())
        log(f"  {task} stage {what}: {ms:.3f} ms (CUDA events), "
            f"{host_ms:.3f} ms to issue on the host; end to end card vs "
            f"CPU max {res[task]['max']:.0f} level(s), "
            f"{100 * res[task]['differ']:.4f}% of {d.numel()} values "
            f"differ; bit-equal with allow_tf32 on")
        if res[task]["max"] > AUG_TOL[0] or res[task]["differ"] > AUG_TOL[1]:
            fail(f"augment {task} stage end to end: card vs CPU max "
                 f"{res[task]['max']}, {res[task]['differ']:.2e} of values "
                 f"differ (tolerance {AUG_TOL})")
        profile_calls(f"augment stage {task} {what}", fn, n=3, warmup=1)
    return res


def train_cli_run(argv, name, on_start=None):
    """``rscotr_tpu_torch.tools.train.main(argv)`` with every count at 0
    just before and read just after. Returns the run: per iteration
    (``steps``) its task, step, launches (since the hooks of the iteration
    before), log vars, CUDA-event span, host wall and peak memory; the
    run's ``total`` launches and ``wall``; whether a parameter of the
    backbone and of each task's head ``moved`` over the run; the runner's
    ``end_step`` and ``end_opt_step``. ``on_start(runner)`` runs in the
    first hook's ``before_run``."""
    from rscotr_tpu_torch.engine import train_step as ts_mod
    from rscotr_tpu_torch.engine.hooks import Hook
    from rscotr_tpu_torch.tools import train as train_cli
    counters = kernel_counters()
    steps, moved = [], {}
    watch = ("backbone.", "cls_head.", "bbox_head.", "seg_head.")

    class Probe(Hook):
        """First hook of an iteration (priority 0): the step's launches
        since ``Tail`` (priority 100) closed the iteration before."""
        priority = 0

        def before_run(self, runner):
            if on_start is not None:
                on_start(runner)
            self.first = {}
            for n, p in runner.model.named_parameters():
                top = next((w for w in watch if n.startswith(w)), None)
                if top and top not in self.first and p.requires_grad:
                    self.first[top] = (n, p.detach().clone())
            self.last = launch_counts(counters)

        def after_train_iter(self, runner):
            now = launch_counts(counters)
            steps[-1]["launches"] = {k: now[k] - self.last[k] for k in now}
            steps[-1]["step"] = runner.step
            steps[-1]["log_vars"] = dict(runner.log_vars)

        def after_run(self, runner):
            params = dict(runner.model.named_parameters())
            for top, (n, before) in self.first.items():
                moved[top] = not torch.equal(before, params[n])

    class Tail(Hook):
        priority = 100

        def after_train_iter(self, runner):
            probe.last = launch_counts(counters)

    probe = Probe()
    real_make = ts_mod.make_train_step

    def timed_make(model, optimizer, task, step_cfg, mask=None):
        step = real_make(model, optimizer, task, step_cfg, mask)

        def call(batch, generator):
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            lv = step(batch, generator)
            end.record()
            steps.append(dict(task=task, events=(start, end),
                              host_ms=1e3 * (time.perf_counter() - t0),
                              peak_mib=torch.cuda.max_memory_allocated()
                              / 2 ** 20))
            return lv
        return call

    log(f"  {name}: rscotr_tpu_torch.tools.train {' '.join(argv)}")
    ts_mod.make_train_step = timed_make
    try:
        zero_counts(counters)
        t0 = time.perf_counter()
        runner = train_cli.main(argv, hooks=[probe, Tail()])
        wall = time.perf_counter() - t0
        total = launch_counts(counters)
        torch.cuda.synchronize()
        run = dict(steps=steps, total=total, moved=moved, wall=wall,
                   end_step=runner.step, end_opt_step=runner.optimizer.step)
        del runner
    finally:
        ts_mod.make_train_step = real_make
        torch.cuda.empty_cache()
    for s in steps:
        start, end = s.pop("events")
        s["ms"] = start.elapsed_time(end)
    return run


def check_loop_run(name, run, want_tasks, first_step=1, extra=None):
    """A ``train_cli_run``: its steps in the derived task order, numbered
    from ``first_step``; each iteration's launches ``LOOP_WANT`` (every K1
    and K1b on the vector body, no quad-path kernel); every loss term and
    grad_norm finite; the run's K1 / K1b / K2 / K2b totals the steps' sum
    plus ``extra`` (the eval hook's launches)."""
    steps = run["steps"]
    if [s["task"] for s in steps] != want_tasks or \
            [s["step"] for s in steps] != list(
                range(first_step, first_step + len(want_tasks))):
        fail(f"{name}: steps {[(s['step'], s['task']) for s in steps]}, "
             f"not the derived order {want_tasks} from {first_step}")
    for s in steps:
        got = s["launches"]
        want = dict(LOOP_WANT[s["task"]], **dict.fromkeys(QUAD, 0))
        if {k: got[k] for k in want} != want or \
                (got["K1 vec"], got["K1b vec"]) != (got["K1"], got["K1b"]):
            fail(f"{name} step {s['step']} ({s['task']}): launches {got} "
                 f"!= {want}, all K1 / K1b on the vector body")
        # every loss term, their sum and grad_norm (read here, after the
        # run: the loop itself syncs only in its log hook)
        vals = {k: float(v) for k, v in s["log_vars"].items()}
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"{name} step {s['step']}: non-finite log vars {vals}")
    extra = extra or {}
    want_total = {k: sum(LOOP_WANT[t][k] for t in want_tasks)
                  + extra.get(k, 0) for k in ("K1", "K1b", "K2", "K2b")}
    total = run["total"]
    if {k: total[k] for k in want_total} != want_total or \
            any(total[k] for k in QUAD):
        fail(f"{name}: launches {total} != {want_total} (the steps' and "
             f"{extra}), no quad-path kernel")


def loop_report(name, steps, smi):
    """Per task: the median step (CUDA events around the step call, no
    host sync added) and host wall over the steps after each group's
    first, that first step, the median data_time, the peak memory. Per
    run: each group's collection (the data_time of its first step; the
    run's first also starts the loaders), the data-wait share of the
    steps' time, and that share after step 1 (the steady wait)."""
    res = {}
    starts = [i for i, s in enumerate(steps)
              if i == 0 or steps[i - 1]["task"] != s["task"]]
    for task in ("cls", "det", "seg"):
        every = [s for s in steps if s["task"] == task]
        after = [s for i, s in enumerate(steps)
                 if s["task"] == task and i not in starts]
        r = res[task] = dict(
            median_ms=float(np.median([s["ms"] for s in after])),
            median_host_ms=float(np.median([s["host_ms"] for s in after])),
            first_ms=every[0]["ms"], steps=len(after),
            median_data_ms=1e3 * float(np.median(
                [float(s["log_vars"]["data_time"]) for s in every])),
            peak_mib=max(s["peak_mib"] for s in every))
        log(f"  {name} {task} step: median {r['median_ms']:.2f} ms (CUDA "
            f"events), host {r['median_host_ms']:.2f} ms, over "
            f"{r['steps']} steps after each group's first "
            f"({r['first_ms']:.2f} ms); median data_time "
            f"{r['median_data_ms']:.3f} ms; peak memory "
            f"{r['peak_mib']:.0f} MiB  [{smi}]")
    data = [float(s["log_vars"]["data_time"]) for s in steps]
    whole = [float(s["log_vars"]["time"]) for s in steps]
    res["data_share"] = sum(data) / sum(whole)
    res["steady_share"] = sum(data[1:]) / sum(whole[1:])
    res["group_data_ms"] = [1e3 * data[i] for i in starts]
    log(f"  {name} data wait: {100 * res['data_share']:.2f}% of the "
        f"{len(steps)} steps' time, {100 * res['steady_share']:.2f}% after "
        f"step 1; the groups' collections "
        + ", ".join(f"{x:.1f}" for x in res["group_data_ms"])
        + f" ms (the first starts the loaders)  [{smi}]")
    return res


def first_launches(name, run, n_steps, extra=""):
    """The K1 / K1b / K2 / K2b launches of each task's first step and of
    the whole run, for the kernels line's paths."""
    out = {f"{name} {t} step": {
        k: next(s for s in run["steps"] if s["task"] == t)["launches"][k]
        for k in ("K1", "K1b", "K2", "K2b")} for t in ("cls", "det", "seg")}
    out[f"{name} run ({n_steps} steps{extra})"] = {
        k: run["total"][k] for k in ("K1", "K1b", "K2", "K2b")}
    return out


def as_written(path):
    """A config file composed as the train CLI composes it."""
    from rscotr_tpu_torch.data import load_data_cfg
    from rscotr_tpu_torch.utils.config import load_cfg
    return load_data_cfg(load_cfg(path), config_root=ROOT, filename=path)


def augmented(cfg) -> str:
    """The config's device-augment options that are on, or ''."""
    on = [f"{n}.{k}" for n, e in cfg["data"].items()
          for k in ("cls_device_augment", "det_device_augment",
                    "seg_device_augment") if e.get("loader", {}).get(k)]
    return "on-device augmentation " + ", ".join(on) if on else ""


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
    counters = kernel_counters()
    rng = np.random.default_rng(1)
    launches, calls, res = {}, {}, {}

    def counted(name, want, fn):
        """Run ``fn`` with every count at 0, check the launches, and return
        (fn's result, device ms by CUDA events). No zoo path launches a
        quad-path kernel."""
        want = dict(want, **dict.fromkeys(QUAD, 0))
        zero_counts(counters)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        now = launch_counts(counters)
        got = {k: now[k] for k in counters}
        vec = (now["K1 vec"], now["K1b vec"])
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
    cfg = as_written(PAPER_CFG)
    hw = derive_cls_hw(cfg)
    log(f"zoo phase: paper MTL (MlvlClsHead scheme "
        f"{cfg['model']['cls_head']['scheme']}, cls_hw {hw}), cls task, "
        f"bf16, random weights (seed 0); the config as written, "
        f"{augmented(cfg)}; train batches from its planner")
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
    batch = aug_batch(cfg, "resisc")
    if batch["img"].shape != (16, 256, 256, 3) or "aug_op_id" not in batch:
        fail(f"paper MTL: cls batch {batch['img'].shape} without records")
    train("paper MTL cls 16x224^2 step", model,
          steps_for(cfg, model, "cls", mask), batch, 3,
          {"K1": 6, "K1b": 6, "K2": 12, "K2b": 12},
          "shared_encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, probs
    torch.cuda.empty_cache()

    # -- DINO-R50: det 1x800^2 --------------------------------------------
    cfg = as_written(DINO_R50_CFG)
    log(f"zoo phase: DINO-R50 det (MTL, ResNet-50, det head), bf16, random "
        f"weights (seed 0); the config as written, {augmented(cfg)}; train "
        "batches from its planner")
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
    batch = aug_batch(cfg, "dior")
    if "aug_s2_h" not in batch:
        fail("DINO-R50: det batch without records")
    log(f"  DINO-R50 det batch: 1x800^2 source, AutoAugment program s1 "
        f"{batch['aug_s1_h'][0]}x{batch['aug_s1_w'][0]}, crop "
        f"{batch['aug_crop_h'][0]}x{batch['aug_crop_w'][0]}, s2 "
        f"{batch['aug_s2_h'][0]}x{batch['aug_s2_w'][0]} in the "
        f"{batch['out_template'].shape[1:3]} bucket, flip "
        f"{bool(batch['aug_flip_src'][0])}")
    train("DINO-R50 det 1x800^2 step", model,
          steps_for(cfg, model, "det", mask), batch, 3,
          {"K1": 12, "K1b": 12, "K2": 0, "K2b": 0},
          "shared_encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, det, labels
    torch.cuda.empty_cache()

    # -- RSCoTrSeg-R50: seg 2x512^2 ---------------------------------------
    cfg = as_written(RSEG_R50_CFG)
    log(f"zoo phase: RSCoTrSeg-R50 seg (ResNet-50, own 3-level encoder), "
        f"bf16, random weights (seed 0); the config as written, "
        f"{augmented(cfg)}; train batches from its planner")
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
    batch = aug_batch(cfg, "potsdam")
    if "aug_pm_hsv_on" not in batch:
        fail("RSCoTrSeg-R50: seg batch without records")
    train("RSCoTrSeg-R50 seg 2x512^2 step", model,
          steps_for(cfg, model, "seg", None), batch, 3,
          {"K1": 6, "K1b": 6, "K2": 0, "K2b": 0},
          "encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, labels
    torch.cuda.empty_cache()
    return launches, res


# the flagship's val sets: dataset -> (task, batches, images a batch)
EVAL_SETS = {"resisc": ("cls", 4, 8), "dior": ("det", 2, 4),
             "potsdam": ("seg", 2, 4)}
# K1, K2 launches per eval batch, as in serving (K1: 6 encoder + 6 decoder
# layers per det forward, the pixel decoder's 6 encoder layers per seg one;
# K2: 12 Swin blocks per backbone pass)
EVAL_WANT = {"cls": (0, 12), "det": (12, 12), "seg": (6, 12)}


def eval_phase(smi):
    """The port's evaluation on the card, in three parts. (1) The flagship
    (seed 0) saved with ``save_checkpoint`` and loaded through
    ``resolve_checkpoint(work_dir/latest.pth)`` into a model built from
    seed 1: its cls, det and seg outputs on the first val batch of each
    task equal the saver's bit for bit. (2) ``rscotr_tpu_torch.tools.
    test.main`` on that checkpoint over the whole val sets (cls 4 x 8 x
    224^2, det 2 x 4 x 800^2, seg 2 x 4 x 512^2), every count set to 0 just
    before and read just after; each infer call is counted alone too (K1 /
    K2 per batch as ``EVAL_WANT``, every K1 on the vector body, no backward
    or quad-path launch); the metric keys and values checked; per dataset
    the median batch time after one untimed batch, images/s, the loader's
    and the step's share of the wall time and the peak memory. Then the seg
    logits path (a batch that must be cropped and resized) timed once. (3)
    The tiny config's ``make_val_step`` for cls, det and seg on the CPU
    (plain versions) and on the card (kernels), float32, TF32 off, every
    log var within SLICE_TOL (relative above 1)."""
    import shutil
    import tempfile

    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.data import build_dataloaders, build_datasets
    from rscotr_tpu_torch.engine import infer as infer_mod
    from rscotr_tpu_torch.engine import (load_checkpoint, make_infer_steps,
                                         make_val_step, resolve_checkpoint,
                                         save_checkpoint)
    from rscotr_tpu_torch.engine.test import _seg_results
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.tools import test as test_cli
    from rscotr_tpu_torch.utils.config import load_cfg
    counters = kernel_counters()

    def counts():
        return launch_counts(counters)

    cfg = load_cfg(FLAGSHIP_CFG)
    stc = cfg["model"]["test_cfg"]["seg"]
    log("eval phase: flagship MTL, bf16, random weights (seed 0), saved and "
        "evaluated over the synthetic val sets")
    work_dir = tempfile.mkdtemp(prefix="rscotr_eval_")
    try:
        # -- 1. checkpoint round trip -------------------------------------
        datasets = build_datasets(cfg["data"], split="val")
        classes = {n: list(d.CLASSES) for n, d in datasets.items()}
        loaders = build_dataloaders(datasets, cfg["data"], train=False)
        batches = {d.task: next(iter(loaders[n]))
                   for n, d in datasets.items()}
        model = build_model(cfg["model"], device="cuda",
                            generator=torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        path = save_checkpoint(work_dir, 0, model, meta={"CLASSES": classes})
        t_save = time.perf_counter() - t0
        fresh = build_model(cfg["model"], device="cuda",
                            generator=torch.Generator().manual_seed(1))
        t0 = time.perf_counter()
        ck = load_checkpoint(resolve_checkpoint(
            os.path.join(work_dir, "latest.pth")), model=fresh)
        t_load = time.perf_counter() - t0
        if ck["path"] != path or ck["meta"]["CLASSES"] != classes:
            fail(f"checkpoint: latest.pth resolved to {ck['path']}, not "
                 f"{path}, or its CLASSES differ")
        outs = []
        for m in (model, fresh):
            steps = make_infer_steps(m, max_per_img=300, seg_test_cfg=stc)
            det = batches["det"]
            outs.append((steps["cls"](batches["cls"]["img"]),
                         *steps["det"](det["img"], det["img_hw"],
                                       det["scale_factor"]),
                         steps["seg"](batches["seg"]["img"])))
        names = ("cls probs", "det boxes", "det labels", "seg labels")
        for name, a, b in zip(names, *outs):
            if not torch.equal(a, b):
                fail(f"checkpoint round trip: {name} {tuple(a.shape)} differ "
                     f"(max abs {(a.float() - b.float()).abs().max():.3e})")
        mib = os.path.getsize(path) / 2 ** 20
        log(f"  checkpoint: {os.path.basename(path)} {mib:.1f} MiB, "
            f"{len(ck['state_dict'])} tensors, saved in {t_save:.2f} s, "
            f"loaded (strict) into a seed-1 model in {t_load:.2f} s; "
            f"{', '.join(names)} of the first val batches bit-equal")
        del model, fresh, outs, steps
        torch.cuda.empty_cache()

        # -- 2. the CLI end to end ----------------------------------------
        calls = []
        real = infer_mod.make_infer_steps

        def counted_steps(*a, **kw):
            def wrap(task, fn):
                def call(*args):
                    before = counts()
                    out = fn(*args)
                    after = counts()
                    calls.append((task, {k: after[k] - before[k]
                                         for k in after}))
                    return out
                return call
            return {t: wrap(t, f) for t, f in real(*a, **kw).items()}

        stats = {}
        out = os.path.join(work_dir, "eval_metrics.json")
        argv = [FLAGSHIP_CFG, os.path.join(work_dir, "latest.pth"),
                "--eval-out", out, "--work-dir", work_dir]
        log(f"  rscotr_tpu_torch.tools.test {' '.join(argv)}")
        infer_mod.make_infer_steps = counted_steps
        try:
            zero_counts(counters)
            t0 = time.perf_counter()
            metrics = test_cli.main(argv, stats=stats)
            wall = time.perf_counter() - t0
            total = counts()
        finally:
            infer_mod.make_infer_steps = real
        if json.dumps(json.load(open(out)), sort_keys=True) != \
                json.dumps(metrics, sort_keys=True):
            fail("eval: --eval-out holds other metrics than main returned")
        per_task = {}
        for task, got in calls:
            per_task[task] = per_task.get(task, 0) + 1
            want = dict.fromkeys(got, 0)
            want.update(zip(("K1", "K2"), EVAL_WANT.get(task, (-1, -1))))
            want["K1 vec"] = want["K1"]
            if got != want:
                fail(f"eval {task} batch: launches {got} != {want}")
        want_calls = {t: n for t, n, _ in EVAL_SETS.values()}
        if per_task != want_calls:
            fail(f"eval: infer calls {per_task} != {want_calls} (the seg "
                 "tiles take the on-device argmax, no logits call)")
        launches = {k: total[k] for k in counters}
        want_total = {"K1": sum(EVAL_WANT[t][0] * n for t, n in
                                want_calls.items()),
                      "K2": sum(EVAL_WANT[t][1] * n for t, n in
                                want_calls.items())}
        if total["K1 vec"] != total["K1"] or any(
                launches[k] != want_total.get(k, 0) for k in launches):
            fail(f"eval: launches {total} != {want_total}, all K1 on the "
                 "vector body, nothing else")
        log(f"  launches in the eval run: {total} (per batch K1 / K2: "
            + ", ".join(f"{t} {k1} / {k2}" for t, (k1, k2) in
                        EVAL_WANT.items())
            + f"; batches {want_calls})")

        dior = classes["dior"]
        want_keys = (["resisc.accuracy_top-1", "dior.bbox_mAP",
                      "potsdam.mIoU", "potsdam.mFscore"]
                     + [f"dior.bbox_AP_{c}" for c in dior])
        missing = [k for k in want_keys if k not in metrics]
        if missing:
            fail(f"eval: metric keys missing: {missing}")
        # 0 / 0, as mm gives it: a det class with no GT in the val set has
        # no AP (the flagship's 8 images hold all 20); a seg class the
        # model never predicts has no precision (nor F-score), its IoU 0
        gt = set(np.concatenate([a["labels"] for a in
                                 datasets["dior"].get_annotations()]))
        nan_ok = {f"dior.bbox_AP_{c}" for i, c in enumerate(dior)
                  if i not in gt}
        nan_ok |= {f"potsdam.{m}.{c}" for c in classes["potsdam"]
                   for m in ("Precision", "Fscore")
                   if metrics.get(f"potsdam.IoU.{c}") == 0.0}
        bad = [k for k, v in metrics.items()
               if not np.isfinite(v) and k not in nan_ok]
        if bad:
            fail(f"eval: non-finite metrics {bad}")
        nans = sorted(k for k in nan_ok if not np.isfinite(metrics[k]))
        log(f"  metrics: {len(metrics)} keys, finite but for 0/0 at {nans};"
            " " + ", ".join(f"{k} {metrics[k]:.4f}" for k in want_keys[:4]))

        res = {}
        for name, (task, n, bs) in EVAL_SETS.items():
            s = stats[name]
            load, infer = s["load_s"][1:], s["infer_s"][1:]
            batch_ms = [1e3 * (a + b) for a, b in zip(load, infer)]
            res[name] = dict(
                task=task, batches=n, batch_size=bs,
                median_batch_ms=float(np.median(batch_ms)),
                images_per_s=bs * len(batch_ms) / (sum(batch_ms) / 1e3),
                load_share=sum(load) / (sum(load) + sum(infer)),
                infer_share=sum(infer) / (sum(load) + sum(infer)),
                first_batch_ms=1e3 * (s["load_s"][0] + s["infer_s"][0]),
                peak_mib=s["peak_bytes"] / 2 ** 20)
            r = res[name]
            log(f"  eval {name} ({task} {n} x {bs}): median batch "
                f"{r['median_batch_ms']:.2f} ms over {len(batch_ms)} after "
                f"1 untimed ({r['first_batch_ms']:.2f} ms); "
                f"{r['images_per_s']:.1f} images/s; loader "
                f"{100 * r['load_share']:.1f}% / infer step "
                f"{100 * r['infer_share']:.1f}% of the wall time; peak "
                f"memory {r['peak_mib']:.0f} MiB  [{smi}]")
        log(f"  the CLI's whole run (model build, checkpoint load, 8 batches,"
            f" metrics) {wall:.2f} s")

        # the seg logits path: the same tiles as if cropped from 384 x 512
        # and resized back to 300 x 400 (f32 logits to the host, numpy
        # crop, bilinear resize and argmax, as the JAX package does)
        model = build_model(cfg["model"], device="cuda",
                            generator=torch.Generator().manual_seed(0))
        steps = make_infer_steps(model, max_per_img=300, seg_test_cfg=stc)
        batch = dict(batches["seg"], img_hw=np.tile([[384, 512]], (4, 1)),
                     ori_hw=np.tile([[300, 400]], (4, 1)))
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds = _seg_results(steps, batch, 4)
            ms = 1e3 * (time.perf_counter() - t0)
        if [p.shape for p in preds] != [(300, 400)] * 4:
            fail(f"seg logits path: label maps {[p.shape for p in preds]}")
        t0 = time.perf_counter()
        lg = steps["seg_logits"](batch["img"]).cpu()
        step_ms = 1e3 * (time.perf_counter() - t0)
        mib = lg.numel() * 4 / 2 ** 20
        res["seg logits path"] = dict(ms=ms, logits_step_ms=step_ms,
                                      logits_mib=mib)
        log(f"  seg logits path, 4 x 512^2 cropped to 384 x 512 and resized "
            f"to 300 x 400: {ms:.1f} ms a batch (second call), of which "
            f"the logits step with its f32 {tuple(lg.shape)} ({mib:.0f} MiB)"
            f" copied to the host {step_ms:.1f} ms, the rest numpy crop, "
            f"resize and argmax  [{smi}]")
        del model, steps, lg, preds
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # -- 3. the val step, CPU vs card -------------------------------------
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = load_cfg(TINY_CFG)
    step_cfg = make_step_config(tiny)
    cpu = build_model(tiny["model"], device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = build_model(tiny["model"], device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    cls_b, det_b, noises = tiny_train_batches(step_cfg.cdn)
    seg_b = seg_train_batch(np.random.default_rng(6), 2, hw=64)
    vbatches = {"cls": cls_b, "det": dict(det_b, **noises[0]), "seg": seg_b}
    for task, batch in vbatches.items():
        got = {}
        for key, m in (("cpu", cpu), ("cuda", gpu)):
            before = counts()
            lv = make_val_step(m, task, step_cfg)(
                batch, torch.Generator().manual_seed(0))
            got[key] = {k: float(v) for k, v in lv.items()}
            after = counts()
            if key == "cuda" and any(after[k] != before[k] for k in
                                     ("K1b", "K2b", "K3'", "K4", "K5")):
                fail(f"val step {task}: a backward or quad kernel launched")
        worst = max(abs(got["cpu"][k] - got["cuda"][k]) /
                    max(1.0, abs(got["cpu"][k])) for k in got["cpu"])
        log(f"  val step {task}: {len(got['cpu'])} log vars, CPU vs CUDA "
            f"max err {worst:.2e} (tol {SLICE_TOL:g}, relative above 1); "
            f"loss {got['cpu']['loss']:.5f}")
        if set(got["cpu"]) != set(got["cuda"]) or not worst <= SLICE_TOL:
            fail(f"val step {task}: CPU and CUDA log vars differ")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return launches, res


LOOP_ITERS, LOOP_RESUME = 48, 52
# launches per loop iteration, as in the training phase (det: 6 encoder + 6
# decoder MSDA layers; seg: the pixel decoder's 6 encoder layers; every
# task: 12 Swin blocks); the quad-gather kernels never
LOOP_WANT = {"cls": {"K1": 0, "K1b": 0, "K2": 12, "K2b": 12},
             "det": {"K1": 12, "K1b": 12, "K2": 12, "K2b": 12},
             "seg": {"K1": 6, "K1b": 6, "K2": 12, "K2b": 12}}


def loop_order(cfg, max_iters, k):
    """The task of each step that the port's grouped order gives the
    flagship's train loaders, derived without data or a step: stand-in
    loaders of the real lengths whose batches carry only the task, under
    the config's strategy and stand-in hooks at the checkpoint and eval
    intervals (the log hook does not bound a group)."""
    from rscotr_tpu_torch.data import build_datasets
    from rscotr_tpu_torch.data.build import build_iteration_strategy
    from rscotr_tpu_torch.data.loader import MultiDataLoader
    from rscotr_tpu_torch.engine.hooks import Hook
    from rscotr_tpu_torch.engine.runner import IterBasedRunner

    class Stand:
        def __init__(self, ds, n):
            self.dataset, self.n, self._epoch = ds, n, 0

        def __len__(self):
            return self.n

        def __iter__(self):
            return iter([{"img": np.zeros(0)}] * self.n)

        def set_epoch(self, epoch):
            self._epoch = epoch

    loaders = {}
    for name, ds in build_datasets(cfg["data"]).items():
        bs = cfg["data"][name]["data"].get("samples_per_gpu", 1)
        loaders[name] = Stand(ds, len(ds) // bs)
    mdl = MultiDataLoader(loaders, build_iteration_strategy(cfg, loaders))
    tasks = []
    runner = IterBasedRunner(
        {t: (lambda b, g, t=t: tasks.append(t) or {})
         for t in ("cls", "det", "seg")}, max_iters=max_iters, prefetch=0,
        steps_per_dispatch=k, handle_preemption=False)
    for iv in (cfg["checkpoint_config"]["interval"],
               cfg["evaluation"]["interval"]):
        runner.register_hook(type("Interval", (Hook,), {"interval": iv})())
    runner.run(mdl)
    return tasks


def loop_phase(smi):
    """The co-training loop through the port's ``tools/train.py``
    (``rscotr_tpu_torch.tools.train.main``) on the flagship config as
    written (round_robin, ``steps_per_dispatch=16``: JAX's grouped order),
    full width, bf16, random weights from seed 0, in a temporary work dir,
    ``--max-iters 48``; every count set to 0 just before and read just
    after (``train_cli_run``). Checked (``check_loop_run``): the task of
    each step against ``loop_order`` (16 cls, 16 det, 16 seg), each
    iteration's K1 / K1b / K2 / K2b launches against ``LOOP_WANT`` (every
    K1 and K1b on the vector body, no quad-path kernel), every loss term
    and grad_norm finite, the run's totals those of its steps and its eval;
    the backbone and every head moved; ``iter_48.pth``,
    ``last_checkpoint``, ``best_checkpoint.pth`` and the ``metrics.jsonl``
    lines of the log interval (5) and the last step; the eval hook at step
    48 over the whole val sets with the eval phase's per-batch counts and
    the metric keys. Then ``--resume-from iter_48.pth --max-iters 52
    --no-validate``: the model and the optimizer state at the start equal
    the file bit for bit, the run starts at step 48 with the optimizer's
    schedule clock at 48, and 4 cls steps follow, checked as above.
    Reported: ``loop_report``; the checkpoint save and load times, the
    eval hook's time, the phase's."""
    import shutil
    import tempfile

    from rscotr_tpu_torch import apis
    from rscotr_tpu_torch.engine import checkpoint as ck_mod
    from rscotr_tpu_torch.engine import hooks as hooks_mod
    from rscotr_tpu_torch.engine import infer as infer_mod
    from rscotr_tpu_torch.utils.config import load_cfg
    t_phase = time.perf_counter()
    counters = kernel_counters()
    cfg = load_cfg(FLAGSHIP_CFG)
    K = cfg["runner"]["steps_per_dispatch"]
    want_tasks = loop_order(cfg, LOOP_ITERS, K)
    if want_tasks != ["cls"] * 16 + ["det"] * 16 + ["seg"] * 16:
        fail(f"loop: the grouped order derives {want_tasks}")
    log(f"loop phase: rscotr_tpu_torch.tools.train on the flagship config "
        f"(steps_per_dispatch {K}, round_robin), bf16, random weights "
        f"(seed 0), {LOOP_ITERS} iterations, then a resume to "
        f"{LOOP_RESUME}; derived order: 16 cls, 16 det, 16 seg")

    evals, saves, loads, infer_calls, start = [], [], [], [], {}
    real_save, real_load = hooks_mod.save_checkpoint, ck_mod.load_checkpoint
    real_eval, real_infer = apis.make_eval_fn, infer_mod.make_infer_steps

    def snapshot(runner):
        start.update(step=runner.step, opt_step=runner.optimizer.step,
                     model={k: v.detach().to("cpu", copy=True) for k, v in
                            runner.model.state_dict().items()},
                     opt=runner.optimizer.state_dict())

    def timed(fn, out):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            out.append(time.perf_counter() - t0)
            return r
        return call

    def timed_eval(*a, **kw):
        return timed(real_eval(*a, **kw), evals)

    def counted_infer(*a, **kw):
        def wrap(task, fn):
            def call(*args):
                before = launch_counts(counters)
                out = fn(*args)
                after = launch_counts(counters)
                infer_calls.append((task, {k: after[k] - before[k]
                                           for k in after}))
                return out
            return call
        return {t: wrap(t, f) for t, f in real_infer(*a, **kw).items()}

    work_dir = tempfile.mkdtemp(prefix="rscotr_loop_")
    hooks_mod.save_checkpoint = timed(real_save, saves)
    ck_mod.load_checkpoint = timed(real_load, loads)
    apis.make_eval_fn = timed_eval
    infer_mod.make_infer_steps = counted_infer
    try:
        first = train_cli_run([FLAGSHIP_CFG, "--work-dir", work_dir,
                               "--max-iters", str(LOOP_ITERS)], "loop")
        first["infer"] = infer_calls[:]
        ckpt = os.path.join(work_dir, f"iter_{LOOP_ITERS}.pth")
        for f in (f"iter_{LOOP_ITERS}.pth", "last_checkpoint",
                  "best_checkpoint.pth", "metrics.jsonl", "train.log"):
            if not os.path.isfile(os.path.join(work_dir, f)):
                fail(f"loop: {f} missing from the work dir")
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)

        infer_calls.clear()
        resumed = train_cli_run(
            [FLAGSHIP_CFG, "--work-dir", work_dir, "--max-iters",
             str(LOOP_RESUME), "--resume-from", ckpt, "--no-validate"],
            "loop resume", on_start=snapshot)
        model_equal = all(torch.equal(start["model"][k], v)
                          for k, v in saved["state_dict"].items()) and \
            sorted(start["model"]) == sorted(saved["state_dict"])
        so, po = saved["optimizer"], start["opt"]
        opt_equal = so["step"] == po["step"] and so["count"] == po["count"] \
            and all(torch.equal(po[p][k], v) for p in ("mu", "nu")
                    for k, v in so[p].items())
        del saved, start["model"], start["opt"]
    finally:
        hooks_mod.save_checkpoint = real_save
        ck_mod.load_checkpoint = real_load
        apis.make_eval_fn = real_eval
        infer_mod.make_infer_steps = real_infer
        shutil.rmtree(work_dir, ignore_errors=True)
        torch.cuda.empty_cache()

    # -- the first run ----------------------------------------------------
    infer_total = {k: sum(c[k] for _, c in first["infer"])
                   for k in ("K1", "K2")}
    check_loop_run("loop", first, want_tasks, extra=infer_total)
    if not first["moved"] or not all(first["moved"].values()):
        fail(f"loop: parameters moved {first['moved']}")
    for i in (0, 16, 32, 47):
        s = first["steps"][i]
        vals = {k: float(v) for k, v in s["log_vars"].items()}
        loss = next(v for k, v in vals.items() if k.endswith(".loss"))
        log(f"  loop step {s['step']} {s['task']}: {len(vals) - 2} log vars,"
            f" loss {loss:.4f}, grad_norm {vals['grad_norm']:.3f}, "
            f"launches {s['launches']}")
    log(f"  launches in the loop run (48 steps and the eval at 48): "
        f"{first['total']}; eval {infer_total}")

    # -- logs, checkpoints, eval ------------------------------------------
    want_lines = list(range(5, LOOP_ITERS, 5)) + [LOOP_ITERS]
    if [x["step"] for x in lines] != want_lines:
        fail(f"loop: metrics.jsonl steps {[x['step'] for x in lines]} != "
             f"{want_lines}")
    bad = [(x["step"], k) for x in lines for k, v in x.items()
           if isinstance(v, float) and not k.startswith("val/")
           and not np.isfinite(v)]
    if bad:
        fail(f"loop: non-finite logged values {bad}")
    want_keys = {"val/resisc.accuracy_top-1", "val/dior.bbox_mAP",
                 "val/potsdam.mIoU", "val/potsdam.mFscore"}
    if not want_keys <= set(lines[-1]):
        fail(f"loop: eval keys missing at step 48: "
             f"{want_keys - set(lines[-1])}")
    per_task = {}
    for task, got in first["infer"]:
        per_task[task] = per_task.get(task, 0) + 1
        want = dict.fromkeys(got, 0)
        want.update(zip(("K1", "K2"), EVAL_WANT[task]))
        want["K1 vec"] = want["K1"]
        if got != want:
            fail(f"loop eval {task} batch: launches {got} != {want}")
    want_calls = {t: n for t, n, _ in EVAL_SETS.values()}
    if per_task != want_calls or len(evals) != 1:
        fail(f"loop: the eval hook ran {len(evals)} times over {per_task} "
             f"batches, not once over {want_calls}")
    log(f"  eval hook at step {LOOP_ITERS}: {sum(want_calls.values())} "
        f"batches {per_task}, per batch K1 / K2 as the eval phase; "
        + ", ".join(f"{k} {lines[-1][k]:.4f}" for k in sorted(want_keys)))

    # -- the resume ---------------------------------------------------------
    if not (model_equal and opt_equal):
        fail(f"loop resume: model bit-equal {model_equal}, optimizer state "
             f"bit-equal {opt_equal}")
    if (start["step"], start["opt_step"], resumed["end_step"],
            resumed["end_opt_step"]) != (LOOP_ITERS, LOOP_ITERS,
                                         LOOP_RESUME, LOOP_RESUME):
        fail(f"loop resume: start {start['step']} (optimizer step "
             f"{start['opt_step']}), end {resumed['end_step']} "
             f"({resumed['end_opt_step']})")
    check_loop_run("loop resume", resumed, ["cls"] * (LOOP_RESUME -
                                                      LOOP_ITERS),
                   first_step=LOOP_ITERS + 1)
    log(f"  resume from iter_{LOOP_ITERS}.pth: model and optimizer state "
        f"bit-equal to the file, start at step {start['step']} (the "
        f"optimizer's schedule clock {start['opt_step']}), then "
        f"{[s['task'] for s in resumed['steps']]} with launches "
        f"{resumed['steps'][0]['launches']} each; {resumed['total']}")

    # -- times ---------------------------------------------------------------
    res = loop_report("loop", first["steps"], smi)
    res["save_s"] = list(saves)
    res["load_s"] = list(loads)
    res["eval_s"] = evals[0]
    res["run_s"], res["resume_s"] = first["wall"], resumed["wall"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  loop checkpoint saves "
        + ", ".join(f"{x:.2f}" for x in saves) + " s (best_checkpoint, "
        f"iter_48, iter_52: the eval hook fires first), resume load "
        + ", ".join(f"{x:.2f}" for x in loads) + f" s; eval hook "
        f"{evals[0]:.2f} s; run {first['wall']:.1f} s, resume "
        f"{resumed['wall']:.1f} s, phase {res['phase_s']:.1f} s  [{smi}]")
    return first_launches("flagship loop", first, LOOP_ITERS,
                          " + eval"), res


def aug_loop_phase(smi, stages):
    """Co-training with the paper's augmentation through the port's
    ``tools/train.py``: ``MTL_synthetic_flagship_devaug.py`` (the three
    augment tails in the steps, on the card) and
    ``MTL_synthetic_flagship_hostaug.py`` (the same tails on the host, PIL
    in the loader threads), each as written (``steps_per_dispatch`` 16)
    for 48 iterations in the grouped order (16 cls, 16 det, 16 seg), in
    the order devaug, hostaug, hostaug, devaug so that each holds each
    place; ``--no-validate`` in a temporary work dir, full width, bf16,
    random weights from seed 0. Each run is checked by ``check_loop_run``
    and its backbone and every head must move; reported by
    ``loop_report``, then per config the two runs side by side: each
    task's median step and the steady data wait (after step 1, whose
    collection also starts the loaders). Last, each augment stage's time
    (``augment_phase``) as a share of its task's devaug step."""
    import shutil
    import tempfile

    launches, res = {}, {"devaug": [], "hostaug": []}
    paths = {"devaug": DEVAUG_CFG, "hostaug": HOSTAUG_CFG}
    for name in ("devaug", "hostaug", "hostaug", "devaug"):
        path = paths[name]
        cfg = as_written(path)
        k = cfg["runner"]["steps_per_dispatch"]
        want_tasks = loop_order(cfg, AUG_ITERS, k)
        n = AUG_ITERS // 3
        if want_tasks != ["cls"] * n + ["det"] * n + ["seg"] * n:
            fail(f"{name} loop: the grouped order derives {want_tasks}")
        log(f"{name} loop phase (run {len(res[name]) + 1}): "
            f"{os.path.relpath(path, ROOT)} as written "
            f"({augmented(cfg) or 'augmentation on the host'}), "
            f"steps_per_dispatch {k}, bf16, random weights (seed 0), "
            f"{AUG_ITERS} iterations: {n} cls, {n} det, {n} seg")
        work_dir = tempfile.mkdtemp(prefix=f"rscotr_{name}_")
        try:
            run = train_cli_run([path, "--work-dir", work_dir, "--max-iters",
                                 str(AUG_ITERS), "--no-validate"],
                                f"{name} loop")
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        check_loop_run(f"{name} loop", run, want_tasks)
        if not run["moved"] or not all(run["moved"].values()):
            fail(f"{name} loop: parameters moved {run['moved']}")
        for i in (0, n, 2 * n):
            s = run["steps"][i]
            log(f"  {name} loop step {s['step']} {s['task']}: loss "
                + ", ".join(f"{k} {float(v):.4f}" for k, v in
                            s["log_vars"].items() if k.endswith(".loss"))
                + f", grad_norm {float(s['log_vars']['grad_norm']):.3f}, "
                f"launches {s['launches']}")
        r = loop_report(f"{name} loop", run["steps"], smi)
        r["wall_s"] = run["wall"]
        log(f"  {name} loop run {run['wall']:.1f} s; {run['total']}; moved "
            f"{run['moved']}")
        res[name].append(r)
        if len(res[name]) == 1:
            launches.update(first_launches(f"{name} loop", run, AUG_ITERS))
    for t in ("cls", "det", "seg"):
        log(f"  {t} step, devaug against hostaug (runs 1, 4 against 2, 3): "
            + " / ".join(f"{r[t]['median_ms']:.2f}" for r in res["devaug"])
            + " ms against "
            + " / ".join(f"{r[t]['median_ms']:.2f}" for r in res["hostaug"])
            + f" ms  [{smi}]")
    log("  steady data wait (after step 1), devaug against hostaug: "
        + " / ".join(f"{100 * r['steady_share']:.2f}%"
                     for r in res["devaug"]) + " against "
        + " / ".join(f"{100 * r['steady_share']:.2f}%"
                     for r in res["hostaug"])
        + "; first collections "
        + " / ".join(f"{r['group_data_ms'][0]:.1f}" for r in res["devaug"])
        + " against "
        + " / ".join(f"{r['group_data_ms'][0]:.1f}" for r in res["hostaug"])
        + f" ms  [{smi}]")
    for t, st in stages.items():
        st["step_share"] = st["ms"] / res["devaug"][0][t]["median_ms"]
        log(f"  {t} augment stage {st['what']}: {st['ms']:.3f} ms, "
            f"{100 * st['step_share']:.1f}% of the first devaug {t} "
            f"step's {res['devaug'][0][t]['median_ms']:.2f} ms  [{smi}]")
    res["stages"] = stages
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
    t_start = time.perf_counter()
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
    stages = augment_phase()
    zlaunches, zoo = zoo_phase()
    elaunches, evals = eval_phase(smi)
    llaunches, loop = loop_phase(smi)
    alaunches, aug = aug_loop_phase(smi, stages)
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
    zlaunches["flagship eval (cls 4, det 2, seg 2 batches)"] = elaunches
    zlaunches.update(llaunches)
    zlaunches.update(alaunches)
    launches["paths"] = {k: {path: n[k] for path, n in zlaunches.items()}
                         for k in ("K1", "K1b", "K2", "K2b")}

    log(f"summary ({smi}; {time.perf_counter() - t_start:.1f} s since the "
        f"start): " + "; ".join(
        f"serve {n} {ms:.3f} ms, peak {mb:.0f} MiB"
        for n, (ms, mb) in lat.items()) + "; " + "; ".join(
        f"train {t} {r['median_ms']:.2f} ms, peak {r['peak_mib']:.0f} MiB"
        for t, r in train.items()) + "; " + "; ".join(
        f"{n} {r['median_ms']:.2f} ms, peak {r['peak_mib']:.0f} MiB"
        for n, r in zoo.items()) + "; " + "; ".join(
        f"eval {n} batch {r['median_batch_ms']:.2f} ms, "
        f"{r['images_per_s']:.1f} img/s, loader "
        f"{100 * r['load_share']:.0f}%, peak {r['peak_mib']:.0f} MiB"
        for n, r in evals.items() if n in EVAL_SETS) + "; " + "; ".join(
        f"loop {t} step {loop[t]['median_ms']:.2f} ms, peak "
        f"{loop[t]['peak_mib']:.0f} MiB" for t in ("cls", "det", "seg"))
        + f"; loop data wait {100 * loop['data_share']:.2f}%; " + "; ".join(
        f"{run} loop {t} step " + " / ".join(
            f"{r[t]['median_ms']:.2f}" for r in aug[run]) + " ms, peak "
        f"{aug[run][0][t]['peak_mib']:.0f} MiB"
        for run in ("devaug", "hostaug") for t in ("cls", "det", "seg"))
        + "; " + "; ".join(
        f"{run} steady data wait " + " / ".join(
            f"{100 * r['steady_share']:.2f}%" for r in aug[run])
        for run in ("devaug", "hostaug")) + "; " + "; ".join(
        f"{t} augment stage {st['ms']:.3f} ms "
        f"({100 * st['step_share']:.1f}% of its step)"
        for t, st in aug["stages"].items()) + "; " + "; ".join(
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
