"""Drive the PyTorch port (rscotr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from rscotr_tpu_torch/csrc (one nvcc
   per source, in parallel);
3. kernels: K1 (MSDA forward) and K2 (Swin window attention) against their
   plain PyTorch versions at the flagship's shapes, in float32 and bfloat16,
   with kernel and plain times from CUDA events;
4. backward kernels: K1b (MSDA backward rows), K3' (its value-gradient
   scatter) and K2b (window attention backward), through
   ``torch.autograd.grad`` of the CUDA Functions, against the plain
   decomposition at the flagship's shapes, float32 and bfloat16, timed;
5. slice parity: the tiny config's cls and det tasks on the CPU (plain
   versions) and on the card (kernels), float32, TF32 off;
6. training parity: the tiny config trains cls, det, det, cls on the CPU
   and on the card from the same weights and batches; every loss term per
   step and the final parameters are compared;
7. serving: the flagship MTL (Swin-T, 6-layer shared MSDA encoder,
   600-query DINO head; bf16 compute, random weights from a seed) answers
   cls 16x224^2, det 1x800^2 and det 4x800^2 requests; outputs are checked,
   kernel launches counted, median latency (CUDA events) and peak memory
   reported;
8. training: the flagship trains cls 16x224^2 (mixup / cutmix) and det
   1x800^2 (18 GT boxes padded to 100, 5 CDN groups: 200 DN + 600 matching
   queries) interleaved under the per-task masks, drop path 0.2; losses and
   grad norms are checked finite, the masked modules bit-identical, kernel
   launches counted per step; median step time (CUDA events around the
   whole step, host matcher included), the host matcher's time and peak
   memory reported.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
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

# flagship shapes: det 800^2 encoder levels (strides 8..64) and Swin stages
DET_SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))
K2_SHAPES = {  # name: (B, nW, H, shifted)
    "det800.s0": (1, 841, 3, True), "det800.s1": (1, 225, 6, True),
    "det800.s2": (1, 64, 12, True), "det800.s3": (1, 16, 24, True),
    "cls224.s0": (16, 64, 3, True), "cls224.s1": (16, 16, 6, True),
    "cls224.s2": (16, 4, 12, True), "cls224.s3": (16, 1, 24, False),
}


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


def check_close(name, got, ref, dtype) -> float:
    atol, rtol = TOL[dtype]
    got = got.float()
    err = (got - ref).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    excess = (err - rtol * ref.abs()).max().item()
    max_err = err.max().item()
    log(f"  {name:<34} {str(dtype)[6:]:<8} max_abs_err {max_err:.3e}  "
        f"(tol {atol:g} + {rtol:g}*|ref|)")
    if excess > atol:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max_abs_err {max_err:.3e})")
    return max_err


def msda_inputs(B, Q, dtype, g, H=8, D=32, P=4, shapes=DET_SHAPES):
    L = len(shapes)
    Nv = sum(h * w for h, w in shapes)
    v = torch.randn(B, Nv, H, D, device="cuda", generator=g).to(dtype)
    # locations straddle the border to exercise the validity masking
    loc = torch.rand(B, Q, H, L, P, 2, device="cuda", generator=g) * 1.4 - 0.2
    w = torch.rand(B, Q, H, L, P, device="cuda", generator=g)
    w = (w / w.sum((-1, -2), keepdim=True)).to(dtype)
    return v, shapes, loc, w


def wa_inputs(B, nW, H, shifted, dtype, g, n=49, hd=32):
    from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
    q, k, v = (torch.randn(B, nW, H, n, hd, device="cuda",
                           generator=g).to(dtype) for _ in range(3))
    bias = torch.randn(H, n, n, device="cuda", generator=g) * 0.02
    mask = None
    if shifted:
        side = int(round(nW ** 0.5)) * 7
        mask = torch.as_tensor(_shift_attn_mask(side, side, 7, 3),
                               device="cuda")
    return q, k, v, bias, mask, hd ** -0.5


def kernel_phase():
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_torch)
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}   # [f32, bf16]
    times = {}
    log("kernel phase: K1 msda_fwd vs ms_deform_attn_torch")
    Nv = sum(h * w for h, w in DET_SHAPES)
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, Q in (("det-encoder B=1", 1, Nv),
                           ("decoder B=1 Q=600", 1, 600),
                           ("det-encoder B=4", 4, Nv)):
            v, shapes, loc, w = msda_inputs(B, Q, dtype, g)
            got = ms_deform_attn(v, shapes, loc, w)
            torch.cuda.synchronize()
            ref = ms_deform_attn_torch(v.float(), shapes, loc, w.float())
            e = check_close(f"K1 {name}", got, ref, dtype)
            err["K1"][dtype == torch.bfloat16] = max(
                err["K1"][dtype == torch.bfloat16], e)
            if dtype == torch.bfloat16 and B == 1:
                times[f"K1 {name}"] = (
                    cuda_ms(lambda: ms_deform_attn(v, shapes, loc, w), 50),
                    cuda_ms(lambda: ms_deform_attn_torch(v, shapes, loc, w),
                            10))
    log("kernel phase: K2 window_attn vs window_attention_torch")
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, nW, H, shifted) in K2_SHAPES.items():
            for masked in sorted({False, shifted}):
                q, k, v, bias, mask, scale = wa_inputs(B, nW, H, masked,
                                                       dtype, g)
                got = window_attention(q, k, v, bias, mask, scale)
                torch.cuda.synchronize()
                ref = window_attention_torch(q.float(), k.float(), v.float(),
                                             bias, mask, scale)
                e = check_close(f"K2 {name} {'masked' if masked else ''}",
                                got, ref, dtype)
                err["K2"][dtype == torch.bfloat16] = max(
                    err["K2"][dtype == torch.bfloat16], e)
                if dtype == torch.bfloat16 and masked == shifted and \
                        name in ("det800.s0", "cls224.s0"):
                    times[f"K2 {name}"] = (
                        cuda_ms(lambda: window_attention(q, k, v, bias, mask,
                                                         scale), 50),
                        cuda_ms(lambda: window_attention_torch(
                            q, k, v, bias, mask, scale), 20))
    for name, (ms, plain) in times.items():
        log(f"  time bf16 {name:<28} kernel {ms:.4f} ms   plain "
            f"{plain:.4f} ms")
    return err, times


def tiny_inputs():
    rng = np.random.default_rng(0)
    cls_img = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    det_img = rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    hw = np.array([[128, 128], [100, 120]], np.int32)
    return cls_img, det_img, hw


def slice_parity_phase():
    from rscotr_tpu_torch.engine import device_normalize, make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_model_cfg
    log("slice parity phase: tiny config, CPU (plain) vs CUDA (kernels), "
        "float32, TF32 off")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_model_cfg(TINY_CFG)
    cpu = build_model(cfg, tasks=("cls", "det"), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = build_model(cfg, tasks=("cls", "det"), device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    cls_img, det_img, hw = tiny_inputs()
    sf = np.ones((2, 4), np.float32)
    results = {}
    for key, model in (("cpu", cpu), ("cuda", gpu)):
        dev = next(model.parameters()).device
        steps = make_infer_steps(model, max_per_img=50)
        with torch.inference_mode():
            img_hw = torch.as_tensor(hw, device=dev)
            img = device_normalize(torch.as_tensor(det_img, device=dev),
                                   None, img_hw)
            all_cls, all_coords, _, _ = model.forward_det(img, img_hw)
        det, labels = steps["det"](det_img, hw, sf)
        results[key] = dict(cls=steps["cls"](cls_img), all_cls=all_cls,
                            all_coords=all_coords, det=det,
                            labels=labels)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    for key in ("cls", "all_cls", "all_coords", "det"):
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


def check_grads(name, gots, refs, names, dtype) -> float:
    """Hold each gradient against its plain version; one log line per case
    with each gradient's max abs error / max|ref|. Returns the largest
    max abs error."""
    atol, rtol = BTOL[dtype]
    parts, worst = [], 0.0
    for gname, got, ref in zip(names, gots, refs):
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            fail(f"{name} {gname}: non-finite kernel gradient")
        err = (got - ref).abs()
        scale = ref.abs().max().item()
        max_err = err.max().item()
        if (err - rtol * ref.abs()).max().item() > atol * scale:
            fail(f"{name} {gname}: kernel gradient disagrees with the plain "
                 f"version (max_abs_err {max_err:.3e})")
        parts.append(f"{gname} {max_err:.2e}/{scale:.3g}")
        worst = max(worst, max_err)
    log(f"  {name:<34} {str(dtype)[6:]:<8} max_abs_err/max|ref|: "
        f"{', '.join(parts)}  (tol {atol:g}*max|ref| + {rtol:g}*|ref|)")
    return worst


def backward_phase():
    from rscotr_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn, ms_deform_attn_bwd, ms_deform_attn_bwd_torch,
        msda_bwd_rows, msda_bwd_rows_torch)
    from rscotr_tpu_torch.ops.scatter_mm import (scatter_add_mm,
                                                 scatter_add_mm_torch)
    from rscotr_tpu_torch.ops.window_attention import (
        window_attention, window_attention_bwd, window_attention_bwd_torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    err = {k: [0.0, 0.0] for k in ("K1b", "K3", "K2b")}   # [f32, bf16]
    times = {}
    Nv = sum(h * w for h, w in DET_SHAPES)
    log("backward phase: K1b msda_bwd + K3' scatter_add (autograd through "
        "ms_deform_attn) vs ms_deform_attn_bwd_torch")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, Q in (("det-encoder B=1", Nv),
                        ("train decoder B=1 Q=800", 800)):
            v, shapes, loc, w = msda_inputs(1, Q, dtype, g)
            v, loc, w = (t.requires_grad_() for t in (v, loc, w))
            out = ms_deform_attn(v, shapes, loc, w)
            d_out = torch.randn(out.shape, device="cuda",
                                generator=g).to(dtype)
            got = torch.autograd.grad(out, (v, loc, w), d_out)
            torch.cuda.synchronize()
            v, loc, w = v.detach(), loc.detach(), w.detach()
            ref = ms_deform_attn_bwd_torch(v, shapes, loc, w, d_out)
            e = check_grads(f"K1b+K3' {name}", got, ref,
                            ("d_value", "d_loc", "d_attn"), dtype)
            err["K1b"][bf] = max(err["K1b"][bf], e)
            # K3' alone on this case's d_g / gidx
            d_g, gidx, _, _ = msda_bwd_rows(v, shapes, loc, w, d_out)
            e = check_grads(f"K3' {name}", [scatter_add_mm(d_g, gidx, Nv)],
                            [scatter_add_mm_torch(d_g, gidx, Nv)], ("d_qt",),
                            torch.float32)
            err["K3"][bf] = max(err["K3"][bf], e)
            if bf:
                args = (v, shapes, loc, w, d_out)
                times[f"K1b {name}"] = (
                    cuda_ms(lambda: msda_bwd_rows(*args), 20),
                    cuda_ms(lambda: msda_bwd_rows_torch(*args), 5))
                times[f"K3' {name}"] = (
                    cuda_ms(lambda: scatter_add_mm(d_g, gidx, Nv), 20),
                    cuda_ms(lambda: scatter_add_mm_torch(d_g, gidx, Nv), 5))
                times[f"MSDA bwd {name}"] = (
                    cuda_ms(lambda: ms_deform_attn_bwd(*args), 20),
                    cuda_ms(lambda: ms_deform_attn_bwd_torch(*args), 5))
            del d_g, gidx
    log("backward phase: K2b window_attn_bwd (autograd through "
        "window_attention) vs window_attention_bwd_torch")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (B, nW, H, shifted) in K2_SHAPES.items():
            for masked in sorted({False, shifted}):
                q, k, v, bias, mask, scale = wa_inputs(B, nW, H, masked,
                                                       dtype, g)
                q, k, v, bias = (t.requires_grad_() for t in (q, k, v, bias))
                out = window_attention(q, k, v, bias, mask, scale)
                d_out = torch.randn(out.shape, device="cuda",
                                    generator=g).to(dtype)
                got = torch.autograd.grad(out, (q, k, v, bias), d_out)
                torch.cuda.synchronize()
                q, k, v, bias = (t.detach() for t in (q, k, v, bias))
                ref = window_attention_bwd_torch(q, k, v, bias, mask, scale,
                                                 d_out)
                e = check_grads(f"K2b {name}{' masked' if masked else ''}",
                                got, ref, ("dq", "dk", "dv", "d_rel_bias"),
                                dtype)
                err["K2b"][bf] = max(err["K2b"][bf], e)
                if bf and masked == shifted and \
                        name in ("det800.s0", "cls224.s0"):
                    args = (q, k, v, bias, mask, scale, d_out)
                    times[f"K2b {name}"] = (
                        cuda_ms(lambda: window_attention_bwd(*args), 20),
                        cuda_ms(lambda: window_attention_bwd_torch(*args),
                                5))
    for name, (ms, plain) in times.items():
        log(f"  time bf16 {name:<36} kernel {ms:.4f} ms   plain "
            f"{plain:.4f} ms")
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
    from rscotr_tpu_torch.ops.ms_deform_attn import msda_bwd_rows
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
        k1b, k2b = msda_bwd_rows.launches, window_attention_bwd.launches
        for i, task in enumerate(("cls", "det", "det", "cls")):
            batch = cls_b if task == "cls" else dict(det_b, **noises[i - 1])
            lv = steps[task](batch, gen)
            logs[dev].append((task, {k: float(v) for k, v in lv.items()}))
        if dev == "cuda" and (msda_bwd_rows.launches == k1b or
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
    from rscotr_tpu_torch.ops.window_attention import window_attention
    from rscotr_tpu_torch.utils.config import load_model_cfg
    log("serving phase: flagship MTL (cls + det), bf16, random weights "
        "(seed 0)")
    cfg = load_model_cfg(FLAGSHIP_CFG)
    t0 = time.perf_counter()
    model = build_model(cfg, tasks=("cls", "det"), device="cuda",
                        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  built {n_params} params on cuda in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = make_infer_steps(model, max_per_img=300)
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
    }
    # -- the main path's run: one request of each kind, counted -----------
    # K1: 6 encoder + 6 decoder layers per det forward; K2: 12 Swin blocks
    # per backbone pass
    want = {"cls": (0, 12), "det": (12, 12)}
    ms_deform_attn.launches = 0
    window_attention.launches = 0
    outs = {}
    for name, (task, args) in reqs.items():
        k1, k2 = ms_deform_attn.launches, window_attention.launches
        outs[name] = steps[task](*args)
        got = (ms_deform_attn.launches - k1, window_attention.launches - k2)
        log(f"  launches in {name}: K1 {got[0]}, K2 {got[1]} (want "
            f"{want[task][0]}, {want[task][1]})")
        if got != want[task]:
            fail(f"{name}: kernel launches {got} != {want[task]}")
    torch.cuda.synchronize()
    launches = {"K1": ms_deform_attn.launches, "K2": window_attention.launches}
    log(f"  launches in the main path's run: K1 {launches['K1']}, K2 "
        f"{launches['K2']}")

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


def train_phase():
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.models.heads import dino_loss as dl
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     msda_bwd_rows)
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_bwd)
    from rscotr_tpu_torch.utils.config import load_cfg
    log("training phase: flagship MTL (cls + det), bf16 compute, f32 "
        "params, drop path 0.2, random weights (seed 0)")
    cfg = load_cfg(FLAGSHIP_CFG)
    model = build_model(cfg["model"], tasks=("cls", "det"), device="cuda",
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
    steps = {t: make_train_step(model, opt, t, step_cfg, masks[t])
             for t in ("cls", "det")}
    rng = np.random.default_rng(0)
    batches = {"cls": dict(
        img=rng.integers(0, 256, (16, 224, 224, 3)).astype(np.uint8),
        gt_label=rng.integers(0, 45, 16).astype(np.int32)),
        "det": flagship_det_batch(rng)}
    frozen = {"cls": ("bbox_head.", "neck.", "shared_encoder."),
              "det": ("cls_head.",)}
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
    counters = {"K1": ms_deform_attn, "K1b": msda_bwd_rows,
                "K3'": scatter_add_mm, "K2": window_attention,
                "K2b": window_attention_bwd}
    want = {"det": {"K1": 12, "K1b": 12, "K3'": 12, "K2": 12, "K2b": 12},
            "cls": {"K1": 0, "K1b": 0, "K3'": 0, "K2": 12, "K2b": 12}}
    gen = torch.Generator().manual_seed(0)
    # -- the main path's run: 2 warm-up + 10 timed steps of each task ----
    for fn in counters.values():
        fn.launches = 0
    times = {"cls": [], "det": []}
    peak = {"cls": 0.0, "det": 0.0}
    schedule = ["cls", "det"] * 12
    try:
        for i, task in enumerate(schedule):
            snap = {n: p.detach().clone() for n, p in params.items()
                    if n.startswith(frozen[task])}
            before = {k: fn.launches for k, fn in counters.items()}
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lv = steps[task](batches[task], gen)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            got = {k: fn.launches - before[k] for k, fn in counters.items()}
            if got != want[task]:
                fail(f"{task} step {i}: kernel launches {got} != "
                     f"{want[task]}")
            vals = {k: float(v) for k, v in lv.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                fail(f"{task} step {i}: non-finite loss terms {vals}")
            moved = [n for n, p in snap.items()
                     if not torch.equal(p, params[n])]
            if moved:
                fail(f"{task} step {i}: masked parameters moved: "
                     f"{moved[:5]}")
            if i >= 4:
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
    for task in ("cls", "det"):
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


def main() -> int:
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

    err, times = kernel_phase()
    berr, btimes = backward_phase()
    slice_parity_phase()
    train_parity_phase()
    launches, lat = serving_phase()
    tlaunches, train = train_phase()

    log(f"summary ({smi}): " + "; ".join(
        f"serve {n} {ms:.3f} ms, peak {mb:.0f} MiB"
        for n, (ms, mb) in lat.items()) + "; " + "; ".join(
        f"train {t} {r['median_ms']:.2f} ms, peak {r['peak_mib']:.0f} MiB"
        for t, r in train.items()))
    log(smi)
    k1_ms, k1_plain = times["K1 det-encoder B=1"]
    k2_ms, k2_plain = times["K2 det800.s0"]
    k1b_ms, k1b_plain = btimes["K1b det-encoder B=1"]
    k3_ms, k3_plain = btimes["K3' det-encoder B=1"]
    k2b_ms, k2b_plain = btimes["K2b det800.s0"]
    det_enc = "det encoder B=1 Q=Nv=13294 H=8 L=4 P=4 D=32 bf16"
    det_s0 = "det 800^2 stage 0 B=1 nW=841 H=3 n=49 hd=32 shifted bf16"
    print(json.dumps({"kernels": [
        {"name": "msda_fwd", "route": "cuda",
         "source": "rscotr_tpu_torch/csrc/msda_fwd.cu",
         "replaces": "rscotr_tpu/ops/pallas/ms_deform_attn_kernel.py:138",
         "launches": tlaunches["K1"], "launches_serving": launches["K1"],
         "max_abs_err": err["K1"][0], "max_abs_err_bf16": err["K1"][1],
         "ms": k1_ms, "plain_ms": k1_plain, "timed_at": det_enc},
        {"name": "window_attn", "route": "cuda",
         "source": "rscotr_tpu_torch/csrc/window_attn.cu",
         "replaces": "rscotr_tpu/ops/pallas/window_attention.py:116",
         "launches": tlaunches["K2"], "launches_serving": launches["K2"],
         "max_abs_err": err["K2"][0], "max_abs_err_bf16": err["K2"][1],
         "ms": k2_ms, "plain_ms": k2_plain, "timed_at": det_s0},
        {"name": "msda_bwd", "route": "cuda",
         "source": "rscotr_tpu_torch/csrc/msda_bwd.cu",
         "replaces": "rscotr_tpu/ops/pallas/ms_deform_attn_kernel.py:138",
         "replaces_part": "backward (JAX: autodiff of _ms_deform_attn_xla, "
                          "rscotr_tpu/ops/ms_deform_attn.py:270)",
         "launches": tlaunches["K1b"],
         "max_abs_err": berr["K1b"][0], "max_abs_err_bf16": berr["K1b"][1],
         "ms": k1b_ms, "plain_ms": k1b_plain, "timed_at": det_enc},
        {"name": "scatter_add", "route": "cuda",
         "source": "rscotr_tpu_torch/csrc/scatter_add.cu",
         "replaces": "rscotr_tpu/ops/pallas/scatter_mm.py:168",
         "launches": tlaunches["K3'"],
         "max_abs_err": berr["K3"][0], "max_abs_err_bf16": berr["K3"][1],
         "ms": k3_ms, "plain_ms": k3_plain,
         "timed_at": "det encoder d_g (8, 212704, 128) bf16 -> (8, 13294, "
                     "128) f32"},
        {"name": "window_attn_bwd", "route": "cuda",
         "source": "rscotr_tpu_torch/csrc/window_attn_bwd.cu",
         "replaces": "rscotr_tpu/ops/pallas/window_attention.py:116",
         "replaces_part": "backward (JAX: autodiff of the einsum path, "
                          "rscotr_tpu/models/backbones/swin.py:130)",
         "launches": tlaunches["K2b"],
         "max_abs_err": berr["K2b"][0], "max_abs_err_bf16": berr["K2b"][1],
         "ms": k2b_ms, "plain_ms": k2b_plain, "timed_at": det_s0},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
