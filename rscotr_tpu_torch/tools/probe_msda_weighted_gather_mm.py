"""Probe: weight-folded row gather (kernel K6) for the MSDA forward.

Port of tools/probe_msda_weighted_gather_mm.py. The quad-gather MSDA
forward gathers one quad-table row per sampling point and then multiplies
it by its slot weight (``production_level_slice``: gather, then the
multiply in float32). The probe tests folding the weight into the gather:

    out[g, k, :] = acc(w[g, k]) * acc(table[g, idx[g, k], :])   (float32)

``acc`` rounds to the accumulation dtype (bfloat16 by default, as the TPU
kernel builds its one-hot block from w in ``acc_dtype``); an index outside
[0, Nv) gives a zero row. ``weighted_gather_mm`` launches the hand-written
kernel ``csrc/weighted_gather.cu`` for CUDA tensors and runs the plain
version ``weighted_gather_mm_torch`` for CPU tensors; any other device
raises.

Two parts, as the JAX tool's: a parity check (G=4, Nv=300, C=128, K=640)
of the kernel against ``production_level_slice`` (max abs error < 0.05:
w is rounded to bf16) and against its plain version (the same single
product: equal to 1e-6 relative); then per-level timings at the det-encoder
shapes (G=8, K=13,344 x 4 lookups, 128-wide quad rows, levels of 10,000,
2,500, 625 and 169 rows, bf16), K6 against ``production_level_slice``,
CUDA events around ``--chain`` back-to-back calls, ``--iters`` times.

    python -m rscotr_tpu_torch.tools.probe_msda_weighted_gather_mm \\
        [--iters 30] [--chain 8] [--check-only] [--json-out FILE]

It runs on the CUDA device and exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rscotr_tpu_torch.ops import kernel_lib

LEVELS = ((100, 100), (50, 50), (25, 25), (13, 13))
PARITY_TOL = 0.05          # vs production_level_slice: w rounded to bf16
PLAIN_RTOL = 1e-6          # vs the plain version: the same one product


def weighted_gather_mm(table: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor,
                       acc_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """table (G, Nv, C), idx (G, K) int32, w (G, K) -> (G, K, C) float32.
    Kernel K6 on CUDA (``launches`` counts it)."""
    if table.device.type == "cpu":
        return weighted_gather_mm_torch(table, idx, w, acc_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"weighted_gather_mm: no path for device "
                         f"{table.device}")
    G, Nv, C = table.shape
    K = idx.shape[1]
    if tuple(idx.shape) != (G, K) or idx.dtype != torch.int32 or \
            tuple(w.shape) != (G, K):
        raise ValueError(f"weighted_gather_mm: idx must be int32 and w "
                         f"{(G, K)}; got {idx.dtype} {tuple(idx.shape)}, "
                         f"{tuple(w.shape)}")
    for name, t in (("table", table), ("idx", idx), ("w", w)):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"weighted_gather_mm: {name} must be "
                             f"contiguous on {table.device}")
    out = torch.empty((G, K, C), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    acc = torch.empty((), dtype=acc_dtype)
    lib = kernel_lib.load()
    with torch.cuda.device(table.device):
        err = lib.weighted_gather(
            table.data_ptr(), kernel_lib.dtype_code(table, "table"),
            idx.data_ptr(), w.data_ptr(), kernel_lib.dtype_code(w, "w"),
            kernel_lib.dtype_code(acc, "acc_dtype"), out.data_ptr(), G, K,
            Nv, C, kernel_lib.stream_ptr(table.device))
    kernel_lib.check(err, "weighted_gather")
    weighted_gather_mm.launches += 1
    return out


weighted_gather_mm.launches = 0


def weighted_gather_mm_torch(table: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor,
                             acc_dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """Plain PyTorch version of K6."""
    G, Nv, C = table.shape
    idx = idx.long()
    valid = (idx >= 0) & (idx < Nv)
    safe = torch.where(valid, idx, 0)[..., None].expand(-1, -1, C)
    rows = torch.gather(table, 1, safe).to(acc_dtype).float()
    wa = w.float().to(acc_dtype).float() * valid
    return rows * wa[..., None]


def production_level_slice(table: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """The production formulation restricted to one level: the row gather
    (indices in range), then the weight multiply in float32."""
    G, Nv, C = table.shape
    base = (torch.arange(G, device=table.device) * Nv)[:, None]
    g = table.reshape(G * Nv, C).index_select(
        0, (idx.long() + base).reshape(-1)).reshape(G, -1, C)
    return g.float() * w[:, :, None].float()


def parity(device, seed: int = 0) -> dict:
    """K6 against ``production_level_slice`` and its plain version on the
    JAX tool's small case; raises if either bound fails."""
    rng = np.random.default_rng(seed)
    G, Nv, C, K = 4, 300, 128, 640
    table = torch.tensor(rng.normal(size=(G, Nv, C)), dtype=torch.bfloat16,
                         device=device)
    idx = torch.tensor(rng.integers(0, Nv, (G, K)), dtype=torch.int32,
                       device=device)
    w = torch.tensor(rng.uniform(0, 1, (G, K)), dtype=torch.float32,
                     device=device)
    got = weighted_gather_mm(table, idx, w)
    prod = production_level_slice(table, idx, w)
    plain = weighted_gather_mm_torch(table, idx, w)
    err = (got - prod).abs().max().item()
    err_plain = (got - plain).abs().max().item()
    bad_plain = ((got - plain).abs() - PLAIN_RTOL * plain.abs()).max().item()
    print(f"parity max abs err (bf16 inputs): {err:.5f} vs "
          f"production_level_slice (tol {PARITY_TOL}); {err_plain:.3e} vs "
          f"the plain version (tol {PLAIN_RTOL:g}*|ref|)", flush=True)
    if not err < PARITY_TOL or bad_plain > 0:
        raise AssertionError(f"weighted_gather_mm parity failed: {err}, "
                             f"{err_plain}")
    return {"max_abs_err": err, "max_abs_err_plain": err_plain}


def time_levels(device, iters: int = 30, chain: int = 8,
                seed: int = 0) -> dict:
    """Per-level ms per call of K6 and of ``production_level_slice`` at the
    det-encoder shapes (CUDA events around ``chain`` back-to-back calls,
    ``iters`` times, after one warm-up chain). Each level also reports what
    one K6 call moves: ``bytes`` (table, idx, w read once, the output
    written once) and ``out_elements`` (one multiply each)."""
    rng = np.random.default_rng(seed)
    Gf, Q, P, Cq = 8, 13344, 4, 128
    Kf = Q * P
    results = {}
    for h, wd in LEVELS:
        nv = h * wd
        table = torch.tensor(rng.normal(size=(Gf, nv, Cq)),
                             dtype=torch.bfloat16, device=device)
        idx = torch.tensor(rng.integers(0, nv, (Gf, Kf)), dtype=torch.int32,
                           device=device)
        wt = torch.tensor(rng.uniform(0, 1, (Gf, Kf)), dtype=torch.bfloat16,
                          device=device)
        timed = {}
        for name, fn in (("weighted_mm", weighted_gather_mm),
                         ("prod_gather", production_level_slice)):
            for _ in range(chain):
                fn(table, idx, wt)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters * chain):
                out = fn(table, idx, wt)
            end.record()
            torch.cuda.synchronize()
            timed[name] = start.elapsed_time(end) / (iters * chain)
            print(f"nv={nv:6d} {name:12s} {timed[name]:7.4f} ms/layer-level "
                  f"(sum={out.sum().item():.1f})", flush=True)
            if fn is weighted_gather_mm:
                timed["bytes"] = sum(t.numel() * t.element_size()
                                     for t in (table, idx, wt, out))
                timed["out_elements"] = out.numel()
        results[nv] = timed
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--chain", type=int, default=8,
                    help="calls launched back to back per timed iteration")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    parity(device)
    if args.check_only:
        print("parity OK")
        return 0
    results = time_levels(device, args.iters, args.chain)
    print(json.dumps(results))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
