"""The bf16 arithmetic of the tensor-core window-attention kernels (K2,
K2b), their dispatch plan, and ``build_model``'s device default, on the CPU.

The kernels themselves run only on the card (``cuda`` cases of
tests/test_torch_port_kernels.py, ``chip_smoke.py``). Here the plain
versions, which round where the bf16 kernels round, are held against the JAX
package: the Pallas kernel in interpret mode (forward) and ``jax.vjp`` of the
Swin einsum path (backward), on inputs made with numpy from a seed.

Tolerances:
* forward, bf16: one bf16 ulp of the result (2^-7 relative) plus 1e-3. Both
  sides round P to bf16 before P v and the output once; the Pallas body
  scales q in bf16 before q k^T, the port scales the f32 product, which
  moves a score by at most 2^-9 relative per q element (inputs here have
  standard deviation 0.5, so scores stay within a few units).
* backward, bf16 against f32 ``jax.vjp`` on the same bf16-rounded inputs:
  P and dS are rounded to bf16 (at most half an ulp, u = 2^-8 relative, per
  element) as operands of dV, dQ, dK, and each output once more, so
  |dV - ref| <= u P^T |dO| + u |ref|, |dQ - ref| <= u scale |dS| |K|
  + u |ref|, |dK - ref| <= u scale |dS|^T |Q| + u |ref|, each plus 1e-5 of
  the largest entry for the second-order term and f32 summation order
  (rowsum(dO O) against rowsum(P dP)); d_rel_bias is a f32 sum of unrounded
  dS: 1e-5 of its largest entry plus 1e-4 relative.
* float32 inputs: bit-equal to the formulas the plain versions had before
  the rounding points were added.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rscotr_tpu.ops.pallas.window_attention import window_attention_fused
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
from rscotr_tpu_torch.ops import window_attention as wa
from rscotr_tpu_torch.utils.config import load_model_cfg

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs/multi/MTL_tiny_synthetic.py")
ULP = 2.0 ** -7   # one bf16 ulp, relative


def inputs(seed, shifted, B=2, nW=4, H=3, n=49, hd=32, std=0.5):
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (rng.normal(scale=std, size=(B, nW, H, n, hd)).astype(
        np.float32) for _ in range(4))
    bias = rng.normal(scale=0.5, size=(H, n, n)).astype(np.float32)
    side = int(round(nW ** 0.5)) * 7
    mask = _shift_attn_mask(side, side, 7, 3) if shifted else None
    return q, k, v, bias, mask, d_out


def bf16(x):
    return torch.from_numpy(x).bfloat16()


def as_jax_bf16(x):
    # the same bf16 values on both sides: round once, in torch
    return jnp.asarray(bf16(x).float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("shifted", [False, True])
def test_plain_bf16_forward_vs_pallas_interpret(shifted):
    q, k, v, bias, mask, _ = inputs(0, shifted)
    scale = 32 ** -0.5
    want = np.asarray(window_attention_fused(
        as_jax_bf16(q), as_jax_bf16(k), as_jax_bf16(v), jnp.asarray(bias),
        shift_mask=None if mask is None else jnp.asarray(mask), scale=scale,
        interpret=True).astype(jnp.float32))
    got = wa.window_attention_torch(
        bf16(q), bf16(k), bf16(v), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), scale)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err - ULP * np.abs(want)).max() <= 1e-3


def _swin_einsum_path(q, k, v, rel_bias, mask, scale):
    """rscotr_tpu/models/backbones/swin.py:130-140 on (B, nW, H, n, hd)."""
    B, nW, H, n, hd = q.shape
    q, k, v = (x.reshape(B * nW, H, n, hd) for x in (q, k, v))
    attn = jnp.einsum("bhqd,bhkd->bhqk", q * scale, k)
    attn = attn + rel_bias[None]
    if mask is not None:
        attn = attn.reshape(B, nW, H, n, n) + mask[None, :, None]
        attn = attn.reshape(B * nW, H, n, n)
    attn = jax.nn.softmax(attn, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", attn, v).reshape(B, nW, H, n, hd)


@pytest.mark.parametrize("shifted", [False, True])
def test_plain_bf16_backward_vs_jax_vjp(shifted):
    q, k, v, bias, mask, d_out = inputs(1, shifted, std=1.0)
    scale = 32 ** -0.5
    tq, tk, tv, tdo = (bf16(x) for x in (q, k, v, d_out))
    tb = torch.from_numpy(bias)
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    rounded = [jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)]
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a, b, c, d: _swin_einsum_path(
            a, b, c, d, jm, scale), *rounded, jnp.asarray(bias))
        want = [torch.from_numpy(np.asarray(g))
                for g in vjp(jnp.asarray(tdo.float().numpy()))]
    got = wa.window_attention_bwd_torch(tq, tk, tv, tb, tm, scale, tdo)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    # the operands whose rounding the bound counts, in f32
    p = wa._probs(tq, tk, tb, tm, scale)
    do = tdo.float()
    dp = torch.einsum("bwhqd,bwhkd->bwhqk", do, tv.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    half = 2.0 ** -8   # bf16 unit roundoff
    slack = [
        half * scale * torch.einsum("bwhqk,bwhkd->bwhqd", ds.abs(),
                                    tk.float().abs()),
        half * scale * torch.einsum("bwhqk,bwhqd->bwhkd", ds.abs(),
                                    tq.float().abs()),
        half * torch.einsum("bwhqk,bwhqd->bwhkd", p, do.abs())]
    for g, r, s in zip(got[:3], want[:3], slack):
        excess = (g.float() - r).abs() - s - half * r.abs()
        assert excess.max().item() <= 1e-5 * r.abs().max().item()
    db, rb = got[3], want[3]
    assert ((db - rb).abs() - 1e-4 * rb.abs()).max().item() <= \
        1e-5 * rb.abs().max().item()


@pytest.mark.parametrize("shifted", [False, True])
def test_plain_f32_unchanged_by_the_rounding_points(shifted):
    q, k, v, bias, mask, d_out = (None if x is None else torch.from_numpy(x)
                                  for x in inputs(2, shifted))
    scale = 32 ** -0.5
    p = wa._probs(q, k, bias, mask, scale)
    out = torch.einsum("bwhqk,bwhkd->bwhqd", p, v)
    assert torch.equal(wa.window_attention_torch(q, k, v, bias, mask, scale),
                       out)
    dv = torch.einsum("bwhqk,bwhqd->bwhkd", p, d_out)
    dp = torch.einsum("bwhqd,bwhkd->bwhqk", d_out, v)
    ds = p * (dp - (d_out * out).sum(-1, keepdim=True))
    dq = torch.einsum("bwhqk,bwhkd->bwhqd", ds, k) * scale
    dk = torch.einsum("bwhqk,bwhqd->bwhkd", ds, q) * scale
    got = wa.window_attention_bwd_torch(q, k, v, bias, mask, scale, d_out)
    for g, r in zip(got, (dq, dk, dv, ds.sum((0, 1)))):
        assert torch.equal(g, r)


def test_plain_bf16_rounds_p_before_pv():
    """The bf16 plain forward is the f32 one with P rounded to bf16 and the
    output rounded once (and differs from the unrounded one somewhere)."""
    q, k, v, bias, mask, _ = inputs(3, True)
    tq, tk, tv = bf16(q), bf16(k), bf16(v)
    tb, tm = torch.from_numpy(bias), torch.from_numpy(mask)
    p = wa._probs(tq, tk, tb, tm, 32 ** -0.5)
    want = torch.einsum("bwhqk,bwhkd->bwhqd", p.bfloat16().float(),
                        tv.float()).bfloat16()
    got = wa.window_attention_torch(tq, tk, tv, tb, tm, 32 ** -0.5)
    assert torch.equal(got, want)
    unrounded = torch.einsum("bwhqk,bwhkd->bwhqd", p, tv.float()).bfloat16()
    assert not torch.equal(got, unrounded)


# flagship stage shapes (chip_smoke.py K2_SHAPES) and the tiny config's
# stages at det 2x128^2 (embed 32, heads 1, 2, 4, 4: head widths 32, 32, 32,
# 64): (B, nW, H, hd) -> windows per block (forward, backward)
PLAN = {
    "det800.s0": ((1, 841, 3, 32), (5, 10)),
    "det800.s1": ((1, 225, 6, 32), (3, 6)),
    "det800.s2": ((1, 64, 12, 32), (2, 3)),
    "det800.s3": ((1, 16, 24, 32), (1, 2)),
    "cls224.s0": ((16, 64, 3, 32), (6, 12)),
    "cls224.s1": ((16, 16, 6, 32), (3, 6)),
    "cls224.s2": ((16, 4, 12, 32), (2, 3)),
    "cls224.s3": ((16, 1, 24, 32), (1, 2)),
    "seg512.s0": ((4, 361, 3, 32), (9, 17)),
    "seg512.s1": ((4, 100, 6, 32), (5, 10)),
    "seg512.s2": ((4, 25, 12, 32), (3, 5)),
    "seg512.s3": ((4, 9, 24, 32), (2, 4)),
    "ragged": ((5, 361, 3, 32), (11, 21)),   # 1,805 tiles: last run short
    # head width 64: 75 KB of shared memory a forward block, 3 to an SM
    "hd64": ((16, 64, 3, 64), (8, 12)),
    "tiny.s0": ((2, 25, 1, 32), (1, 1)),
    "tiny.s1": ((2, 9, 2, 32), (1, 1)),
    "tiny.s2": ((2, 4, 4, 32), (1, 1)),
    "tiny.s3": ((2, 1, 4, 64), (1, 1)),
}


def _fused_strides(H, hd, n=49):
    """(image * window, head, token) element strides of q, k, v as views of
    the (B * nW, n, 3, H, hd) projection (swin.py, WindowMSA.forward)."""
    return [n * 3 * H * hd, hd, 3 * H * hd] * 3


def window_runs(num_tiles: int, run: int):
    """The (first tile, count) of every block of one head, as the grid of
    the tensor-core kernels (ceil(num_tiles / run) blocks per head, block b
    starting at tile b * run) cuts ``num_tiles`` = B * nW tiles into runs."""
    return [(w0, min(run, num_tiles - w0)) for w0 in range(0, num_tiles, run)]


@pytest.mark.parametrize("name", sorted(PLAN))
def test_tensor_core_plan_table(name):
    (B, nW, H, hd), want = PLAN[name]
    shape = (B, nW, H, 49, hd)
    st = _fused_strides(H, hd)
    ptrs = [4096 + i * H * hd * 2 for i in range(3)]   # q, k, v in one row
    runs = tuple(wa.tensor_core_plan(kind, torch.bfloat16, shape, st, ptrs)
                 for kind in ("fwd", "bwd"))
    assert runs == want
    for run in runs:
        # every (image * window) tile of a head in exactly one block
        covered = [w for w0, cnt in window_runs(B * nW, run)
                   for w in range(w0, w0 + cnt)]
        assert covered == list(range(B * nW))
        assert all(1 <= cnt <= run for _, cnt in window_runs(B * nW, run))
    # float32 inputs take the CUDA-core kernel at every shape
    assert wa.tensor_core_plan("fwd", torch.float32, shape, st, ptrs) == 0


def test_tensor_core_plan_follows_the_device_and_the_mask():
    """Half the SMs: twice the windows per block. Without a mask a forward
    block of head width 64 needs 55 KB, so 4 fit an SM where 3 did."""
    st, ptrs = _fused_strides(3, 32), [4096, 4288, 4480]
    shape = (16, 64, 3, 49, 32)
    assert wa.tensor_core_plan("fwd", torch.bfloat16, shape, st, ptrs,
                               sm_count=66) == 12
    assert wa.tc_smem_bytes("fwd", 49, 32, True) == 50464
    assert wa.tc_smem_bytes("bwd", 49, 32, True) == 79136
    st, shape = _fused_strides(3, 64), (16, 64, 3, 49, 64)
    ptrs = [4096, 4480, 4864]
    assert wa.tensor_core_plan("fwd", torch.bfloat16, shape, st, ptrs,
                               masked=False) == 6
    assert wa.tensor_core_plan("fwd", torch.bfloat16, shape, st, ptrs) == 8


@pytest.mark.parametrize("why,kw", [
    # K2's long-window body takes n = 65..144 at head width 32 (forward)
    ("n above 64", dict(n=81, kinds=("bwd",))),
    ("head width not compiled", dict(hd=24)),
    ("token stride not a multiple of 16 bytes", dict(stride=(4704, 32, 100))),
    ("base not 16-byte aligned", dict(ptr=4098)),
    ("too many heads for the grid", dict(H=70000)),
    ("n above 64, head width 64", dict(n=81, hd=64)),
    ("n above 144", dict(n=169)),
])
def test_tensor_core_plan_falls_to_cuda_cores(why, kw):
    H, n, hd = kw.get("H", 3), kw.get("n", 49), kw.get("hd", 32)
    st = list(kw.get("stride", (n * H * hd, n * hd, hd))) * 3
    ptrs = [4096, 8192, kw.get("ptr", 12288)]
    for kind in kw.get("kinds", ("fwd", "bwd")):
        assert wa.tensor_core_plan(kind, torch.bfloat16, (2, 4, H, n, hd),
                                   st, ptrs) == 0, why


def test_build_model_defaults_to_the_card():
    cfg = load_model_cfg(TINY)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(cfg, tasks=("cls",), device="cuda")


def test_build_model_on_the_cpu_when_asked():
    cfg = load_model_cfg(TINY)
    model = build_model(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    again = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
