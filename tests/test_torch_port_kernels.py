"""The port's kernel ops against the JAX package's (CPU, plain versions).

``ms_deform_attn_torch`` (plain version of K1) against the JAX XLA path,
the numpy oracle and the Pallas kernel in interpret mode;
``window_attention_torch`` (plain version of K2) against the Pallas kernel
in interpret mode. Tolerance 1e-4 relative / 1e-5 absolute (float32; the
two stacks sum in other orders).
The kernel-vs-plain cases, forward and backward (K1, K1b, K3', K2, K2b, the
last two in both their tensor-core and CUDA-core instantiations), need a
card (marker ``cuda``) and skip without one. On the machine with the
card, which has no JAX, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py``;
``python3 chip_smoke.py`` runs the same comparisons at the flagship shapes.
"""

import types

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                 ms_deform_attn_torch)
from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                   window_attention_torch)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def ref():
    """The JAX reference functions. JAX is imported here, not at the top,
    so the ``cuda`` cases also run where the card is and JAX is not
    (``pytest --noconftest -m cuda`` on this file)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from rscotr_tpu.ops.ms_deform_attn import (
        _ms_deform_attn_xla, ms_deform_attn_reference_numpy)
    from rscotr_tpu.ops.pallas import ms_deform_attn_kernel
    from rscotr_tpu.ops.pallas.window_attention import \
        window_attention_fused
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, msda_xla=_ms_deform_attn_xla,
        msda_numpy=ms_deform_attn_reference_numpy,
        mk=ms_deform_attn_kernel, window_fused=window_attention_fused)


def msda_inputs(seed=0, B=2, H=4, D=16, P=4, Q=37,
                shapes=((12, 16), (6, 8), (3, 4)), span=(-0.2, 1.2)):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    Nv = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, Nv, H, D)).astype(np.float32)
    # locations straddle the border to exercise validity masking
    loc = rng.uniform(*span, size=(B, Q, H, L, P, 2)).astype(np.float32)
    aw = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    aw = aw / aw.sum(axis=(-2, -1), keepdims=True)
    return value, shapes, loc, aw


def wa_inputs(seed, B, nW, H, hd, masked, n=49):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, nW, H, n, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(H, n, n)).astype(np.float32)
    side = int(round(nW ** 0.5)) * 7
    mask = _shift_attn_mask(side, side, 7, 3) if masked else None
    return q, k, v, bias, mask


def torch_msda(value, shapes, loc, aw):
    return ms_deform_attn_torch(torch.from_numpy(value), shapes,
                                torch.from_numpy(loc),
                                torch.from_numpy(aw)).numpy()


@pytest.mark.parametrize("seed,D,shapes", [
    (0, 16, ((12, 16), (6, 8), (3, 4))),
    (1, 32, ((10, 10), (5, 5), (3, 3), (2, 2))),
])
def test_msda_plain_vs_xla(ref, seed, D, shapes):
    value, shapes, loc, aw = msda_inputs(seed, D=D, shapes=shapes)
    jnp = ref.jnp
    with ref.jax.default_matmul_precision("highest"):
        want = np.asarray(ref.msda_xla(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw)))
    np.testing.assert_allclose(torch_msda(value, shapes, loc, aw), want,
                               rtol=RTOL, atol=ATOL)


def test_msda_plain_vs_numpy_oracle(ref):
    value, shapes, loc, aw = msda_inputs(2, B=1, H=2, D=8, Q=9)
    want = ref.msda_numpy(value, shapes, loc, aw)
    np.testing.assert_allclose(torch_msda(value, shapes, loc, aw),
                               want.astype(np.float32), rtol=RTOL, atol=ATOL)


def test_msda_plain_vs_pallas_interpret(ref):
    value, shapes, loc, aw = msda_inputs(3)
    jnp, mk = ref.jnp, ref.mk
    mk._INTERPRET[0] = True
    try:
        want = np.asarray(mk.ms_deform_attn_pallas(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw)))
    finally:
        mk._INTERPRET[0] = False
    np.testing.assert_allclose(torch_msda(value, shapes, loc, aw), want,
                               rtol=RTOL, atol=ATOL)


def test_msda_dispatch_cpu_is_plain_and_counts_nothing():
    value, shapes, loc, aw = msda_inputs(4)
    before = ms_deform_attn.launches
    got = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(loc), torch.from_numpy(aw))
    np.testing.assert_array_equal(got.numpy(),
                                  torch_msda(value, shapes, loc, aw))
    assert ms_deform_attn.launches == before


def test_msda_plain_bf16_accumulates_in_f32():
    """bf16 value in, bf16 out, f32 sums inside: equals the f32 result on
    the same bf16-rounded inputs, rounded once."""
    value, shapes, loc, aw = msda_inputs(5)
    v16 = torch.from_numpy(value).bfloat16()
    got = ms_deform_attn_torch(v16, shapes, torch.from_numpy(loc),
                               torch.from_numpy(aw))
    want = ms_deform_attn_torch(v16.float(), shapes, torch.from_numpy(loc),
                                torch.from_numpy(aw)).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_plain_vs_pallas_interpret(ref, masked):
    q, k, v, bias, mask = wa_inputs(0, B=2, nW=4, H=3, hd=32, masked=masked)
    scale = 32 ** -0.5
    jnp = ref.jnp
    with ref.jax.default_matmul_precision("highest"):
        want = np.asarray(ref.window_fused(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bias),
            shift_mask=None if mask is None else jnp.asarray(mask),
            scale=scale, interpret=True))
    got = window_attention_torch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_wrappers_refuse_other_devices():
    value, shapes, loc, aw = msda_inputs(6)
    with pytest.raises(ValueError, match="no path for device"):
        ms_deform_attn(torch.from_numpy(value).to("meta"), shapes,
                       torch.from_numpy(loc).to("meta"),
                       torch.from_numpy(aw).to("meta"))
    q = torch.zeros(1, 1, 1, 49, 32, device="meta")
    with pytest.raises(ValueError, match="no path for device"):
        window_attention(q, q, q, torch.zeros(1, 49, 49, device="meta"))


# ---------------------------------------------------------------------------
# kernels against their plain versions on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


# float32: summation order only; bf16: one bf16 ulp of the output + 1e-3
KTOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}


def _assert_kernel_close(got, ref, dtype, slack=0):
    atol, rtol = KTOL[dtype]
    assert got.dtype == dtype
    assert ((got.float() - ref).abs() - rtol * ref.abs() - slack
            ).max().item() <= atol


# K2 / K2b in bf16 round P (and dS) to bf16 as operands of the tensor-core
# products, and so does the plain version; the f32 values differ in their
# last bits, so an entry on a rounding boundary differs by one bf16 ulp
# (2^-7 relative) between the two. That is rare, so at most P_FLIPS of the
# terms of one output are taken to be off at once: the bf16 comparisons
# allow, on top of KTOL / BTOL, P_FLIPS * 2^-7 * max_j (|operand_ij|
# |factor_jd|) per output.
P_ULP = 2.0 ** -7
P_FLIPS = 2


def _k2_ulp_slack(q, k, v, bias, mask, scale, d_out=None):
    from rscotr_tpu_torch.ops.window_attention import _probs
    if q.dtype != torch.bfloat16:
        return 0 if d_out is None else (0, 0, 0, 0)

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
            allow * largest_term(p, do.abs(), True), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 16, 32, 64])
def test_msda_kernel_vs_plain(cuda_device, dtype, D):
    value, shapes, loc, aw = msda_inputs(7, D=D)
    v = torch.from_numpy(value).to(cuda_device, dtype)
    w = torch.from_numpy(aw).to(cuda_device, dtype)
    loc_t = torch.from_numpy(loc).to(cuda_device)
    before = ms_deform_attn.launches
    got = ms_deform_attn(v, shapes, loc_t, w)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    _assert_kernel_close(got, ms_deform_attn_torch(v.float(), shapes, loc_t,
                                                   w.float()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked,hd", [(False, 32), (True, 32), (True, 64)])
def test_window_attention_kernel_vs_plain(cuda_device, dtype, masked, hd):
    q, k, v, bias, mask = wa_inputs(1, B=2, nW=4, H=3, hd=hd, masked=masked)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dtype) for t in (q, k, v))
    bias = torch.from_numpy(bias).to(cuda_device)
    mask = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = window_attention.launches
    got = window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    # the plain version at the kernel's dtype: for bf16 it rounds P to bf16
    # before P v, where the kernel does
    _assert_kernel_close(got, window_attention_torch(q, k, v, bias,
                                                     mask).float(), dtype,
                         _k2_ulp_slack(q, k, v, bias, mask, hd ** -0.5))


# backward kernels against the plain decomposition on the same CUDA
# tensors. The gradients are sums whose order differs (warp reductions,
# atomics in an order that changes from run to run), so the bound is
# scaled by the largest reference entry: |got - ref| <= atol * max|ref| +
# rtol * |ref|. bf16 outputs may differ by one bf16 ulp (2^-7 relative).
BTOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2.0 ** -7)}


def _assert_grad_close(got, ref, dtype, slack=0):
    atol, rtol = BTOL[dtype]
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    bound = atol * ref.abs().max().item() + rtol * ref.abs() + slack
    assert ((got - ref).abs() - bound).max().item() <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,seed,span", [
    (16, 11, (-0.2, 1.2)), (24, 12, (-0.2, 1.2)), (32, 13, (-0.2, 1.2)),
    (64, 11, (-0.2, 1.2)),
    (32, 14, (-0.1, 1.1)),   # starts that clamp at the map's edge
])
def test_msda_backward_kernels_vs_plain(cuda_device, dtype, D, seed, span):
    """One launch of K1b (its vector body, or the lane-per-channel one at
    D = 24) is the whole backward: no K3' launch."""
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn_bwd,
                                                     ms_deform_attn_bwd_torch)
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    value, shapes, loc, aw = msda_inputs(seed, D=D, span=span)
    v = torch.from_numpy(value).to(cuda_device, dtype).requires_grad_()
    w = torch.from_numpy(aw).to(cuda_device, dtype).requires_grad_()
    loc_t = torch.from_numpy(loc).to(cuda_device).requires_grad_()
    out = ms_deform_attn(v, shapes, loc_t, w)
    d_out = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(0)
                        ).to(dtype)
    k1b, k3 = ms_deform_attn_bwd.launches, scatter_add_mm.launches
    got = torch.autograd.grad(out, (v, loc_t, w), d_out)
    torch.cuda.synchronize()
    assert ms_deform_attn_bwd.launches == k1b + 1
    assert scatter_add_mm.launches == k3
    want = ms_deform_attn_bwd_torch(v.detach(), shapes, loc_t.detach(),
                                    w.detach(), d_out)
    for g, r, t in zip(got, want, (v, loc_t, w)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _assert_grad_close(g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,P,misaligned", [
    (16, 6, False), (32, 6, False), (64, 6, False),   # 18 points: two chunks
    (32, 4, True),                                    # value off by 1 element
])
def test_msda_backward_kernel_chunks_and_alignment(cuda_device, dtype, D, P,
                                                   misaligned):
    """K1b's vector body takes a task's points 16 at a time; a value tensor
    whose base is not 16-byte aligned takes the lane-per-channel body, and
    the vector body cannot be forced onto it."""
    from rscotr_tpu_torch.ops.ms_deform_attn import (
        BODY_LANE, BODY_VEC, _msda_bwd_cuda, ms_deform_attn_bwd,
        ms_deform_attn_bwd_torch, msda_bwd_body)
    value, shapes, loc, aw = msda_inputs(15, D=D, P=P)
    v = torch.from_numpy(value).to(cuda_device, dtype)
    if misaligned:
        buf = torch.empty(v.numel() + 1, device=cuda_device, dtype=dtype)
        buf[1:].copy_(v.reshape(-1))
        v = buf[1:].view(v.shape)
    w = torch.from_numpy(aw).to(cuda_device, dtype)
    loc_t = torch.from_numpy(loc).to(cuda_device)
    assert msda_bwd_body(D, [v.data_ptr()]) == (BODY_LANE if misaligned
                                                else BODY_VEC)
    d_out = torch.randn(v.shape[0], loc_t.shape[1], v.shape[2] * D,
                        device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1)
                        ).to(dtype)
    before = ms_deform_attn_bwd.launches
    if misaligned:
        with pytest.raises(ValueError, match="base addresses"):
            _msda_bwd_cuda(v, shapes, loc_t, w, d_out, body=BODY_VEC)
        assert ms_deform_attn_bwd.launches == before
    got = ms_deform_attn_bwd(v, shapes, loc_t, w, d_out)
    torch.cuda.synchronize()
    assert ms_deform_attn_bwd.launches == before + 1
    want = ms_deform_attn_bwd_torch(v, shapes, loc_t, w, d_out)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        _assert_grad_close(g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_vs_plain(cuda_device, dtype):
    from rscotr_tpu_torch.ops.scatter_mm import (scatter_add_mm,
                                                 scatter_add_mm_torch)
    rng = np.random.default_rng(10)
    G, K, C, rows = 6, 1000, 128, 97
    upd = torch.from_numpy(rng.normal(size=(G, K, C)).astype(np.float32))
    # repeated targets and out-of-range ones (dropped)
    idx = torch.from_numpy(rng.integers(-3, rows + 3, (G, K)).astype(
        np.int32))
    upd, idx = upd.to(cuda_device, dtype), idx.to(cuda_device)
    before = scatter_add_mm.launches
    got = scatter_add_mm(upd, idx, rows)
    torch.cuda.synchronize()
    assert scatter_add_mm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (G, rows, C)
    _assert_grad_close(got, scatter_add_mm_torch(upd, idx, rows),
                       torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked,hd", [(False, 32), (True, 32), (True, 64)])
def test_window_attention_backward_kernel_vs_plain(cuda_device, dtype,
                                                   masked, hd):
    from rscotr_tpu_torch.ops.window_attention import (
        window_attention_bwd, window_attention_bwd_torch)
    q, k, v, bias, mask = wa_inputs(2, B=2, nW=4, H=3, hd=hd, masked=masked)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dtype).requires_grad_()
               for t in (q, k, v))
    bias = torch.from_numpy(bias).to(cuda_device).requires_grad_()
    mask = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    out = window_attention(q, k, v, bias, mask)
    d_out = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1)
                        ).to(dtype)
    before = window_attention_bwd.launches
    got = torch.autograd.grad(out, (q, k, v, bias), d_out)
    torch.cuda.synchronize()
    assert window_attention_bwd.launches == before + 1
    args = (q.detach(), k.detach(), v.detach(), bias.detach(), mask,
            hd ** -0.5, d_out)
    want = window_attention_bwd_torch(*args)
    for g, r, t, s in zip(got, want, (q, k, v, bias), _k2_ulp_slack(*args)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _assert_grad_close(g, r, dtype, s)


# ---------------------------------------------------------------------------
# the tensor-core instantiations of K2 / K2b (bf16, n <= 64, hd 32 or 64)
# ---------------------------------------------------------------------------

def _fused_views(q, k, v):
    """The same values as the strided views of one (B * nW, n, 3, H, hd)
    projection that the Swin block passes (channel stride 1, no copy)."""
    B, nW, H, n, hd = q.shape
    qkv = torch.stack([t.reshape(B * nW, H, n, hd).transpose(1, 2)
                       for t in (q, k, v)], dim=2).contiguous()
    return tuple(t.unflatten(0, (B, nW))
                 for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))


def _wa_cuda(seed, dev, dtype, **kw):
    q, k, v, bias, mask = wa_inputs(seed, **kw)
    q, k, v = (torch.from_numpy(t).to(dev, dtype) for t in (q, k, v))
    return (q, k, v, torch.from_numpy(bias).to(dev),
            None if mask is None else torch.from_numpy(mask).to(dev))


def _plan(kind, q, k, v):
    from rscotr_tpu_torch.ops.window_attention import (_check_cuda_args,
                                                       tensor_core_plan)
    B, nW, H, n, hd = q.shape
    st = _check_cuda_args("test", q, k, v, torch.zeros(
        H, n, n, device=q.device), None)
    return tensor_core_plan(kind, q.dtype, q.shape, st,
                            [t.data_ptr() for t in (q, k, v)])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("via", ["bias", "mask"])
def test_window_attention_tc_fragment_layout_permutation(cuda_device, hd,
                                                         via):
    """A bias (per head) or mask (per window) that leaves one key per query
    makes P a permutation matrix: the output is v's rows permuted, exactly,
    which pins the (row, column) map of the score fragments, the padded
    columns and the P v fragment regrouping. Backward: dV is dO's rows
    permuted back, exactly, and dQ = dK = d_rel_bias = 0 (dS vanishes),
    which pins the transposed fragments of P^T dO."""
    from rscotr_tpu_torch.ops.window_attention import window_attention_bwd
    B, nW, H, n = 2, 4, 3, 49
    rng = np.random.default_rng(20)
    count = H if via == "bias" else nW
    perms = np.stack([rng.permutation(n) for _ in range(count)])
    table = np.full((count, n, n), -30000.0, np.float32)
    for c in range(count):
        table[c, np.arange(n), perms[c]] = 0.0
    table = torch.from_numpy(table).to(cuda_device)
    zeros = torch.zeros(H, n, n, device=cuda_device)
    bias, mask = (table, None) if via == "bias" else (zeros, table)
    q, k, v, d_out = (torch.from_numpy(rng.normal(size=(B, nW, H, n, hd))
                                       .astype(np.float32))
                      .to(cuda_device, torch.bfloat16) for _ in range(4))
    q, k = q * 0, k * 0
    assert _plan("fwd", q, k, v) > 0
    got = window_attention(q, k, v, bias, mask)
    idx = torch.from_numpy(perms).to(cuda_device)            # (count, n)
    idx = idx[None, None, :, :] if via == "bias" else idx[None, :, None, :]
    idx = idx.expand(B, nW, H, n)[..., None].expand(B, nW, H, n, hd)
    assert torch.equal(got, torch.gather(v, 3, idx))
    dq, dk, dv, db = window_attention_bwd(q, k, v, bias, mask, hd ** -0.5,
                                          d_out)
    torch.cuda.synchronize()
    assert torch.equal(dv, torch.zeros_like(dv).scatter_(3, idx, d_out))
    assert not dq.any() and not dk.any() and not db.any()


@pytest.mark.cuda
def test_window_attention_tc_fragment_layout_qk(cuda_device):
    """One-hot q and k rows make every score either 0 or 16 * 16 * scale =
    45: P is 1 or 1/2 on the keys whose hot channel matches the query's
    (2e-20 elsewhere), so the output is v's matching row or the mean of the
    two, which pins the q and k fragment layouts of S = q k^T."""
    B, nW, H, n, hd = 1, 2, 2, 49, 32
    rng = np.random.default_rng(21)
    qc, kc = np.arange(n) % hd, (5 * np.arange(n) + 3) % hd
    q = torch.zeros(B, nW, H, n, hd)
    k = torch.zeros(B, nW, H, n, hd)
    q[..., np.arange(n), qc] = 16.0
    k[..., np.arange(n), kc] = 16.0
    # multiples of 1/4 up to 8: the mean of two is a bf16 number, so no sum
    # sits on a rounding tie that the accumulation order could break
    v = torch.from_numpy(rng.integers(-32, 33, (B, nW, H, n, hd)).astype(
        np.float32) / 4).bfloat16()
    match = torch.from_numpy((qc[:, None] == kc[None, :]).astype(np.float32))
    assert match.sum(-1).min() >= 1
    want = ((match / match.sum(-1, keepdim=True)) @ v.float()).bfloat16()
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    got = window_attention(q, k, v, torch.zeros(H, n, n, device=cuda_device))
    # the other keys keep P = exp(-45) = 2e-20 each, visible only where the
    # exact result is 0
    assert (got.cpu().float() - want.float()).abs().max().item() <= 1e-15


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
def test_window_attention_tc_strided_qkv_views(cuda_device, hd):
    """q, k, v as views of the fused projection give the contiguous call's
    bits (d_rel_bias up to the order of its atomics)."""
    from rscotr_tpu_torch.ops.window_attention import window_attention_bwd
    q, k, v, bias, mask = _wa_cuda(3, cuda_device, torch.bfloat16, B=2, nW=9,
                                   H=3, hd=hd, masked=True)
    qs, ks, vs = _fused_views(q, k, v)
    assert not qs.is_contiguous() and _plan("bwd", qs, ks, vs) > 0
    d_out = torch.randn(q.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(2)
                        ).bfloat16()
    assert torch.equal(window_attention(qs, ks, vs, bias, mask),
                       window_attention(q, k, v, bias, mask))
    got = window_attention_bwd(qs, ks, vs, bias, mask, hd ** -0.5, d_out)
    want = window_attention_bwd(q, k, v, bias, mask, hd ** -0.5, d_out)
    for g, r in zip(got[:3], want[:3]):
        assert g.is_contiguous() and torch.equal(g, r)
    _assert_grad_close(got[3], want[3], torch.float32)


@pytest.mark.cuda
def test_window_attention_tc_ragged_window_runs(cuda_device):
    """5 x 361 tiles per head: the blocks walk runs of several windows and
    the last run of each head is shorter than the others."""
    from rscotr_tpu_torch.ops.window_attention import (
        window_attention_bwd, window_attention_bwd_torch)
    q, k, v, bias, mask = _wa_cuda(4, cuda_device, torch.bfloat16, B=5,
                                   nW=361, H=3, hd=32, masked=True)
    for kind in ("fwd", "bwd"):
        run = _plan(kind, q, k, v)
        assert run > 1 and (5 * 361) % run != 0
    _assert_kernel_close(window_attention(q, k, v, bias, mask),
                         window_attention_torch(q, k, v, bias, mask).float(),
                         torch.bfloat16,
                         _k2_ulp_slack(q, k, v, bias, mask, 32 ** -0.5))
    d_out = torch.randn(q.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(3)
                        ).bfloat16()
    args = (q, k, v, bias, mask, 32 ** -0.5, d_out)
    got = window_attention_bwd(*args)
    want = window_attention_bwd_torch(*args)
    for g, r, s in zip(got, want, _k2_ulp_slack(*args)):
        _assert_grad_close(g, r, torch.bfloat16, s)


@pytest.mark.cuda
@pytest.mark.parametrize("why,kw", [("hd=24", dict(hd=24)),
                                    ("odd base", dict(hd=32, offset=1))])
def test_window_attention_cuda_core_dispatch_in_bf16(cuda_device, why, kw):
    """bf16 inputs outside the tensor-core shapes (a head width that is not
    compiled, a base that is not 16-byte aligned) take the CUDA-core
    instantiation, count as launches and agree with the plain version."""
    from rscotr_tpu_torch.ops.window_attention import (
        window_attention_bwd, window_attention_bwd_torch)
    hd, off = kw["hd"], kw.get("offset", 0)
    q, k, v, bias, mask = _wa_cuda(5, cuda_device, torch.bfloat16, B=2, nW=4,
                                   H=3, hd=hd, masked=True)
    if off:
        # the same values at a base that is 2 bytes past a 16-byte boundary
        q, k, v = (torch.cat([t.new_zeros(off), t.flatten()])[off:].view(
            t.shape) for t in (q, k, v))
    assert _plan("fwd", q, k, v) == 0 and _plan("bwd", q, k, v) == 0
    k2, k2b = window_attention.launches, window_attention_bwd.launches
    got = window_attention(q, k, v, bias, mask)
    _assert_kernel_close(got, window_attention_torch(q, k, v, bias,
                                                     mask).float(),
                         torch.bfloat16,
                         _k2_ulp_slack(q, k, v, bias, mask, hd ** -0.5))
    d_out = torch.randn(q.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(4)
                        ).bfloat16()
    args = (q, k, v, bias, mask, hd ** -0.5, d_out)
    grads = window_attention_bwd(*args)
    torch.cuda.synchronize()
    assert window_attention.launches == k2 + 1
    assert window_attention_bwd.launches == k2b + 1
    for g, r, s in zip(grads, window_attention_bwd_torch(*args),
                       _k2_ulp_slack(*args)):
        _assert_grad_close(g, r, torch.bfloat16, s)
