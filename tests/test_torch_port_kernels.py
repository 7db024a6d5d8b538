"""The port's kernel ops against the JAX package's (CPU, plain versions).

``ms_deform_attn_torch`` (plain version of K1) against the JAX XLA path,
the numpy oracle and the Pallas kernel in interpret mode;
``window_attention_torch`` (plain version of K2) against the Pallas kernel
in interpret mode. Tolerance 1e-4 relative / 1e-5 absolute (float32; the
two stacks sum in other orders).
The kernel-vs-plain cases, forward and backward (K1, K1b, K3', K2, K2b),
need a card (marker ``cuda``) and skip without one. On the machine with the
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
                shapes=((12, 16), (6, 8), (3, 4))):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    Nv = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, Nv, H, D)).astype(np.float32)
    # locations straddle the border to exercise validity masking
    loc = rng.uniform(-0.2, 1.2, size=(B, Q, H, L, P, 2)).astype(np.float32)
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


def _assert_kernel_close(got, ref, dtype):
    atol, rtol = KTOL[dtype]
    assert got.dtype == dtype
    assert ((got.float() - ref).abs() - rtol * ref.abs()).max().item() \
        <= atol


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
    _assert_kernel_close(got, window_attention_torch(
        q.float(), k.float(), v.float(), bias, mask), dtype)


# backward kernels against the plain decomposition on the same CUDA
# tensors. The gradients are sums whose order differs (warp reductions,
# atomics in an order that changes from run to run), so the bound is
# scaled by the largest reference entry: |got - ref| <= atol * max|ref| +
# rtol * |ref|. bf16 outputs may differ by one bf16 ulp (2^-7 relative).
BTOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2.0 ** -7)}


def _assert_grad_close(got, ref, dtype):
    atol, rtol = BTOL[dtype]
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    bound = atol * ref.abs().max().item() + rtol * ref.abs()
    assert ((got - ref).abs() - bound).max().item() <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,ref_dim", [(16, 2), (32, 4), (64, 2)])
def test_msda_backward_kernels_vs_plain(cuda_device, dtype, D, ref_dim):
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn_bwd_torch,
                                                     msda_bwd_rows)
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    value, shapes, loc, aw = msda_inputs(9 + ref_dim, D=D)
    v = torch.from_numpy(value).to(cuda_device, dtype).requires_grad_()
    w = torch.from_numpy(aw).to(cuda_device, dtype).requires_grad_()
    loc_t = torch.from_numpy(loc).to(cuda_device).requires_grad_()
    out = ms_deform_attn(v, shapes, loc_t, w)
    d_out = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(0)
                        ).to(dtype)
    k1b, k3 = msda_bwd_rows.launches, scatter_add_mm.launches
    got = torch.autograd.grad(out, (v, loc_t, w), d_out)
    torch.cuda.synchronize()
    assert msda_bwd_rows.launches == k1b + 1
    assert scatter_add_mm.launches == k3 + 1
    want = ms_deform_attn_bwd_torch(v.detach(), shapes, loc_t.detach(),
                                    w.detach(), d_out)
    for g, r, t in zip(got, want, (v, loc_t, w)):
        assert g.dtype == t.dtype and g.shape == t.shape
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
    want = window_attention_bwd_torch(q.detach(), k.detach(), v.detach(),
                                      bias.detach(), mask, hd ** -0.5, d_out)
    for g, r, t in zip(got, want, (q, k, v, bias)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _assert_grad_close(g, r, dtype)
