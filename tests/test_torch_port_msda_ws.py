"""K4 / K5 (the corner-weighted sum), the quad-gather MSDA path and K6 (the
weighted-gather probe) of the port against the JAX package (CPU, plain
versions).

* ``ws_fwd_torch`` / ``ws_bwd_torch`` against the Pallas ``ws_fwd`` /
  ``ws_bwd`` in interpret mode, at the JAX test's shapes (D=32 and D=16) and
  one whose Q leaves a partial block, float32 and bfloat16 g.
* ``corner_weighted_sum`` against ``_corner_weighted_sum`` + ``jax.vjp``.
* ``ms_deform_attn(impl="quad")`` forward and gradients (value, loc, attn)
  against ``_ms_deform_attn_xla(bwd_impl="xla")`` + ``jax.vjp``, and
  against ``impl="kernel"`` in torch.
* ``weighted_gather_mm_torch`` against the JAX tool's
  ``weighted_gather_mm(interpret=True)`` (loaded by file path), both
  accumulation dtypes, with indices out of [0, Nv); the probe's parity
  check and ``production_level_slice`` against the JAX tool's.

Tolerances: float32 sums taken in another order, 1e-4 relative + 1e-5
absolute (gradients: 1e-5 of the largest reference entry); bf16 g is held
to the same bound, since both sides sum the same bf16-rounded values in
float32; K6's plain version equals the TPU kernel's single product (1e-6
relative). The kernel-vs-plain cases need a card (marker ``cuda``) and skip
without one; on the machine with the card, which has no JAX, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_port_msda_ws.py``.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from rscotr_tpu_torch.ops.msda_ws import (corner_weighted_sum, ws_bwd,
                                          ws_bwd_torch, ws_fwd, ws_fwd_torch)
from rscotr_tpu_torch.tools import probe_msda_weighted_gather_mm as probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
WS_SHAPES = [(3, 70, 16, 128), (2, 333, 8, 64), (1, 300, 16, 128)]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference functions, imported here so that the ``cuda``
    cases also run where JAX is not."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from rscotr_tpu.ops.pallas import msda_ws
    jmsda = importlib.import_module("rscotr_tpu.ops.ms_deform_attn")
    spec = importlib.util.spec_from_file_location(
        "jax_probe_msda_weighted_gather_mm",
        os.path.join(ROOT, "tools/probe_msda_weighted_gather_mm.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return types.SimpleNamespace(jax=jax, jnp=jnp, msda=jmsda,
                                 ws=msda_ws, tool=tool)


def ws_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    G, Q, KP, C4 = shape
    g = rng.normal(size=shape).astype(np.float32)
    wt = rng.uniform(size=(G, Q, 4 * KP)).astype(np.float32)
    d_out = rng.normal(size=(G, Q, C4 // 4)).astype(np.float32)
    return g, wt, d_out


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
    d_out = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    return value, shapes, loc, aw, d_out


def assert_grad_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WS_SHAPES)
def test_ws_plain_vs_pallas_interpret(ref, shape, dtype):
    g, wt, d_out = ws_inputs(shape)
    gt = torch.from_numpy(g).to(dtype)
    jg = ref.jnp.asarray(gt.float().numpy()).astype(
        ref.jnp.bfloat16 if dtype == torch.bfloat16 else ref.jnp.float32)
    want = np.asarray(ref.ws.ws_fwd(jg, ref.jnp.asarray(wt), interpret=True))
    got = ws_fwd_torch(gt, torch.from_numpy(wt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    jdg, jdw = ref.ws.ws_bwd(jg, ref.jnp.asarray(wt), ref.jnp.asarray(d_out),
                             interpret=True)
    d_g, d_wt = ws_bwd_torch(gt, torch.from_numpy(wt),
                             torch.from_numpy(d_out))
    assert d_g.dtype == dtype and d_wt.dtype == torch.float32
    # d_g is one f32 product rounded to g's dtype on both sides: equal
    np.testing.assert_array_equal(d_g.float().numpy(),
                                  np.asarray(jdg, np.float32))
    np.testing.assert_allclose(d_wt.numpy(), np.asarray(jdw), rtol=RTOL,
                               atol=ATOL)


def test_dispatch_cpu_is_plain_and_counts_nothing():
    g, wt, d_out = (torch.from_numpy(a) for a in ws_inputs(WS_SHAPES[0], 1))
    before = (ws_fwd.launches, ws_bwd.launches)
    assert torch.equal(ws_fwd(g, wt), ws_fwd_torch(g, wt))
    for a, b in zip(ws_bwd(g, wt, d_out), ws_bwd_torch(g, wt, d_out)):
        assert torch.equal(a, b)
    assert (ws_fwd.launches, ws_bwd.launches) == before
    with pytest.raises(ValueError, match="no path for device"):
        ws_fwd(g.to("meta"), wt.to("meta"))
    # K6 likewise
    table = g.reshape(3, -1, 128)
    idx = torch.arange(-1, 9, dtype=torch.int32).repeat(3, 1)
    w = wt[:, :10, 0].contiguous()
    before = probe.weighted_gather_mm.launches
    assert torch.equal(probe.weighted_gather_mm(table, idx, w),
                       probe.weighted_gather_mm_torch(table, idx, w))
    assert probe.weighted_gather_mm.launches == before
    with pytest.raises(ValueError, match="no path for device"):
        probe.weighted_gather_mm(table.to("meta"), idx.to("meta"),
                                 w.to("meta"))


@pytest.mark.parametrize("D", [16, 32])
def test_corner_weighted_sum_vs_jax(ref, D):
    rng = np.random.default_rng(2)
    B, H, Q, KP = 2, 3, 29, 8
    g = rng.normal(size=(B, H, Q, KP, 4 * D)).astype(np.float32)
    wt = rng.uniform(size=(B, H, Q, KP, 4)).astype(np.float32)
    d_out = rng.normal(size=(B, H, Q, D)).astype(np.float32)
    jnp = ref.jnp
    want, vjp = ref.jax.vjp(ref.msda._corner_weighted_sum, jnp.asarray(g),
                            jnp.asarray(wt))
    jdg, jdw = vjp(jnp.asarray(d_out))
    gt = torch.from_numpy(g).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    got = corner_weighted_sum(gt, wtt)
    assert got.dtype == torch.float32 and got.shape == (B, H, Q, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    dg, dw = torch.autograd.grad(got, (gt, wtt), torch.from_numpy(d_out))
    assert dg.dtype == gt.dtype and dw.dtype == wtt.dtype
    assert_grad_close(dg.numpy(), jdg)
    assert_grad_close(dw.numpy(), jdw)


def _torch_grads(value, shapes, loc, aw, d_out, impl):
    v, lt, at = (torch.from_numpy(a).requires_grad_()
                 for a in (value, loc, aw))
    out = ms_deform_attn(v, shapes, lt, at, impl=impl)
    grads = torch.autograd.grad(out, (v, lt, at), torch.from_numpy(d_out))
    return out.detach(), grads


@pytest.mark.parametrize("seed,D,shapes", [
    (0, 16, ((12, 16), (6, 8), (3, 4))),
    (1, 32, ((10, 10), (5, 5), (3, 3), (2, 2))),
])
def test_quad_impl_vs_jax_xla(ref, seed, D, shapes):
    value, shapes, loc, aw, d_out = msda_inputs(seed, D=D, shapes=shapes)
    jnp = ref.jnp
    with ref.jax.default_matmul_precision("highest"):
        want, vjp = ref.jax.vjp(
            lambda v, lc, a: ref.msda._ms_deform_attn_xla(v, shapes, lc, a,
                                                          "xla"),
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))
        jgrads = vjp(jnp.asarray(d_out))
    out, grads = _torch_grads(value, shapes, loc, aw, d_out, "quad")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for g, jg in zip(grads, jgrads):
        assert_grad_close(g.numpy(), jg)


def test_quad_impl_vs_kernel_impl():
    value, shapes, loc, aw, d_out = msda_inputs(3)
    out_q, grads_q = _torch_grads(value, shapes, loc, aw, d_out, "quad")
    out_k, grads_k = _torch_grads(value, shapes, loc, aw, d_out, "kernel")
    np.testing.assert_allclose(out_q.numpy(), out_k.numpy(), rtol=RTOL,
                               atol=ATOL)
    for gq, gk in zip(grads_q, grads_k):
        assert_grad_close(gq.numpy(), gk.numpy())
    with pytest.raises(ValueError, match="unknown impl"):
        ms_deform_attn(torch.from_numpy(value), shapes,
                       torch.from_numpy(loc), torch.from_numpy(aw),
                       impl="xla")


@pytest.mark.parametrize("acc", ["bfloat16", "float32"])
def test_weighted_gather_plain_vs_jax_interpret(ref, acc):
    rng = np.random.default_rng(4)
    G, Nv, C, K = 3, 300, 128, 700
    table = rng.normal(size=(G, Nv, C)).astype(np.float32)
    # indices out of [0, Nv) on both sides give zero rows
    idx = rng.integers(-5, Nv + 10, (G, K)).astype(np.int32)
    w = rng.uniform(0, 1, (G, K)).astype(np.float32)
    jnp = ref.jnp
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    want = np.asarray(ref.tool.weighted_gather_mm(
        jt, jnp.asarray(idx), jnp.asarray(w), acc_dtype=getattr(jnp, acc),
        interpret=True))
    got = probe.weighted_gather_mm_torch(
        torch.from_numpy(table).bfloat16(), torch.from_numpy(idx),
        torch.from_numpy(w), acc_dtype=getattr(torch, acc))
    assert got.dtype == torch.float32 and got.shape == (G, K, C)
    oor = (idx < 0) | (idx >= Nv)
    assert oor.any() and not got.numpy()[oor].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_production_level_slice_vs_jax(ref):
    rng = np.random.default_rng(5)
    G, Nv, C, K = 2, 169, 128, 500
    table = rng.normal(size=(G, Nv, C)).astype(np.float32)
    idx = rng.integers(0, Nv, (G, K)).astype(np.int32)
    w = rng.uniform(0, 1, (G, K)).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.tool.production_level_slice(
        jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(w).astype(jnp.bfloat16)))
    got = probe.production_level_slice(
        torch.from_numpy(table).bfloat16(), torch.from_numpy(idx),
        torch.from_numpy(w).bfloat16())
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# kernels against their plain versions on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


# K4 / d_wt: f32 sums in another order (1e-5 + 1e-5 * |ref|); d_g: one
# product rounded to g's dtype on both sides (equal)
KTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WS_SHAPES + [(2, 50, 4, 512),
                                               (1, 41, 3, 32)])
def test_ws_kernels_vs_plain(cuda_device, shape, dtype):
    g, wt, d_out = (torch.from_numpy(a).to(cuda_device)
                    for a in ws_inputs(shape, 6))
    # the quad path hands K4 / K5 its slot weights in g's dtype
    g, wt = g.to(dtype), wt.to(dtype)
    before = (ws_fwd.launches, ws_bwd.launches)
    out = ws_fwd(g, wt)
    d_g, d_wt = ws_bwd(g, wt, d_out)
    torch.cuda.synchronize()
    assert (ws_fwd.launches, ws_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref_out = ws_fwd_torch(g, wt)
    ref_dg, ref_dw = ws_bwd_torch(g, wt, d_out)
    assert ((out - ref_out).abs() - KTOL * ref_out.abs()).max() <= KTOL
    assert torch.equal(d_g, ref_dg)
    assert ((d_wt - ref_dw).abs() - KTOL * ref_dw.abs()).max() <= KTOL
    with pytest.raises(TypeError, match="g's dtype"):
        ws_fwd(g, wt.to(torch.float32 if dtype == torch.bfloat16
                        else torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quad_impl_on_card_vs_kernel_impl(cuda_device, dtype):
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    value, shapes, loc, aw, d_out = msda_inputs(7, D=32)
    v, lt, at = (torch.from_numpy(a).to(cuda_device).requires_grad_()
                 for a in (value, loc, aw))
    vd = v.to(dtype)
    ad = at.to(dtype)
    dd = torch.from_numpy(d_out).to(cuda_device, dtype)
    counts = (ws_fwd.launches, ws_bwd.launches, scatter_add_mm.launches)
    out_q = ms_deform_attn(vd, shapes, lt, ad, impl="quad")
    gq = torch.autograd.grad(out_q, (v, lt, at), dd)
    torch.cuda.synchronize()
    assert (ws_fwd.launches, ws_bwd.launches, scatter_add_mm.launches) == \
        tuple(c + 1 for c in counts)
    out_k = ms_deform_attn(vd, shapes, lt, ad)
    gk = torch.autograd.grad(out_k, (v, lt, at), dd)
    # bf16: the two paths round the value gradient at other points and
    # multiply in other dtypes; one bf16 ulp of the output / largest grad
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert ((out_q.float() - out_k.float()).abs()).max() <= \
        tol * max(1.0, out_k.float().abs().max().item())
    for a, b in zip(gq, gk):
        assert (a - b).abs().max() <= tol * max(1.0, b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("acc", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tdtype", [torch.bfloat16, torch.float32])
def test_weighted_gather_kernel_vs_plain(cuda_device, acc, tdtype):
    rng = np.random.default_rng(8)
    G, Nv, C, K = 4, 625, 128, 3000
    table = torch.from_numpy(rng.normal(size=(G, Nv, C)).astype(
        np.float32)).to(cuda_device, tdtype)
    idx = torch.from_numpy(rng.integers(-5, Nv + 10, (G, K)).astype(
        np.int32)).to(cuda_device)
    w = torch.from_numpy(rng.uniform(0, 1, (G, K)).astype(np.float32)).to(
        cuda_device)
    before = probe.weighted_gather_mm.launches
    got = probe.weighted_gather_mm(table, idx, w, acc_dtype=acc)
    torch.cuda.synchronize()
    assert probe.weighted_gather_mm.launches == before + 1
    want = probe.weighted_gather_mm_torch(table, idx, w, acc_dtype=acc)
    assert ((got - want).abs() - 1e-6 * want.abs()).max() <= 0
