"""The quad-gather MSDA backward: K5 (``ws_bwd``, ``csrc/msda_ws.cu``) and
K3' (``scatter_add_mm``, ``csrc/scatter_add.cu``), each with a vector body
beside its lane-per-channel body.

On the CPU: ``ws_bwd_body`` and ``scatter_add_body``, the functions that
pick the body of a CUDA launch, by width, KP and alignment; the plain
versions against the JAX package on the vector bodies' cases:
``ws_bwd_torch`` against the Pallas ``ws_bwd`` in interpret mode at head
widths D in {16, 32, 64} and KP in {1, 3, 12, 16, 20} (KP that fills no
whole reduce-scatter chunk, and more than one batch of a row), and
``scatter_add_mm_torch`` against the Pallas ``scatter_add_mm`` (interpret)
and ``scatter_add_xla`` with every index on one row and with indices below
0 and at or past num_rows, at C in {64, 96, 128, 256}. Tolerance: float32
sums in another order, 1e-5 absolute + 1e-5 relative (scatter: 1e-4 + 1e-5
relative, sums of up to 300 rows); K5's d_g is one product rounded once on
both sides, so it is equal. ``scatter_add_xla`` wraps a negative index as
numpy indexing does, where the Pallas kernel and the port drop it: it gets
those indices as num_rows, which it drops too.

On the card (marker ``cuda``; it has no JAX: run with ``python -m pytest
--noconftest -m cuda tests/test_torch_port_quad_bwd_vec.py``): both vector
bodies against their plain versions in float32 and bfloat16 at those
widths, KP and index cases (plus a permutation of the rows and C = 4); the
lane bodies forced, and taken on a base 8 bytes off alignment and at widths
the vector bodies do not take; the quad path's launches on the vector
bodies. K5's d_g must equal ``ws_bwd_torch``'s; d_wt and K3''s output are
float32 sums in another order (K3''s atomics in an order that changes from
run to run): within ``BTOL``, |got - ref| <= 1e-5 max|ref| + 1e-4 |ref|.
"""

import types

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE, BODY_VEC
from rscotr_tpu_torch.ops.msda_ws import (_ws_bwd_cuda, ws_bwd, ws_bwd_body,
                                          ws_bwd_torch)
from rscotr_tpu_torch.ops.scatter_mm import (SA_VEC_MAX_ELEMENTS,
                                             _scatter_add_cuda,
                                             scatter_add_body,
                                             scatter_add_mm,
                                             scatter_add_mm_torch)

HEAD_DIMS = (16, 32, 64)
KPS = (1, 3, 12, 16, 20)
WIDTHS = (64, 96, 128, 256)
BTOL = (1e-5, 1e-4)   # float32 outputs: atol * max|ref| + rtol * |ref|


def ws_inputs(D, KP, seed, G=2, Q=9):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(G, Q, KP, 4 * D)).astype(np.float32)
    wt = rng.uniform(size=(G, Q, 4 * KP)).astype(np.float32)
    d_out = rng.normal(size=(G, Q, D)).astype(np.float32)
    return g, wt, d_out


def scatter_inputs(C, case, seed, G=3, K=300, rows=40):
    """updates (G, K, C) float32 and idx (G, K) int32: ``case`` "one row"
    (every index on row 7), "out of range" (a third below 0, a third at or
    past ``rows``), "random" (uniform in range) or "permutation" (each of
    ``rows`` = K rows once)."""
    rng = np.random.default_rng(seed)
    upd = rng.normal(size=(G, K, C)).astype(np.float32)
    if case == "one row":
        idx = np.full((G, K), 7)
    elif case == "out of range":
        idx = rng.integers(-rows, 2 * rows, (G, K))
    elif case == "random":
        idx = rng.integers(0, rows, (G, K))
    else:
        assert rows == K
        idx = np.stack([rng.permutation(K) for _ in range(G)])
    return upd, idx.astype(np.int32), rows


# ---------------------------------------------------------------------------
# the body picks, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,KP,want", [
    (32, 16, BODY_VEC),     # the flagship det / seg encoders: 4 levels x 4
    (16, 16, BODY_VEC), (64, 16, BODY_VEC), (32, 1, BODY_VEC),
    (16, 3, BODY_VEC), (64, 64, BODY_VEC),
    (32, 65, BODY_LANE),    # more points than one row's weights hold
    (8, 16, BODY_LANE), (24, 16, BODY_LANE), (48, 4, BODY_LANE),
    (128, 4, BODY_LANE), (1, 1, BODY_LANE)])
def test_ws_bwd_body_by_head_dim_and_kp(D, KP, want):
    assert ws_bwd_body(D, KP) == want
    assert ws_bwd_body(D, KP, [0, 256, 4096]) == want


@pytest.mark.parametrize("ptrs", [[256, 8, 512], [4, 256, 512],
                                  [256, 512, 2]])
def test_ws_bwd_body_needs_aligned_bases(ptrs):
    # a base the 8- / 16-byte loads and stores cannot take
    assert ws_bwd_body(32, 16, ptrs) == BODY_LANE
    assert ws_bwd_body(32, 16, [p - p % 16 for p in ptrs]) == BODY_VEC


@pytest.mark.parametrize("C,want", [
    (128, BODY_VEC),        # the flagship's quad rows: 4 x head width 32
    (64, BODY_VEC), (96, BODY_VEC), (256, BODY_VEC), (4, BODY_VEC),
    (132, BODY_VEC), (130, BODY_LANE), (6, BODY_LANE), (1, BODY_LANE)])
def test_scatter_add_body_by_width(C, want):
    assert scatter_add_body(C) == want
    assert scatter_add_body(C, [0, 4096], 8 * 212704 * C) == want


def test_scatter_add_body_needs_aligned_bases_and_32_bit_offsets():
    assert scatter_add_body(128, [256, 8]) == BODY_LANE
    assert scatter_add_body(128, [4, 256]) == BODY_LANE
    assert scatter_add_body(128, [256, 512], SA_VEC_MAX_ELEMENTS) == \
        BODY_LANE
    assert scatter_add_body(128, [256, 512], SA_VEC_MAX_ELEMENTS - 1) == \
        BODY_VEC


def test_quad_bwd_dispatch_cpu_is_plain_and_counts_nothing():
    g, wt, d_out = (torch.from_numpy(a) for a in ws_inputs(32, 3, 1))
    upd, idx, rows = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                      for a in scatter_inputs(96, "out of range", 1))
    before = (ws_bwd.launches, ws_bwd.vec_launches, scatter_add_mm.launches,
              scatter_add_mm.vec_launches)
    for a, b in zip(ws_bwd(g, wt, d_out), ws_bwd_torch(g, wt, d_out)):
        assert torch.equal(a, b)
    assert torch.equal(scatter_add_mm(upd, idx, rows),
                       scatter_add_mm_torch(upd, idx, rows))
    assert (ws_bwd.launches, ws_bwd.vec_launches, scatter_add_mm.launches,
            scatter_add_mm.vec_launches) == before
    with pytest.raises(ValueError, match="no path for device"):
        scatter_add_mm(upd.to("meta"), idx.to("meta"), rows)


def test_scatter_add_launcher_checks_the_accumulator():
    """The private launcher that adds into a caller's accumulator refuses
    one of another width, group count or dtype before it loads anything."""
    upd = torch.zeros(2, 5, 8)
    idx = torch.zeros(2, 5, dtype=torch.int32)
    for out in (torch.zeros(2, 3, 4), torch.zeros(1, 3, 8),
                torch.zeros(2, 3, 8, dtype=torch.float64)):
        with pytest.raises(ValueError, match="out must be float32"):
            _scatter_add_cuda(upd, idx, out)


# ---------------------------------------------------------------------------
# the plain versions against JAX on the vector bodies' cases, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX reference functions, imported here and not at the top, so
    that the ``cuda`` cases run where the card is and JAX is not."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from rscotr_tpu.ops.pallas import msda_ws, scatter_mm
    return types.SimpleNamespace(jnp=jnp, ws=msda_ws, sc=scatter_mm)


@pytest.mark.parametrize("KP", KPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ws_bwd_plain_vs_pallas_interpret(ref, D, KP):
    g, wt, d_out = ws_inputs(D, KP, 10 + D + KP)
    jnp = ref.jnp
    jdg, jdw = ref.ws.ws_bwd(jnp.asarray(g), jnp.asarray(wt),
                             jnp.asarray(d_out), interpret=True)
    d_g, d_wt = ws_bwd_torch(*(torch.from_numpy(a) for a in (g, wt, d_out)))
    assert d_g.shape == g.shape and d_wt.shape == wt.shape
    np.testing.assert_array_equal(d_g.numpy(), np.asarray(jdg))
    np.testing.assert_allclose(d_wt.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["one row", "out of range"])
@pytest.mark.parametrize("C", WIDTHS)
def test_scatter_add_plain_vs_jax_index_cases(ref, C, case):
    upd, idx, rows = scatter_inputs(C, case, 20 + C)
    jnp = ref.jnp
    want_mm = np.asarray(ref.sc.scatter_add_mm(
        jnp.asarray(upd), jnp.asarray(idx), rows, acc_dtype=jnp.float32,
        interpret=True))
    want_xla = np.asarray(ref.sc.scatter_add_xla(
        jnp.asarray(upd), jnp.asarray(np.where(idx < 0, rows, idx)), rows))
    got = scatter_add_mm_torch(torch.from_numpy(upd), torch.from_numpy(idx),
                               rows).numpy()
    assert got.shape == (3, rows, C)
    if case == "out of range":
        assert (idx < 0).any() and (idx >= rows).any()
    else:
        assert not np.delete(got, 7, axis=1).any()
    np.testing.assert_allclose(got, want_mm, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the kernels' bodies against the plain versions on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def assert_btol(got, ref):
    atol, rtol = BTOL
    assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
    scale = ref.abs().max().item()
    assert ((got - ref).abs() - rtol * ref.abs()).max().item() <= \
        atol * scale


def misaligned(t, nbytes=8):
    """A copy of ``t`` whose base lies ``nbytes`` off 16-byte alignment."""
    pad = nbytes // t.element_size()
    buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)
    buf[pad:].copy_(t.reshape(-1))
    return buf[pad:].view(t.shape)


def run_ws_bwd(dev, D, KP, dtype, body, seed, force=None, skew=0):
    """K5 on the card against ``ws_bwd_torch`` on the same tensors; asserts
    which body the launch took. ``skew``: g's base that many bytes off
    16-byte alignment."""
    g, wt, d_out = (torch.from_numpy(a).to(dev)
                    for a in ws_inputs(D, KP, seed, Q=37))
    g, wt = g.to(dtype), wt.to(dtype)
    if skew:
        g = misaligned(g, skew)
    before = (ws_bwd.launches, ws_bwd.vec_launches)
    d_g, d_wt = (ws_bwd(g, wt, d_out) if force is None else
                 _ws_bwd_cuda(g, wt, d_out, body=force))
    torch.cuda.synchronize()
    assert (ws_bwd.launches, ws_bwd.vec_launches) == \
        (before[0] + 1, before[1] + (body == BODY_VEC))
    ref_dg, ref_dw = ws_bwd_torch(g, wt, d_out)
    assert d_g.dtype == dtype and torch.equal(d_g, ref_dg)
    assert_btol(d_wt, ref_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KP", KPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ws_bwd_vector_body_vs_plain(cuda_device, D, KP, dtype):
    run_ws_bwd(cuda_device, D, KP, dtype, BODY_VEC, 30 + D + KP)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ws_bwd_lane_body_forced(cuda_device, D, dtype):
    """``body=BODY_LANE`` where the vector body would be picked (the tools'
    way to time the lane body on the same tensors)."""
    run_ws_bwd(cuda_device, D, 16, dtype, BODY_LANE, 40 + D,
               force=BODY_LANE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ws_bwd_unaligned_g_takes_lane_body(cuda_device, dtype):
    """g 8 bytes off 16-byte alignment takes the lane body, and the vector
    body cannot be forced onto it."""
    run_ws_bwd(cuda_device, 32, 16, dtype, BODY_LANE, 50, skew=8)
    g, wt, d_out = (torch.from_numpy(a).to(cuda_device)
                    for a in ws_inputs(32, 16, 51))
    with pytest.raises(ValueError, match="base addresses"):
        _ws_bwd_cuda(misaligned(g.to(dtype)), wt.to(dtype), d_out,
                     body=BODY_VEC)


def run_scatter(dev, C, case, dtype, body, seed, force=None, skew=0,
                **kw):
    """K3' on the card against ``scatter_add_mm_torch`` on the same
    tensors; asserts which body the launch took."""
    upd, idx, rows = scatter_inputs(C, case, seed, **kw)
    u = torch.from_numpy(upd).to(dev, dtype)
    if skew:
        u = misaligned(u, skew)
    i = torch.from_numpy(idx).to(dev)
    before = (scatter_add_mm.launches, scatter_add_mm.vec_launches)
    if force is None:
        got = scatter_add_mm(u, i, rows)
    else:
        got = _scatter_add_cuda(u, i, torch.zeros(u.shape[0], rows, C,
                                                  device=dev), body=force)
    torch.cuda.synchronize()
    assert (scatter_add_mm.launches, scatter_add_mm.vec_launches) == \
        (before[0] + 1, before[1] + (body == BODY_VEC))
    assert_btol(got, scatter_add_mm_torch(u, i, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "one row", "out of range",
                                  "permutation"])
@pytest.mark.parametrize("C", (4,) + WIDTHS)
def test_scatter_add_vector_body_vs_plain(cuda_device, C, case, dtype):
    kw = dict(K=300, rows=300) if case == "permutation" else {}
    run_scatter(cuda_device, C, case, dtype, BODY_VEC, 60 + C, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "one row", "out of range"])
def test_scatter_add_scalar_body_forced(cuda_device, case, dtype):
    run_scatter(cuda_device, 128, case, dtype, BODY_LANE, 70,
                force=BODY_LANE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,skew", [(128, 8), (130, 0), (6, 0)])
def test_scatter_add_scalar_body_taken(cuda_device, C, skew, dtype):
    """Updates 8 bytes off 16-byte alignment, or a width that is not a
    multiple of 4, take the scalar body; the vector body cannot be forced
    onto them."""
    run_scatter(cuda_device, C, "out of range", dtype, BODY_LANE, 80 + C,
                skew=skew)
    u = torch.zeros(2, 9, C, dtype=dtype, device=cuda_device)
    i = torch.zeros(2, 9, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="base addresses"):
        _scatter_add_cuda(misaligned(u, skew) if skew else u, i,
                          torch.zeros(2, 4, C, device=cuda_device),
                          body=BODY_VEC)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
def test_quad_path_takes_the_vector_bodies(cuda_device, D, dtype):
    """``ms_deform_attn(impl="quad")`` forward + backward launches K5 and
    K3' once each, both on their vector bodies."""
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    rng = np.random.default_rng(90 + D)
    shapes = ((12, 16), (6, 8), (3, 4))
    Nv = sum(h * w for h, w in shapes)
    v = torch.from_numpy(rng.normal(size=(2, Nv, 4, D)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, size=(2, 37, 4, 3, 4, 2))
                           .astype(np.float32))
    aw = torch.from_numpy(rng.uniform(size=(2, 37, 4, 3, 4))
                          .astype(np.float32))
    leaves = [t.to(cuda_device).requires_grad_() for t in (v, loc, aw)]
    before = (ws_bwd.launches, ws_bwd.vec_launches, scatter_add_mm.launches,
              scatter_add_mm.vec_launches)
    out = ms_deform_attn(leaves[0].to(dtype), shapes, leaves[1],
                         leaves[2].to(dtype), impl="quad")
    grads = torch.autograd.grad(out, leaves, torch.ones_like(out))
    torch.cuda.synchronize()
    assert (ws_bwd.launches, ws_bwd.vec_launches, scatter_add_mm.launches,
            scatter_add_mm.vec_launches) == tuple(c + 1 for c in before)
    assert all(torch.isfinite(t).all() for t in grads)
