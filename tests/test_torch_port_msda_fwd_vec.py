"""K1, the MSDA forward kernel (``csrc/msda_fwd.cu``), and its two bodies.

On the CPU: ``msda_fwd_body``, the function that picks the body of a CUDA
launch, and the plain version ``ms_deform_attn_torch`` against the JAX
package's XLA path and its Pallas kernel (interpret mode) on the inputs the
kernel cases below use: locations exactly on cell edges and the map's
border, point counts that are not a multiple of a round (P in {1, 3, 8}),
one and five levels, one query. Tolerance 1e-4 relative / 1e-5 absolute
(float32; the stacks sum in other orders). At a location on a cell edge
the stacks may floor to neighbouring cells; bilinear sampling with zero
padding is continuous there, so the outputs still agree.

On the card (marker ``cuda``; it has no JAX: run with ``python -m pytest
--noconftest -m cuda tests/test_torch_port_msda_fwd_vec.py``) the vector
body (head widths 16, 32, 64) against ``ms_deform_attn_torch``
over every value / weight dtype pair, location spans [0, 1] and
[-0.2, 1.2] and the edge draw, points per level P in {1, 3, 4, 8}, levels
L in {1, 4, 5} and queries Q in {1, 600, 800}; the lane-per-channel body at
head widths 8, 24 and 128, on a value tensor 8 bytes off alignment, and
forced at a head width the vector body takes. Tolerance ``KTOL``: float32
summation order only; a bf16 output one bf16 ulp (2^-7 relative) + 1e-3.
"""

import types

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.ops.ms_deform_attn import (BODY_LANE, BODY_VEC,
                                                 _ms_deform_attn_cuda,
                                                 ms_deform_attn,
                                                 ms_deform_attn_torch,
                                                 msda_fwd_body)

RTOL, ATOL = 1e-4, 1e-5
KTOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
SHAPES = {1: ((9, 11),), 4: ((12, 16), (6, 8), (3, 4), (2, 2)),
          5: ((12, 16), (6, 8), (3, 4), (2, 2), (1, 1))}


def locations(rng, shape, levels, span):
    """(B, Q, H, L, P, 2) float32 in (x, y) order. ``span`` (lo, hi):
    uniform; ``"edges"``: per level, loc = k / (2 W) (and k / (2 H)) for
    integers k in [-2, 2 W + 2], so that x = loc * W - 0.5 lies on a cell
    edge (an integer: floor jumps there) or halfway between two, including
    the map's border (loc 0 and 1) and one to two half cells past it."""
    if span != "edges":
        return rng.uniform(*span, size=shape).astype(np.float32)
    loc = np.empty(shape, np.float32)
    for lvl, (h, w) in enumerate(levels):
        for axis, n in ((0, w), (1, h)):
            k = rng.integers(-2, 2 * n + 3, size=shape[:3] + shape[4:5])
            loc[:, :, :, lvl, :, axis] = k / np.float32(2 * n)
    return loc


def msda_inputs(seed=0, B=2, H=4, D=32, P=4, Q=37, L=4, span=(-0.2, 1.2)):
    rng = np.random.default_rng(seed)
    levels = SHAPES[L]
    Nv = sum(h * w for h, w in levels)
    value = rng.normal(size=(B, Nv, H, D)).astype(np.float32)
    loc = locations(rng, (B, Q, H, L, P, 2), levels, span)
    aw = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    aw = aw / aw.sum(axis=(-2, -1), keepdims=True)
    return value, levels, loc, aw


# ---------------------------------------------------------------------------
# the body pick, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,want", [
    (32, BODY_VEC),    # flagship det / seg encoders and det decoder: 256 / 8
    (16, BODY_VEC),    # tiny config's encoder: 64 / 4
    (8, BODY_LANE),    # tiny config's decoder: 64 / 8
    (64, BODY_VEC), (24, BODY_LANE), (20, BODY_LANE), (128, BODY_LANE),
    (1, BODY_LANE)])
def test_msda_fwd_body_by_head_dim(head_dim, want):
    assert msda_fwd_body(head_dim) == want
    assert msda_fwd_body(head_dim, [0, 256, 4096]) == want


@pytest.mark.parametrize("ptrs", [[256, 8], [4, 256], [256, 512, 2]])
def test_msda_fwd_body_needs_aligned_bases(ptrs):
    # a base the 8- / 16-byte loads and stores cannot take
    assert msda_fwd_body(32, ptrs) == BODY_LANE
    assert msda_fwd_body(32, [p - p % 16 for p in ptrs]) == BODY_VEC


def test_msda_fwd_dispatch_cpu_is_plain_and_counts_nothing():
    """On the CPU ``ms_deform_attn`` is the plain version: no launch of
    either body is counted."""
    value, levels, loc, aw = msda_inputs(1, span="edges")
    before = (ms_deform_attn.launches, ms_deform_attn.vec_launches)
    got = ms_deform_attn(torch.from_numpy(value), levels,
                         torch.from_numpy(loc), torch.from_numpy(aw))
    assert (ms_deform_attn.launches, ms_deform_attn.vec_launches) == before
    assert torch.equal(got, ms_deform_attn_torch(
        torch.from_numpy(value), levels, torch.from_numpy(loc),
        torch.from_numpy(aw)))


# ---------------------------------------------------------------------------
# the plain version against JAX on the kernel cases' inputs, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX reference functions, imported here and not at the top, so
    that the ``cuda`` cases run where the card is and JAX is not."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from rscotr_tpu.ops.ms_deform_attn import _ms_deform_attn_xla
    from rscotr_tpu.ops.pallas import ms_deform_attn_kernel
    return types.SimpleNamespace(jax=jax, jnp=jnp,
                                 msda_xla=_ms_deform_attn_xla,
                                 mk=ms_deform_attn_kernel)


def torch_msda(value, levels, loc, aw):
    return ms_deform_attn_torch(torch.from_numpy(value), levels,
                                torch.from_numpy(loc),
                                torch.from_numpy(aw)).numpy()


@pytest.mark.parametrize("span", ["edges", (0.0, 1.0), (-0.2, 1.2)])
@pytest.mark.parametrize("P,L,Q", [(1, 4, 37), (3, 1, 37), (8, 5, 9),
                                   (4, 4, 1)])
def test_msda_plain_vs_xla_on_kernel_cases(ref, span, P, L, Q):
    value, levels, loc, aw = msda_inputs(2 + P + L, D=16, P=P, Q=Q, L=L,
                                         span=span)
    jnp = ref.jnp
    with ref.jax.default_matmul_precision("highest"):
        want = np.asarray(ref.msda_xla(
            jnp.asarray(value), levels, jnp.asarray(loc), jnp.asarray(aw)))
    np.testing.assert_allclose(torch_msda(value, levels, loc, aw), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("P,L", [(4, 4), (3, 5)])
def test_msda_plain_vs_pallas_interpret_on_edges(ref, P, L):
    value, levels, loc, aw = msda_inputs(20 + P, B=1, H=2, D=16, P=P, Q=11,
                                         L=L, span="edges")
    jnp, mk = ref.jnp, ref.mk
    mk._INTERPRET[0] = True
    try:
        want = np.asarray(mk.ms_deform_attn_pallas(
            jnp.asarray(value), levels, jnp.asarray(loc), jnp.asarray(aw)))
    finally:
        mk._INTERPRET[0] = False
    np.testing.assert_allclose(torch_msda(value, levels, loc, aw), want,
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the kernel's bodies against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16,
                                                 torch.bfloat16),
               (torch.bfloat16, torch.float32), (torch.float32,
                                                 torch.bfloat16)]


def run_and_check(dev, args, vdtype, wdtype, body, misalign_bytes=0,
                  force=None):
    """K1 on the card against ``ms_deform_attn_torch`` on the same tensors;
    asserts which body the launch took."""
    value, levels, loc, aw = args
    v = torch.from_numpy(value).to(dev, vdtype)
    if misalign_bytes:
        pad = misalign_bytes // v.element_size()
        buf = torch.empty(v.numel() + pad, device=dev, dtype=vdtype)
        buf[pad:].copy_(v.reshape(-1))
        v = buf[pad:].view(v.shape)
    w = torch.from_numpy(aw).to(dev, wdtype)
    loc_t = torch.from_numpy(loc).to(dev)
    assert msda_fwd_body(v.shape[-1], [v.data_ptr(), loc_t.data_ptr()]) == \
        (body if force is None else BODY_VEC)
    before = (ms_deform_attn.launches, ms_deform_attn.vec_launches)
    if force is None:
        got = ms_deform_attn(v, levels, loc_t, w)
    else:
        got = _ms_deform_attn_cuda(v, levels, loc_t, w, body=force)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before[0] + 1
    assert ms_deform_attn.vec_launches == before[1] + (body == BODY_VEC)
    ref = ms_deform_attn_torch(v.float(), levels, loc_t, w.float())
    atol, rtol = KTOL[vdtype]
    assert got.dtype == vdtype and got.shape == ref.shape
    assert ((got.float() - ref).abs() - rtol * ref.abs()).max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("span", [(0.0, 1.0), (-0.2, 1.2), "edges"])
@pytest.mark.parametrize("vdtype,wdtype", DTYPE_PAIRS)
@pytest.mark.parametrize("D", [16, 32, 64])
def test_msda_fwd_vector_body_vs_plain(cuda_device, D, vdtype, wdtype, span):
    run_and_check(cuda_device, msda_inputs(30 + D, D=D, span=span), vdtype,
                  wdtype, BODY_VEC)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [1, 3, 4, 8])
@pytest.mark.parametrize("L", [1, 4, 5])
def test_msda_fwd_vector_body_points_and_levels(cuda_device, L, P, dtype):
    """L * P from 1 to 40 points a task: chunks of 16 with a ragged last
    one, and rounds (2, 4 or 8 a chunk) past a task's last point."""
    for D in (16, 32, 64):
        run_and_check(cuda_device, msda_inputs(40 + L * P, D=D, P=P, L=L,
                                               span="edges"),
                      dtype, dtype, BODY_VEC)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q", [1, 600, 800])
def test_msda_fwd_vector_body_query_counts(cuda_device, Q, dtype):
    """One query (a block with one task), and the det decoder's serving and
    training query counts at the flagship's 8 heads."""
    run_and_check(cuda_device, msda_inputs(50, B=1, H=8, Q=Q, span=(0.0, 1.0)),
                  dtype, dtype, BODY_VEC)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 24, 128])
def test_msda_fwd_lane_body_head_widths(cuda_device, D, dtype):
    run_and_check(cuda_device, msda_inputs(60 + D, D=D, span="edges"), dtype,
                  dtype, BODY_LANE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_fwd_unaligned_value_takes_lane_body(cuda_device, dtype):
    """A value view 8 bytes off 16-byte alignment takes the lane body, and
    the vector body cannot be forced onto it."""
    args = msda_inputs(70)
    run_and_check(cuda_device, args, dtype, dtype, BODY_LANE,
                  misalign_bytes=8)
    value, levels, loc, aw = args
    buf = torch.empty(value.size + 8, device=cuda_device, dtype=dtype)
    v = buf[8 // buf.element_size():][:value.size].view(value.shape)
    loc_t = torch.from_numpy(loc).to(cuda_device)
    w = torch.from_numpy(aw).to(cuda_device, dtype)
    with pytest.raises(ValueError, match="base addresses"):
        _ms_deform_attn_cuda(v, levels, loc_t, w, body=BODY_VEC)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_fwd_lane_body_forced(cuda_device, dtype):
    """``body=BODY_LANE`` where the vector body would be picked (the tools'
    way to time the lane body on the same tensors)."""
    run_and_check(cuda_device, msda_inputs(80, span=(0.0, 1.0)), dtype,
                  dtype, BODY_LANE, force=BODY_LANE)
