"""The quad-gather MSDA forward: K4 (``ws_fwd``, ``csrc/msda_ws.cu``), its
vector body beside its lane-per-column body.

On the CPU: ``ws_fwd_body``, the function that picks the body of a CUDA
launch, by head width, KP and alignment; the CPU dispatch of ``ws_fwd``
(the plain version, no launch counted); ``ws_fwd_torch`` against the Pallas
``ws_fwd`` in interpret mode at head widths D in {16, 32, 64} and KP in
{1, 3, 12, 16, 20} (rows shorter than one warp instruction, D = 16 with odd
KP, which ends a row in half an instruction, and more than one batch of a
row). Tolerance: float32 sums in another order, within ``BTOL``,
|got - ref| <= 1e-5 max|ref| + 1e-4 |ref|.

On the card (marker ``cuda``; it has no JAX: run with ``python -m pytest
--noconftest -m cuda tests/test_torch_port_quad_fwd_vec.py``): the vector
body against ``ws_fwd_torch`` in float32 and bfloat16 at those widths and
KP; the lane body forced, and taken on a base 8 bytes off alignment and at
widths the vector body does not take (D = 8, 48); the quad path's K4 launch
on the vector body. The kernel's output is float32 sums in another order:
within ``BTOL``.
"""

import types

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE, BODY_VEC
from rscotr_tpu_torch.ops.msda_ws import (_ws_fwd_cuda, ws_fwd, ws_fwd_body,
                                          ws_fwd_torch)

HEAD_DIMS = (16, 32, 64)
KPS = (1, 3, 12, 16, 20)
BTOL = (1e-5, 1e-4)   # float32 outputs: atol * max|ref| + rtol * |ref|


def ws_inputs(D, KP, seed, G=2, Q=9):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(G, Q, KP, 4 * D)).astype(np.float32)
    wt = rng.uniform(size=(G, Q, 4 * KP)).astype(np.float32)
    return g, wt


def assert_btol(got, ref):
    atol, rtol = BTOL
    assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
    scale = ref.abs().max().item()
    assert ((got - ref).abs() - rtol * ref.abs()).max().item() <= \
        atol * scale


# ---------------------------------------------------------------------------
# the body pick and the CPU dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,KP,want", [
    (32, 16, BODY_VEC),     # the flagship det / seg encoders: 4 levels x 4
    (16, 16, BODY_VEC), (64, 16, BODY_VEC), (32, 1, BODY_VEC),
    (16, 3, BODY_VEC), (64, 64, BODY_VEC),
    (32, 65, BODY_LANE),    # more points than one row's weights hold
    (8, 16, BODY_LANE), (24, 16, BODY_LANE), (48, 4, BODY_LANE),
    (128, 4, BODY_LANE), (1, 1, BODY_LANE)])
def test_ws_fwd_body_by_head_dim_and_kp(D, KP, want):
    assert ws_fwd_body(D, KP) == want
    assert ws_fwd_body(D, KP, [0, 4096]) == want


@pytest.mark.parametrize("ptrs", [[256, 8], [4, 256], [256, 1032]])
def test_ws_fwd_body_needs_aligned_bases(ptrs):
    # a base the 8- / 16-byte g loads or the 16-byte stores cannot take
    assert ws_fwd_body(32, 16, ptrs) == BODY_LANE
    assert ws_fwd_body(32, 16, [p - p % 16 for p in ptrs]) == BODY_VEC


def test_ws_fwd_dispatch_cpu_is_plain_and_counts_nothing():
    g, wt = (torch.from_numpy(a) for a in ws_inputs(32, 3, 1))
    before = (ws_fwd.launches, ws_fwd.vec_launches)
    assert torch.equal(ws_fwd(g, wt), ws_fwd_torch(g, wt))
    assert (ws_fwd.launches, ws_fwd.vec_launches) == before
    with pytest.raises(ValueError, match="no path for device"):
        ws_fwd(g.to("meta"), wt.to("meta"))


# ---------------------------------------------------------------------------
# the plain version against JAX on the vector body's cases, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here and not at the top, so that the
    ``cuda`` cases run where the card is and JAX is not."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from rscotr_tpu.ops.pallas import msda_ws
    return types.SimpleNamespace(jnp=jnp, ws=msda_ws)


@pytest.mark.parametrize("KP", KPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ws_fwd_plain_vs_pallas_interpret(ref, D, KP):
    g, wt = ws_inputs(D, KP, 10 + D + KP)
    want = np.array(ref.ws.ws_fwd(ref.jnp.asarray(g), ref.jnp.asarray(wt),
                                  interpret=True))
    got = ws_fwd_torch(torch.from_numpy(g), torch.from_numpy(wt))
    assert got.shape == (2, 9, D) and want.shape == (2, 9, D)
    assert_btol(got, torch.from_numpy(want))


# ---------------------------------------------------------------------------
# the kernel's bodies against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def misaligned(t, nbytes=8):
    """A copy of ``t`` whose base lies ``nbytes`` off 16-byte alignment."""
    pad = nbytes // t.element_size()
    buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)
    buf[pad:].copy_(t.reshape(-1))
    return buf[pad:].view(t.shape)


def run_ws_fwd(dev, D, KP, dtype, body, seed, force=None, skew=0):
    """K4 on the card against ``ws_fwd_torch`` on the same tensors; asserts
    which body the launch took. ``skew``: g's base that many bytes off
    16-byte alignment."""
    g, wt = (torch.from_numpy(a).to(dev, dtype)
             for a in ws_inputs(D, KP, seed, Q=37))
    if skew:
        g = misaligned(g, skew)
    before = (ws_fwd.launches, ws_fwd.vec_launches)
    out = ws_fwd(g, wt) if force is None else _ws_fwd_cuda(g, wt, body=force)
    torch.cuda.synchronize()
    assert (ws_fwd.launches, ws_fwd.vec_launches) == \
        (before[0] + 1, before[1] + (body == BODY_VEC))
    assert_btol(out, ws_fwd_torch(g, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KP", KPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ws_fwd_vector_body_vs_plain(cuda_device, D, KP, dtype):
    run_ws_fwd(cuda_device, D, KP, dtype, BODY_VEC, 30 + D + KP)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ws_fwd_lane_body_forced(cuda_device, D, dtype):
    """``body=BODY_LANE`` where the vector body would be picked (the tools'
    way to time the lane body on the same tensors)."""
    run_ws_fwd(cuda_device, D, 16, dtype, BODY_LANE, 40 + D,
               force=BODY_LANE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ws_fwd_unaligned_g_takes_lane_body(cuda_device, dtype):
    """g 8 bytes off 16-byte alignment takes the lane body, and the vector
    body cannot be forced onto it."""
    run_ws_fwd(cuda_device, 32, 16, dtype, BODY_LANE, 50, skew=8)
    g, wt = (torch.from_numpy(a).to(cuda_device, dtype)
             for a in ws_inputs(32, 16, 51))
    with pytest.raises(ValueError, match="base addresses"):
        _ws_fwd_cuda(misaligned(g), wt, body=BODY_VEC)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 48])
def test_ws_fwd_other_width_takes_lane_body(cuda_device, D, dtype):
    run_ws_fwd(cuda_device, D, 12, dtype, BODY_LANE, 60 + D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
def test_quad_path_takes_the_vector_body(cuda_device, D, dtype):
    """``ms_deform_attn(impl="quad")`` forward launches K4 once, on its
    vector body."""
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    rng = np.random.default_rng(90 + D)
    shapes = ((12, 16), (6, 8), (3, 4))
    Nv = sum(h * w for h, w in shapes)
    v = rng.normal(size=(2, Nv, 4, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(2, 37, 4, 3, 4, 2)).astype(np.float32)
    aw = rng.uniform(size=(2, 37, 4, 3, 4)).astype(np.float32)
    v, aw = (torch.from_numpy(a).to(cuda_device, dtype) for a in (v, aw))
    loc = torch.from_numpy(loc).to(cuda_device)
    before = (ws_fwd.launches, ws_fwd.vec_launches)
    with torch.no_grad():
        out = ms_deform_attn(v, shapes, loc, aw, impl="quad")
    torch.cuda.synchronize()
    assert (ws_fwd.launches, ws_fwd.vec_launches) == \
        tuple(c + 1 for c in before)
    assert out.shape == (2, 37, 4 * D) and torch.isfinite(out).all()
