"""What the port's one-launch MSDA backward (K1b, ``csrc/msda_bwd.cu``)
rests on, on the CPU.

The CUDA kernel adds each bilinear corner's term straight into the value
gradient at the corner's own cell, where JAX (and the port's plain version,
``ms_deform_attn_bwd_torch``) write quad-row updates, scatter them into a
quad-table gradient and fold the table back. ``direct_value_grad`` is that
direct formulation in numpy: per corner on the map,
``round_T((a * wy) * wx * d_out)`` added in float64 at the corner's cell. It
is held against the plain version's ``d_value`` and against ``jax.vjp`` of
``_ms_deform_attn_xla`` over head widths, dtypes and three location draws
(interior; [-0.1, 1.1], where starts clamp; hand-placed points on every
edge and off the map).

Tolerances. float32: the sums run in another order, 1e-5 * max|ref| + 1e-4
* |ref|. bfloat16 against the plain version, which rounds each term to
bf16 where the oracle does, sums in float32 and rounds ``d_value`` once: one
bf16 ulp (2^-7 relative) on top. bfloat16 against JAX, which also rounds
the slot weights to bf16 (the oracle's ``jax_rounding``), rounds the
quad-table gradient to bf16 and folds its four slots in bf16: 2^-6 times the
sum of the slot sums' magnitudes (four roundings of 2^-8 and three bf16
additions) on top of the float32 bound.

Also here: the function that picks the kernel's body, and the CPU dispatch
of ``ms_deform_attn_bwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rscotr_tpu.ops.ms_deform_attn import _ms_deform_attn_xla
from rscotr_tpu_torch.ops.ms_deform_attn import (BODY_LANE, BODY_VEC,
                                                 ms_deform_attn_bwd,
                                                 ms_deform_attn_bwd_torch,
                                                 msda_bwd_body)

SHAPES = ((7, 9), (4, 5), (2, 3))
B, Q, H, P = 2, 11, 2, 2
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def round_bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def as_dtype(x, dtype):
    return round_bf16(x) if dtype == "bfloat16" else x.astype(np.float32)


def off_pixel_edges(loc):
    """Move locations within 1e-3 of a pixel edge (where floor jumps) off
    it, so that both stacks land on the same cell."""
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)[:, None]
    pix = loc * wh - 0.5
    frac = pix - np.floor(pix)
    pix = np.where(frac < 1e-3, pix + 2e-3,
                   np.where(frac > 1 - 1e-3, pix - 2e-3, pix))
    return ((pix + 0.5) / wh).astype(np.float32)


def locations(draw, rng):
    """(B, Q, H, L, P, 2) float32 in (x, y) order."""
    L = len(SHAPES)
    shape = (B, Q, H, L, P, 2)
    if draw == "interior":
        # all four corners on every level's map: pixel x in [0, w - 1)
        lo = np.array([[0.55 / w, 0.55 / h] for h, w in SHAPES])[:, None]
        return off_pixel_edges(rng.uniform(lo, 1 - lo, shape))
    if draw == "clamped":
        return off_pixel_edges(rng.uniform(-0.1, 1.1, shape))
    # hand-placed: per level, pixel coordinates (x, y) whose start cell is
    # x0i = -1, x0i = W-1, y0i = -1, y0i = H-1, two corners of the map, and
    # points wholly off the map on each side
    loc = rng.uniform(0.2, 0.8, shape)
    for lvl, (h, w) in enumerate(SHAPES):
        pix = [(-0.4, 0.3 * h), (w - 0.7, 0.6 * h), (0.4 * w, -0.6),
               (0.7 * w, h - 0.8), (-0.3, -0.7), (w - 0.6, h - 0.2),
               (-1.5, 0.5 * h), (w + 0.5, 0.5 * h), (0.5 * w, -2.2),
               (0.5 * w, h + 0.2), (-3.0, h + 4.0)]
        for q, (x, y) in enumerate(pix):
            loc[:, q, :, lvl, :, 0] = (x + 0.5) / w
            loc[:, q, :, lvl, :, 1] = (y + 0.5) / h
    return off_pixel_edges(loc)


def inputs(D, dtype, draw, seed):
    rng = np.random.default_rng(seed)
    Nv = sum(h * w for h, w in SHAPES)
    loc = locations(draw, rng)
    value = as_dtype(rng.normal(size=(B, Nv, H, D)), dtype)
    aw = rng.uniform(size=(B, Q, H, len(SHAPES), P))
    aw = as_dtype(aw / aw.sum((-1, -2), keepdims=True), dtype)
    d_out = as_dtype(rng.normal(size=(B, Q, H * D)), dtype)
    return value, loc, aw, d_out


def edge_class(start, n):
    """Where a start cell lies on an axis of n cells: -2 two or more cells
    before the map (both corners off it), -1 one cell before it (the start
    clamps), 0 inside, 1 on the last cell (the far corner is off the map),
    2 past it."""
    return np.select([start < -1, start == -1, start < n - 1, start == n - 1],
                     [-2, -1, 0, 1], 2)


def direct_value_grad(value, loc, aw, d_out, dtype, jax_rounding=False):
    """The direct formulation -> (d_value (B, Nv, H, D) float64, the sum
    over a cell's four quad slots of |that slot's sum|, the set of the
    start cells' (x, y) ``edge_class`` pairs). ``jax_rounding``: the slot
    weight is (wy * wx) * a rounded to the dtype, as ``_ms_deform_attn_xla``
    hands it to its weighted sum."""
    Bn, Nv, Hn, D = value.shape
    rnd = round_bf16 if dtype == "bfloat16" else (lambda t: t)
    do = d_out.reshape(Bn, -1, Hn, 1, D)                   # (B, Q, H, 1, D)
    by_slot = np.zeros((Bn, Nv, Hn, 4, D), np.float64)
    bi = np.arange(Bn)[:, None, None, None]
    hi = np.arange(Hn)[None, None, :, None]
    seen = set()
    start = 0
    f32 = np.float32
    for lvl, (h, w) in enumerate(SHAPES):
        a = aw[:, :, :, lvl]                               # (B, Q, H, P)
        x = loc[:, :, :, lvl, :, 0] * f32(w) - f32(0.5)
        y = loc[:, :, :, lvl, :, 1] * f32(h) - f32(0.5)
        assert x.dtype == np.float32
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = x - x0, y - y0
        x0i, y0i = x0.astype(np.int64), y0.astype(np.int64)
        xl, yl = np.clip(x0i, 0, w - 1), np.clip(y0i, 0, h - 1)
        seen |= set(zip(edge_class(x0i, w).flat, edge_class(y0i, h).flat))
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0i + dx, y0i + dy
                on = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                wy = fy if dy else f32(1) - fy
                wx = fx if dx else f32(1) - fx
                wgt = rnd((wy * wx) * a) if jax_rounding else (a * wy) * wx
                term = rnd(wgt[..., None] * do)            # (B, Q, H, P, D)
                assert term.dtype == np.float32
                slot = 2 * (yi - yl) + (xi - xl)
                # a corner on the map lands on one of the row's four slots
                assert ((slot[on] >= 0) & (slot[on] < 4)).all()
                cell = start + yi * w + xi
                idx = tuple(np.broadcast_to(t, on.shape)[on]
                            for t in (bi, cell, hi, slot))
                np.add.at(by_slot, idx, term[on].astype(np.float64))
        start += h * w
    return by_slot.sum(3), np.abs(by_slot).sum(3), seen


def plain_value_grad(value, loc, aw, d_out, dtype):
    tt = DTYPES[dtype][0]
    t = lambda x: torch.from_numpy(x).to(tt)               # noqa: E731
    d_value, _, _ = ms_deform_attn_bwd_torch(
        t(value), SHAPES, torch.from_numpy(loc), t(aw), t(d_out))
    assert d_value.dtype == tt
    return d_value.float().numpy().astype(np.float64)


def jax_value_grad(value, loc, aw, d_out, dtype):
    jt = DTYPES[dtype][1]
    j = lambda x: jnp.asarray(x).astype(jt)                # noqa: E731
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda v, lc, a: _ms_deform_attn_xla(v, SHAPES, lc, a, "xla"),
            j(value), jnp.asarray(loc), j(aw))
        d_value = vjp(j(d_out))[0]
    assert d_value.dtype == jt
    return np.asarray(d_value.astype(jnp.float32)).astype(np.float64)


def assert_within(got, want, extra=0.0):
    bound = 1e-5 * np.abs(want).max() + 1e-4 * np.abs(want) + extra
    over = np.abs(got - want) - bound
    assert over.max() <= 0, f"excess {over.max():.3e} at |ref| up to " \
                            f"{np.abs(want).max():.3g}"


CASES = [(D, dtype, draw) for D in (16, 24, 32, 64)
         for dtype in ("float32", "bfloat16")
         for draw in ("interior", "clamped", "placed")]


@pytest.mark.parametrize("D,dtype,draw", CASES)
def test_direct_value_grad_vs_plain(D, dtype, draw):
    args = inputs(D, dtype, draw, seed=D + len(draw))
    want, _, seen = direct_value_grad(*args, dtype)
    got = plain_value_grad(*args, dtype)
    assert np.abs(want).max() > 0.1
    assert_within(got, want, BF16_ULP * np.abs(want)
                  if dtype == "bfloat16" else 0.0)
    # the draw reaches what it is meant to
    if draw == "interior":
        assert seen == {(0, 0)}
    if draw == "clamped":
        assert {-1, 1} <= {cx for cx, _ in seen} | {cy for _, cy in seen}
    if draw == "placed":
        assert {cx for cx, _ in seen} == {-2, -1, 0, 1, 2}
        assert {cy for _, cy in seen} == {-2, -1, 0, 1, 2}
        assert {(-1, -1), (1, 1)} <= seen


@pytest.mark.parametrize("D,dtype,draw", CASES)
def test_direct_value_grad_vs_jax_vjp(D, dtype, draw):
    args = inputs(D, dtype, draw, seed=100 + D + len(draw))
    bf = dtype == "bfloat16"
    want, slot_abs, _ = direct_value_grad(*args, dtype, jax_rounding=bf)
    got = jax_value_grad(*args, dtype)
    assert np.abs(want).max() > 0.1
    assert_within(got, want, 2.0 ** -6 * slot_abs if bf else 0.0)


@pytest.mark.parametrize("head_dim,want", [
    (32, BODY_VEC),    # flagship det / seg encoders and det decoder: 256 / 8
    (16, BODY_VEC),    # tiny config's encoder: 64 / 4
    (8, BODY_LANE),    # tiny config's decoder: 64 / 8
    (64, BODY_VEC), (24, BODY_LANE), (20, BODY_LANE), (128, BODY_LANE),
    (1, BODY_LANE)])
def test_msda_bwd_body_by_head_dim(head_dim, want):
    assert msda_bwd_body(head_dim) == want
    assert msda_bwd_body(head_dim, [0, 256, 4096]) == want


@pytest.mark.parametrize("ptrs", [[256, 8], [4, 256], [256, 512, 2]])
def test_msda_bwd_body_needs_aligned_bases(ptrs):
    # a base the vector loads or the 16-byte reduction cannot take
    assert msda_bwd_body(32, ptrs) == BODY_LANE
    assert msda_bwd_body(32, [p - p % 16 for p in ptrs]) == BODY_VEC


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_bwd_dispatch_cpu_is_plain_and_counts_nothing(dtype):
    value, loc, aw, d_out = inputs(16, dtype, "clamped", seed=7)
    tt = DTYPES[dtype][0]
    args = (torch.from_numpy(value).to(tt), SHAPES, torch.from_numpy(loc),
            torch.from_numpy(aw).to(tt), torch.from_numpy(d_out).to(tt))
    before = ms_deform_attn_bwd.launches
    got = ms_deform_attn_bwd(*args)
    want = ms_deform_attn_bwd_torch(*args)
    assert ms_deform_attn_bwd.launches == before
    for g, w, primal in zip(got, want, (args[0], args[2], args[3])):
        assert g.dtype == primal.dtype and g.shape == primal.shape
        assert torch.equal(g, w)
