"""The port's training pieces against the JAX package's, module by module,
on the CPU at small sizes: box ops, losses, match costs, the host
Hungarian, CDN queries and targets, the DINO loss, K3's plain version, the
MSDA and window-attention backward decompositions, the optimizer, the
paramwise multipliers, drop path and the cls batch augment.

Inputs are drawn with numpy from a seed and copied into both stacks; JAX
runs under highest matmul precision. Tolerance 1e-5 relative / 1e-5
absolute for values and 1e-4 / 1e-4 x max|ref| for gradients, unless a test
says otherwise: the two stacks sum in other orders in float32.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu.engine import optimizer as jopt
from rscotr_tpu.engine.train_step import cls_batch_augment as j_cls_augment
from rscotr_tpu.models.heads import cdn as jcdn
from rscotr_tpu.ops import box_ops as jbox
from rscotr_tpu.ops import losses as jlosses
from rscotr_tpu.ops import matcher as jmatcher
from rscotr_tpu.ops.ms_deform_attn import _ms_deform_attn_xla
from rscotr_tpu.ops.pallas.scatter_mm import scatter_add_mm as j_scatter_mm
from rscotr_tpu.ops.pallas.scatter_mm import scatter_add_xla
from rscotr_tpu_torch.engine import optimizer as topt
from rscotr_tpu_torch.engine.train_step import cls_batch_augment
from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
from rscotr_tpu_torch.models.heads import cdn as tcdn
from rscotr_tpu_torch.models.heads import dino_loss as tdl
from rscotr_tpu_torch.models.layers.common import (DropPath, Dropout,
                                                   drop_path_rates)
from rscotr_tpu_torch.ops import box_ops as tbox
from rscotr_tpu_torch.ops import losses as tlosses
from rscotr_tpu_torch.ops import matcher as tmatcher
from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                 ms_deform_attn_bwd_torch)
from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm_torch
from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                   window_attention_bwd_torch)
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs/multi/MTL_tiny_synthetic.py")
# the heads package re-exports a function named dino_loss
jdl = importlib.import_module("rscotr_tpu.models.heads.dino_loss")
VTOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **(tol or VTOL))


def grad_close(got, want, rtol=1e-4, atol=1e-4):
    """|got - want| <= atol * max|want| + rtol * |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    bound = atol * max(np.abs(want).max(), 1e-30) + rtol * np.abs(want)
    err = np.abs(got - want) - bound
    assert (err <= 0).all(), f"max excess {err.max():.3e}"


def boxes_xyxy(rng, n, lo=0.0, hi=100.0):
    xy = rng.uniform(lo, hi * 0.7, (n, 2))
    wh = rng.uniform(hi * 0.05, hi * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# box ops and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,aligned", [("iou", False), ("giou", False),
                                          ("giou", True)])
def test_bbox_overlaps(mode, aligned):
    rng = np.random.default_rng(1)
    a, b = boxes_xyxy(rng, 6), boxes_xyxy(rng, 6 if aligned else 9)
    close(tbox.bbox_overlaps(t(a), t(b), mode=mode, is_aligned=aligned),
          jbox.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode=mode,
                             is_aligned=aligned))
    close(tbox.bbox_xyxy_to_cxcywh(t(a)), jbox.bbox_xyxy_to_cxcywh(a))
    close(tbox.bbox_area(t(a)), jbox.bbox_area(a), rtol=1e-6, atol=1e-3)


def _loss_cases(rng):
    N, C = 12, 5
    logits = rng.normal(size=(N, C)).astype(np.float32)
    labels = rng.integers(0, C + 1, N).astype(np.int32)   # C = background
    w = rng.uniform(size=N).astype(np.float32)
    pred, tgt = boxes_xyxy(rng, N), boxes_xyxy(rng, N)
    bw = np.repeat((rng.uniform(size=(N, 1)) > 0.3).astype(np.float32), 4, 1)
    seg_logits = rng.normal(size=(2, 4, 5, C)).astype(np.float32)
    seg_lab = rng.integers(0, C, (2, 4, 5)).astype(np.int32)
    seg_lab[0, 0] = 255
    soft = rng.uniform(size=(N, C)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    masks = (rng.uniform(size=(N, 6, 6)) > 0.5).astype(np.float32)
    mlog = rng.normal(size=(N, 6, 6)).astype(np.float32)
    return {
        "focal": (lambda m, x: m.sigmoid_focal_loss(
            x, labels, weight=w, avg_factor=3.0), logits),
        "focal_noweight": (lambda m, x: m.sigmoid_focal_loss(
            x, labels, alpha=0.3, gamma=1.5), logits),
        "l1": (lambda m, x: m.l1_loss(x, tgt, weight=bw, avg_factor=4.0),
               pred),
        "giou": (lambda m, x: m.giou_loss(x, tgt, weight=bw,
                                          avg_factor=4.0), pred),
        "ce_ignore": (lambda m, x: m.softmax_cross_entropy(x, seg_lab),
                      seg_logits),
        "ce_all": (lambda m, x: m.softmax_cross_entropy(
            x, seg_lab, avg_non_ignore=False), seg_logits),
        "label_smooth_int": (lambda m, x: m.label_smooth_loss(
            x, labels % C), logits),
        "label_smooth_soft": (lambda m, x: m.label_smooth_loss(x, soft),
                              logits),
        "dice": (lambda m, x: m.dice_loss(x, masks, avg_factor=2.0), mlog),
    }


@pytest.mark.parametrize("name", ["focal", "focal_noweight", "l1", "giou",
                                  "ce_ignore", "ce_all", "label_smooth_int",
                                  "label_smooth_soft", "dice"])
def test_loss_value_and_grad(name):
    fn, x = _loss_cases(np.random.default_rng(2))[name]

    class JM:   # the JAX module with numpy args made jnp
        def __getattr__(self, k):
            f = getattr(jlosses, k)
            return lambda *a, **kw: f(*[jnp.asarray(v) if isinstance(
                v, np.ndarray) else v for v in a], **{
                    kk: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                    for kk, v in kw.items()})

    class TM:
        def __getattr__(self, k):
            f = getattr(tlosses, k)
            return lambda *a, **kw: f(*[t(v) if isinstance(
                v, np.ndarray) else v for v in a], **{
                    kk: t(v) if isinstance(v, np.ndarray) else v
                    for kk, v in kw.items()})

    with jax.default_matmul_precision("highest"):
        want, jg = jax.value_and_grad(lambda v: fn(JM(), v))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = fn(TM(), xt)
    (tg,) = torch.autograd.grad(got, xt)
    close(got, want)
    grad_close(tg, jg)


def test_accuracy():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(20, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 20)
    for k in (1, 3):
        close(tlosses.accuracy(t(logits), t(labels), topk=k),
              jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                               topk=k))


# ---------------------------------------------------------------------------
# matcher
# ---------------------------------------------------------------------------

def test_match_costs():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(30, 6)).astype(np.float32)
    gl = rng.integers(0, 6, 5).astype(np.int32)
    pred = rng.uniform(0.1, 0.6, (30, 4)).astype(np.float32)
    gt = rng.uniform(0.1, 0.6, (5, 4)).astype(np.float32)
    pb, gb = boxes_xyxy(rng, 30), boxes_xyxy(rng, 5)
    close(tmatcher.focal_loss_cost(t(logits), t(gl)),
          jmatcher.focal_loss_cost(jnp.asarray(logits), jnp.asarray(gl)))
    close(tmatcher.bbox_l1_cost(t(pred), t(gt)),
          jmatcher.bbox_l1_cost(jnp.asarray(pred), jnp.asarray(gt)))
    close(tmatcher.iou_cost(t(pb), t(gb)),
          jmatcher.iou_cost(jnp.asarray(pb), jnp.asarray(gb)))


@pytest.mark.parametrize("kind", ["random", "tied", "padded"])
def test_hungarian_equals_jax(kind):
    rng = np.random.default_rng({"random": 5, "tied": 6, "padded": 7}[kind])
    N, nr, nc = 6, 8, 20
    if kind == "tied":   # integer costs: many ties, first-index argmin
        cost = rng.integers(0, 4, (N, nr, nc)).astype(np.float32)
    else:
        cost = rng.normal(size=(N, nr, nc)).astype(np.float32)
    valid = np.ones((N, nr), bool)
    if kind == "padded":
        for i in range(N):
            valid[i, rng.integers(1, nr):] = False
        cost = np.where(valid[..., None], cost, np.float32(1e6))
    want = np.asarray(jmatcher.hungarian_batched_masked(
        jnp.asarray(cost), jnp.asarray(valid)))
    got = tmatcher.hungarian_batched(cost, valid)
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) == valid).all()


# ---------------------------------------------------------------------------
# CDN
# ---------------------------------------------------------------------------

def _gts(rng, B=2, G=6, counts=(3, 5), hw=((64, 64), (50, 60))):
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.zeros((B, G), np.int32)
    valid = np.zeros((B, G), bool)
    for b, n in enumerate(counts):
        bx = boxes_xyxy(rng, n, hi=min(hw[b]))
        boxes[b, :n] = bx
        labels[b, :n] = rng.integers(0, 7, n)
        valid[b, :n] = True
    return boxes, labels, valid, np.array(hw, np.int32)


@pytest.mark.parametrize("dn_max_gt", [4, 6, 9])
def test_cdn_queries_targets_and_mask(dn_max_gt):
    """S < max_gt (slice), S == max_gt, S > max_gt (ladder widening)."""
    rng = np.random.default_rng(8 + dn_max_gt)
    boxes, labels, valid, hw = _gts(rng)
    norm = (boxes / np.concatenate([hw[:, ::-1], hw[:, ::-1]], 1)[:, None]
            ).astype(np.float32)
    from rscotr_tpu_torch.ops.box_ops import bbox_xyxy_to_cxcywh
    cxcywh = bbox_xyxy_to_cxcywh(t(norm)).numpy()
    kw = dict(num_classes=7, num_queries=10, max_gt=6, num_dn_queries=18,
              dn_max_gt=dn_max_gt)
    jc, tc = jcdn.CdnConfig(**kw), tcdn.CdnConfig(**kw)
    assert (tc.single_pad, tc.num_groups, tc.pad_size) == \
        (jc.single_pad, jc.num_groups, jc.pad_size)
    shape = (2, 2 * tc.num_groups, tc.single_pad)
    noise = dict(p=rng.uniform(size=shape).astype(np.float32),
                 new_label=rng.integers(0, 7, shape).astype(np.int32),
                 sign=(rng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
                 part=rng.uniform(size=shape + (4,)).astype(np.float32))
    emb = rng.normal(size=(7, 8)).astype(np.float32)
    jl, jb = jcdn.generate_cdn_queries(
        jax.random.key(0), jnp.asarray(cxcywh), jnp.asarray(labels),
        jnp.asarray(valid), jnp.asarray(emb), jc,
        noise={k: jnp.asarray(v) for k, v in noise.items()})
    tl, tb = tcdn.generate_cdn_queries(t(cxcywh), t(labels), t(valid),
                                       t(emb), tc, noise)
    close(tl, jl)
    close(tb, jb)
    np.testing.assert_array_equal(tcdn.cdn_self_attn_mask(tc),
                                  jcdn.cdn_self_attn_mask(jc))
    jt = jcdn.cdn_targets(jnp.asarray(cxcywh), jnp.asarray(labels),
                          jnp.asarray(valid), jc)
    tt = tcdn.cdn_targets(t(cxcywh), t(labels), t(valid), tc)
    for k in jt:
        close(tt[k], jt[k])


def test_cdn_noise_draws_shapes():
    tc = tcdn.CdnConfig(num_classes=7, num_queries=10, max_gt=6,
                        num_dn_queries=18, dn_max_gt=4)
    n = tcdn.draw_cdn_noise(torch.Generator().manual_seed(0), 3, tc)
    assert n["p"].shape == n["new_label"].shape == (3, 8, 4)
    assert n["sign"].shape == n["part"].shape == (3, 8, 4, 4)
    assert set(n["sign"].unique().tolist()) <= {-1.0, 1.0}
    assert 0 <= int(n["new_label"].min()) and int(n["new_label"].max()) < 7


# ---------------------------------------------------------------------------
# DINO loss on fixed head outputs
# ---------------------------------------------------------------------------

def _head_outputs(rng, L, B, P, Nq, K, boxes, valid, hw, last_query_hit):
    all_cls = rng.normal(size=(L, B, P + Nq, K)).astype(np.float32)
    all_coords = rng.uniform(0.2, 0.7, (L, B, P + Nq, 4)).astype(np.float32)
    all_coords[..., 2:] *= 0.4
    topk_score = rng.normal(size=(B, Nq, K)).astype(np.float32)
    topk_anchor = rng.uniform(0.2, 0.7, (B, Nq, 4)).astype(np.float32)
    topk_anchor[..., 2:] *= 0.4
    if last_query_hit:
        # the last matching query sits exactly on GT 0 with a confident
        # logit, so the matcher assigns it: a padded row's write of index
        # -1 then lands on it (ROADMAP C3)
        hw_f = np.concatenate([hw[:, ::-1], hw[:, ::-1]], 1)
        for b in range(B):
            n = boxes[b, 0] / hw_f[b]
            c = np.array([(n[0] + n[2]) / 2, (n[1] + n[3]) / 2,
                          n[2] - n[0], n[3] - n[1]], np.float32)
            all_coords[:, b, -1] = c
            topk_anchor[b, -1] = c
    return all_cls, all_coords, topk_score, topk_anchor


@pytest.mark.parametrize("last_query_hit", [False, True])
def test_dino_loss_value_and_grad(last_query_hit):
    rng = np.random.default_rng(12 + last_query_hit)
    K, Nq, L = 7, 12, 2
    boxes, labels, valid, hw = _gts(rng)
    kw = dict(num_classes=K, num_queries=Nq, max_gt=6, num_dn_queries=8,
              dn_max_gt=4)
    jc, tc = jcdn.CdnConfig(**kw), tcdn.CdnConfig(**kw)
    dcfg = dict(num_classes=K)
    outs = _head_outputs(rng, L, 2, tc.pad_size, Nq, K, boxes, valid, hw,
                         last_query_hit)
    gt = (boxes, labels, valid, hw)

    def jloss(*o):
        d = jdl.dino_loss(*o, *map(jnp.asarray, gt), jc,
                          jdl.DetLossConfig(**dcfg))
        return sum(d.values()), d

    with jax.default_matmul_precision("highest"):
        (_, jd), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
            *map(jnp.asarray, outs))
    tin = [t(o).requires_grad_() for o in outs]
    td = tdl.dino_loss(*tin, *map(t, gt), tc, tdl.DetLossConfig(**dcfg))
    assert set(td) == set(jd)     # jax sorts the aux dict's keys
    for k in jd:
        close(td[k], jd[k], rtol=1e-5, atol=2e-5)
    tg = torch.autograd.grad(sum(td.values()), tin)
    for a, b in zip(tg, jg):
        grad_close(a, b)


def test_loss_single_layer_matches_on_its_own():
    """Without precomputed columns a layer is matched image by image."""
    rng = np.random.default_rng(14)
    K, Nq = 7, 12
    boxes, labels, valid, hw = _gts(rng)
    cls = rng.normal(size=(2, Nq, K)).astype(np.float32)
    box = rng.uniform(0.2, 0.6, (2, Nq, 4)).astype(np.float32)
    gt = (boxes, labels, valid, hw)
    with jax.default_matmul_precision("highest"):
        want = jdl.loss_single_layer(jnp.asarray(cls), jnp.asarray(box),
                                     *map(jnp.asarray, gt),
                                     jdl.DetLossConfig(num_classes=K))
    got = tdl.loss_single_layer(t(cls), t(box), *map(t, gt),
                                tdl.DetLossConfig(num_classes=K))
    for g, w in zip(got, want):
        close(g, w)


def test_target_columns_keep_last_write():
    cols = np.array([[3, -1, 5, -1], [7, 2, -1, 7]])
    # row -1 -> column 7 (Nq - 1); duplicates: the later row wins
    np.testing.assert_array_equal(tdl._target_columns(cols, 8),
                                  [[3, 8, 5, 7], [8, 2, 8, 7]])


# ---------------------------------------------------------------------------
# K3 plain version, MSDA and window-attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_plain_vs_jax(dtype):
    rng = np.random.default_rng(20)
    G, K, C, rows = 3, 300, 128, 40     # K pads to the kernel's k-block
    upd = rng.normal(size=(G, K, C)).astype(np.float32)
    idx = rng.integers(0, rows, (G, K)).astype(np.int32)
    idx[:, :50] = 7                      # many repeats of one row
    ju = jnp.asarray(upd).astype(dtype)
    want_mm = np.asarray(j_scatter_mm(ju, jnp.asarray(idx), rows,
                                      acc_dtype=jnp.float32, interpret=True))
    want_xla = np.asarray(scatter_add_xla(ju, jnp.asarray(idx), rows))
    tu = t(upd).to(getattr(torch, dtype))
    got = scatter_add_mm_torch(tu, t(idx), rows)
    assert got.dtype == torch.float32 and got.shape == (G, rows, C)
    close(got, want_mm, rtol=1e-5, atol=1e-4)
    close(got, want_xla, rtol=1e-5, atol=1e-4)


def test_scatter_add_plain_drops_out_of_range():
    upd = torch.ones(1, 4, 2)
    idx = torch.tensor([[0, -1, 3, 1]], dtype=torch.int32)
    got = scatter_add_mm_torch(upd, idx, 2)
    assert got.tolist() == [[[1.0, 1.0], [1.0, 1.0]]]


def _msda_bwd_inputs(seed, ref_dim, B=2, H=3, D=8, P=2, Q=9,
                     shapes=((7, 9), (4, 5), (2, 3))):
    """Locations as the MSDA module forms them from 2- or 4-dim reference
    points, spanning [-0.2, 1.2], and none within 1e-3 of a pixel edge
    (where floor jumps)."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    Nv = sum(h * w for h, w in shapes)
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    if ref_dim == 2:
        ref = rng.uniform(0.0, 1.0, (B, Q, 1, L, 1, 2))
        off = rng.normal(scale=1.5, size=(B, Q, H, L, P, 2))
        loc = ref + off / wh[None, None, None, :, None, :]
    else:
        ref = np.concatenate([rng.uniform(0, 1, (B, Q, 1, L, 1, 2)),
                              rng.uniform(0.2, 0.6, (B, Q, 1, L, 1, 2))], -1)
        off = rng.normal(scale=1.5, size=(B, Q, H, L, P, 2))
        loc = ref[..., :2] + off / P * ref[..., 2:] * 0.5
    loc = np.clip(loc, -0.2, 1.2)
    pix = loc * wh[None, None, None, :, None, :] - 0.5
    frac = pix - np.floor(pix)
    pix = np.where(frac < 1e-3, pix + 2e-3, np.where(frac > 1 - 1e-3,
                                                     pix - 2e-3, pix))
    loc = ((pix + 0.5) / wh[None, None, None, :, None, :]).astype(np.float32)
    value = rng.normal(size=(B, Nv, H, D)).astype(np.float32)
    aw = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    aw /= aw.sum((-1, -2), keepdims=True)
    d_out = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    return value, shapes, loc, aw, d_out


@pytest.mark.parametrize("bwd_impl", ["xla", "pallas_mm_interpret"])
@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msda_backward_vs_jax_vjp(bwd_impl, ref_dim):
    value, shapes, loc, aw, d_out = _msda_bwd_inputs(30 + ref_dim, ref_dim)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda v, lc, a: _ms_deform_attn_xla(
            v, shapes, lc, a, bwd_impl), *map(jnp.asarray,
                                             (value, loc, aw)))
        want = vjp(jnp.asarray(d_out))
    plain = ms_deform_attn_bwd_torch(t(value), shapes, t(loc), t(aw),
                                     t(d_out))
    ins = [t(x).requires_grad_() for x in (value, loc, aw)]
    fn = torch.autograd.grad(ms_deform_attn(ins[0], shapes, ins[1], ins[2]),
                             ins, t(d_out))
    for p, f, w in zip(plain, fn, want):
        grad_close(p, w)
        assert torch.equal(p, f)


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
def test_window_attention_backward_vs_jax_vjp(shifted):
    rng = np.random.default_rng(40 + shifted)
    B, nW, H, n, hd = 2, 4, 3, 49, 16
    q, k, v = (rng.normal(size=(B, nW, H, n, hd)).astype(np.float32)
               for _ in range(3))
    bias = (rng.normal(size=(H, n, n)) * 0.5).astype(np.float32)
    mask = _shift_attn_mask(14, 14, 7, 3) if shifted else None
    d_out = rng.normal(size=(B, nW, H, n, hd)).astype(np.float32)
    scale = hd ** -0.5
    jm = None if mask is None else jnp.asarray(mask)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a, b, c, d: _swin_einsum_path(
            a, b, c, d, jm, scale), *map(jnp.asarray, (q, k, v, bias)))
        want = vjp(jnp.asarray(d_out))
    tm = None if mask is None else t(mask)
    plain = window_attention_bwd_torch(t(q), t(k), t(v), t(bias), tm, scale,
                                       t(d_out))
    ins = [t(x).requires_grad_() for x in (q, k, v, bias)]
    fn = torch.autograd.grad(window_attention(*ins, tm, scale), ins,
                             t(d_out))
    for p, f, w in zip(plain, fn, want):
        grad_close(p, w)
        assert torch.equal(p, f)


# ---------------------------------------------------------------------------
# optimizer and paramwise multipliers
# ---------------------------------------------------------------------------

def test_optimizer_matches_jax():
    """Several steps with task masks, grad clip, cumulative_iters=2, a
    momentum schedule, paramwise multipliers and one never-reached
    parameter (``.grad`` None in the port, zeros in JAX)."""
    rng = np.random.default_rng(50)
    shapes = {"backbone.w": (4, 3), "neck.b": (5,), "bbox_head.q": (3, 2),
              "cls_head.fc": (6,)}
    init = {n: rng.normal(size=s).astype(np.float32)
            for n, s in shapes.items()}
    kw = dict(custom_keys={"backbone": dict(lr_mult=0.1),
                           "bbox_head.q": dict(decay_mult=0.0)})
    lr_config = dict(policy="step", step=[3], gamma=0.5, warmup="linear",
                     warmup_iters=2, warmup_ratio=0.1)
    mom = dict(policy="CosineAnnealing", min_momentum_ratio=0.8,
               max_iters=6)
    cfg = dict(type="AdamW", lr=1e-2, weight_decay=0.05,
               paramwise_cfg=kw)
    jp = {n: jnp.asarray(v) for n, v in init.items()}
    jo = jopt.build_optimizer(cfg, jp, lr_config=lr_config,
                              grad_clip=dict(max_norm=0.5),
                              momentum_config=mom, cumulative_iters=2)
    js = jo.init(jp)
    tp = {n: torch.nn.Parameter(t(v)) for n, v in init.items()}
    to = topt.build_optimizer(cfg, tp.items(), lr_config=lr_config,
                              grad_clip=dict(max_norm=0.5),
                              momentum_config=mom, cumulative_iters=2)
    tmasks = topt.task_param_masks(shapes)
    jmasks = {task: {n: jnp.asarray(m) for n, m in ms.items()}
              for task, ms in tmasks.items()}
    for i, task in enumerate(("det", "cls", "det", "det", "cls", "cls")):
        grads = {n: (rng.normal(size=s) * 3).astype(np.float32)
                 for n, s in shapes.items()}
        grads["cls_head.fc"] *= float(task == "cls")
        jg = {n: jnp.asarray(g) for n, g in grads.items()}
        jp, js, jn = jo.update(jg, js, jp, jmasks[task])
        tg = {n: (None if task == "det" and n == "cls_head.fc" else t(g))
              for n, g in grads.items()}
        tn = to.update(tg, tmasks[task])
        close(tn, jn, rtol=1e-5, atol=1e-6)
        for n in shapes:
            close(tp[n], jp[n], rtol=1e-5, atol=1e-6)
            close(to.mu[n], js["mu"][n], rtol=1e-5, atol=1e-7)
            assert to.count[n] == int(js["count"][n])


def test_lr_and_momentum_schedules_match_jax():
    for lc in (dict(policy="step", step=[2, 4]),
               dict(policy="poly", power=0.9, min_lr=1e-5, max_iters=8),
               dict(policy="CosineAnnealing", min_lr_ratio=0.1, max_iters=8,
                    warmup="constant", warmup_iters=3),
               dict(policy="exp", gamma=0.9)):
        js, ts = jopt.make_lr_schedule(lc, 0.1), topt.make_lr_schedule(lc,
                                                                       0.1)
        for s in range(10):
            close(ts(s), js(s), rtol=1e-6, atol=1e-9)


def test_paramwise_multipliers_match_jax_paths():
    """The port's names (mm layout) pick the same custom_keys as the JAX
    paths they carry: each JAX leaf is tagged with its index, carried
    through ``state_dict_from_jax``, and every port parameter is checked
    against the multipliers of the JAX leaves it holds."""
    from rscotr_tpu.config import Config
    from rscotr_tpu.models import build_model as jax_build_model
    from rscotr_tpu_torch.models import build_model
    path = TINY
    jm = jax_build_model(Config.fromfile(path).model)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 32, 32, 3)),
        det_img=jnp.zeros((1, 64, 64, 3)),
        det_img_hw=jnp.array([[64, 64]], jnp.int32)), jax.random.key(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        shapes["params"])
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i, np.float32)
                  for i, (_, x) in enumerate(leaves)])
    keys = {"backbone": dict(lr_mult=0.1), "query_embed":
            dict(decay_mult=0.0), "level_embed": dict(decay_mult=0.0),
            "norm": dict(decay_mult=0.5), "relative_position_bias_table":
            dict(decay_mult=0.0), "sampling_offsets": dict(lr_mult=0.1)}
    jlr, jdc = jopt.paramwise_multipliers(tagged, keys)
    jlr, jdc = jax.tree.leaves(jlr), jax.tree.leaves(jdc)
    sd = state_dict_from_jax(tagged)
    model = build_model(__import__(
        "rscotr_tpu_torch.utils.config", fromlist=["x"]).load_model_cfg(path),
        tasks=("cls", "det"), device="meta")
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(sd)
    tlr, tdc = topt.paramwise_multipliers(names, keys)
    assert any(v == 0.5 for v in tdc.values())
    for n in names:
        for i in np.unique(sd[n].numpy()).astype(int):
            assert (tlr[n], tdc[n]) == (jlr[i], jdc[i]), n
    jnd = jax.tree.leaves(jopt.no_decay_for_norms_and_biases(
        tagged, jax.tree.map(lambda x: 1.0, tagged)))
    tnd = topt.no_decay_for_norms_and_biases(dict(model.named_parameters()),
                                             {n: 1.0 for n in names})
    for n in names:
        for i in np.unique(sd[n].numpy()).astype(int):
            assert tnd[n] == jnd[i], n
    jmask = jopt.task_param_masks(tagged)
    tmask = topt.task_param_masks(names)
    for task in ("cls", "det"):
        jm_leaves = jax.tree.leaves(jmask[task])
        for n in names:
            for i in np.unique(sd[n].numpy()).astype(int):
                assert tmask[task][n] == float(jm_leaves[i]), (task, n)


# ---------------------------------------------------------------------------
# drop path, dropout, cls batch augment
# ---------------------------------------------------------------------------

def test_drop_path_rates_match_jax():
    from rscotr_tpu.models.layers.common import \
        drop_path_rates as j_drop_path_rates
    assert drop_path_rates(0.2, (2, 2, 6, 2)) == \
        j_drop_path_rates(0.2, (2, 2, 6, 2))


def test_drop_path_and_dropout_modes():
    x = torch.ones(64, 3, 5)
    dp, do = DropPath(0.25), Dropout(0.25)
    dp.eval()
    do.eval()
    assert dp(x) is x and do(x) is x          # eval: identity
    assert DropPath(0.0).train()(x) is x      # rate 0: identity
    dp.train()
    do.train()
    a = dp(x, torch.Generator().manual_seed(1))
    b = dp(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)                  # the generator decides
    per_sample = a[:, 0, 0]
    assert ((a == per_sample[:, None, None]).all())
    kept = float(np.float32(1.0) / np.float32(0.75))
    assert set(per_sample.unique().tolist()) == {0.0, kept}
    d = do(x, torch.Generator().manual_seed(2))
    assert set(d.unique().tolist()) == {0.0, kept}
    with pytest.raises(ValueError, match="Generator"):
        dp(x)


@pytest.mark.parametrize("use_cutmix", [False, True])
def test_cls_batch_augment_equals_numpy_restatement(use_cutmix):
    """Given the same draws, the port's augment equals a numpy restatement
    of train_step.py:79-113, and its draws follow the same recipe."""
    rng = np.random.default_rng(60 + use_cutmix)
    B, H, W, C = 5, 16, 12, 7
    img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, C, B)
    draws = dict(perm=rng.permutation(B), lam_m=np.float32(0.3),
                 lam_c=np.float32(0.45), cx=9, cy=3, use_cutmix=use_cutmix)
    got_img, got_t = cls_batch_augment(t(img), t(labels), C, draws)

    one = np.eye(C, dtype=np.float32)[labels]
    perm = draws["perm"]
    lam_m = draws["lam_m"]
    img_m = lam_m * img + (np.float32(1) - lam_m) * img[perm]
    ratio = np.sqrt(np.float32(1) - draws["lam_c"])
    cw, ch = int(np.float32(W) * ratio), int(np.float32(H) * ratio)
    x1, x2 = np.clip(draws["cx"] - cw // 2, 0, W), np.clip(
        draws["cx"] + cw // 2, 0, W)
    y1, y2 = np.clip(draws["cy"] - ch // 2, 0, H), np.clip(
        draws["cy"] + ch // 2, 0, H)
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    in_box = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
    img_c = np.where(in_box[None, :, :, None], img[perm], img)
    lam_adj = np.float32(1) - np.float32((x2 - x1) * (y2 - y1)) / \
        np.float32(H * W)
    want_img = img_c if use_cutmix else img_m
    lam = lam_adj if use_cutmix else lam_m
    want_t = lam * one + (np.float32(1) - lam) * one[perm]
    close(got_img, want_img, rtol=1e-6, atol=1e-6)
    close(got_t, want_t, rtol=1e-6, atol=1e-6)
    # JAX's function on the same draws' mixup / cutmix branch agrees too
    jimg, jt = j_cls_augment(jax.random.key(0), jnp.asarray(img),
                             jnp.asarray(labels), C)
    assert jimg.shape == tuple(got_img.shape) and jt.shape == \
        tuple(got_t.shape)
    np.testing.assert_allclose(np.asarray(jt).sum(-1), 1.0, rtol=1e-6)


def test_cls_augment_draws_are_seeded():
    from rscotr_tpu_torch.engine.train_step import draw_cls_augment
    a = draw_cls_augment(torch.Generator().manual_seed(3), 6, 32, 24)
    b = draw_cls_augment(torch.Generator().manual_seed(3), 6, 32, 24)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert sorted(a["perm"].tolist()) == list(range(6))
    assert 0 <= a["cx"] < 24 and 0 <= a["cy"] < 32
    assert 0.0 <= a["lam_m"] <= 1.0 and 0.0 <= a["lam_c"] <= 1.0


def test_step_config_names_roadmap_for_unported():
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.utils.config import load_cfg
    from rscotr_tpu.apis import derive_device_aug as jax_derive_device_aug
    from rscotr_tpu.config import Config
    cfg = load_cfg(TINY)
    step_cfg = make_step_config(cfg)
    assert step_cfg.device_aug is None
    # on-device augmentation (ROADMAP M6, ported): the cls stage's
    # config, as JAX derives it, from a cls train pipeline
    cfg["data"]["resisc"]["loader"]["cls_device_augment"] = True
    cfg["data"]["resisc"]["data"]["train"]["pipeline"] = [
        dict(type="RandomResizedCrop", size=128),
        dict(type="RandAugment", num_policies=3),
        dict(type="RandomErasing", fill_color=[1, 2, 3]),
        dict(type="Normalize", mean=[1, 2, 3], std=[4, 5, 6])]
    got = make_step_config(cfg).device_aug
    want = jax_derive_device_aug(Config.fromdict(cfg))
    assert got is not None and got.num_policies == 3
    assert make_step_config(cfg).img_norm == ((1, 2, 3), (4, 5, 6))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # seg training is ported: the step builds; an unknown task is refused
    model = torch.nn.Linear(1, 1)
    assert callable(make_train_step(model, None, "seg", step_cfg))
    with pytest.raises(ValueError, match="unknown task"):
        make_train_step(model, None, "depth", step_cfg)
