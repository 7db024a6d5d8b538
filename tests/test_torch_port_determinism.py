"""``--deterministic`` in the port (ROADMAP C17): what the CPU can show.

``set_random_seed(seed, deterministic=True)`` (``tools/train.py
--deterministic``) turns on ``torch.use_deterministic_algorithms``. K1b and
K2b read it at call time: their body picks (``msda_bwd_body``,
``bias_partials``) then return the ordered bodies, whose sums run in an
order that the data fixes instead of by f32 atomics. The kernels run only
on the card, so the ``cuda`` cases (two calls of each ordered body
bit-equal and within the kernels' tolerances of the plain versions, and
the flagship's det step under the flag) skip here; on the card run them
with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_determinism.py`` (JAX is imported only inside the
one test that compares with it). ``chip_smoke.py`` holds two
``--deterministic`` 12-step flagship runs bit-equal at every step.

The seg loss's antialiased shrink (``resize_linear``) takes two matrix
products under the flag (``ops.resize.resize_matmul``): on the card the
flag refuses the backward of ``F.interpolate``'s antialiased mode, and not
its plain bilinear backward, so the pixel decoder's ``_interpolate`` keeps
``F.interpolate``. Tolerance against ``F.interpolate``, forward and
gradient, float32: 2e-6 absolute plus 2e-6 relative (the same sums in
another order, the weights rounded to float32 once).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rscotr_tpu_torch.engine.infer import resize_linear
from rscotr_tpu_torch.models.heads.pixel_decoders import _interpolate
from rscotr_tpu_torch.ops import kernel_lib, resize
from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE, BODY_VEC, ORDERED
from rscotr_tpu_torch.ops.ms_deform_attn import msda_bwd_body
from rscotr_tpu_torch.ops.window_attention import (bias_partials,
                                                   tensor_core_plan)
from rscotr_tpu_torch.utils.rng import CUBLAS_WORKSPACE_CONFIG, \
    set_random_seed

ATOL = RTOL = 2e-6


@pytest.fixture
def switches(monkeypatch):
    """Every switch ``set_random_seed(deterministic=True)`` turns, restored
    after the test (the variable unset for it)."""
    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
            cudnn.benchmark)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    yield
    torch.use_deterministic_algorithms(prev[0])
    cudnn.deterministic, cudnn.benchmark = prev[1:]


# ---------------------------------------------------------------------------
# the switch and the body picks
# ---------------------------------------------------------------------------

def test_set_random_seed_sets_every_switch(switches, monkeypatch):
    set_random_seed(0)
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    set_random_seed(0, deterministic=True)
    assert torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_WORKSPACE_CONFIG
    # a caller's own setting stays
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    set_random_seed(0, deterministic=True)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("head_dim,ptrs,body", [
    (32, [0, 256, 4096], BODY_VEC), (16, [], BODY_VEC),
    (64, [512], BODY_VEC), (32, [8], BODY_LANE), (24, [], BODY_LANE)])
def test_k1b_pick_follows_the_flag(switches, on, head_dim, ptrs, body):
    torch.use_deterministic_algorithms(on)
    assert kernel_lib.ordered_sums() is on
    assert msda_bwd_body(head_dim, ptrs) == body | (ORDERED if on else 0)


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("shape,dtype", [
    ((1, 841, 3, 49, 32), torch.bfloat16),    # det 800^2 stage 0: tensor cores
    ((16, 64, 3, 49, 32), torch.bfloat16),    # cls 224^2 stage 0
    ((2, 9, 3, 49, 24), torch.bfloat16),      # CUDA-core instantiation
    ((1, 841, 3, 49, 32), torch.float32)])
def test_k2b_pick_follows_the_flag(switches, on, shape, dtype):
    """Under the flag K2b sums d_rel_bias from one partial a block, in
    block order: ceil(B nW / run) a head on the tensor cores, B nW on the
    CUDA cores; 0 (the atomics) without it."""
    torch.use_deterministic_algorithms(on)
    B, nW, H, n, hd = shape
    strides = [n * hd * H, n * hd, hd] * 3
    run = tensor_core_plan("bwd", dtype, shape, strides, [0, 256, 512])
    assert (run > 0) == (dtype == torch.bfloat16 and hd == 32)
    want = (-(-B * nW // run) if run else B * nW) if on else 0
    assert bias_partials(shape, run) == want


def test_a_forced_body_keeps_the_picks_order(switches):
    """``take_body``: a tool may force the lane body; the ordered flag stays
    the pick's, and the vector body is never forced where it is refused."""
    assert kernel_lib.take_body("k", BODY_LANE, BODY_VEC | ORDERED,
                                "w") == BODY_LANE | ORDERED
    assert kernel_lib.take_body("k", BODY_VEC, BODY_VEC | ORDERED,
                                "w") == BODY_VEC | ORDERED
    assert kernel_lib.take_body("k", None, BODY_LANE | ORDERED,
                                "w") == BODY_LANE | ORDERED
    assert kernel_lib.take_body("k", BODY_LANE, BODY_VEC, "w") == BODY_LANE
    with pytest.raises(ValueError, match="base addresses"):
        kernel_lib.take_body("k", BODY_VEC, BODY_LANE | ORDERED, "w")


def test_k3_refuses_the_flag(switches):
    """K3' (the quad-gather path's scatter, off the training path) has no
    ordered body: under the flag its wrapper raises, as torch's own
    operators without a deterministic implementation do."""
    kernel_lib.refuse_nondeterministic("scatter_add_mm (K3')")
    torch.use_deterministic_algorithms(True)
    with pytest.raises(RuntimeError, match="no deterministic body"):
        kernel_lib.refuse_nondeterministic("scatter_add_mm (K3')")


# ---------------------------------------------------------------------------
# the bilinear resizes as matrix products
# ---------------------------------------------------------------------------

RESIZES = [
    ((5, 7), (40, 56)),      # up, integer ratio (the widening void)
    ((4, 6), (13, 9)),       # up, non-integer
    ((40, 56), (5, 7)),      # down, integer ratio (the seg loss)
    ((13, 9), (4, 6)),       # down, non-integer
    ((512, 512), (128, 128)),   # the flagship's seg loss, 4x down
    ((8, 8), (6, 20)),       # one axis shrinks, one grows
    ((10, 30), (7, 30)),     # one axis kept
]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matmul_equals_interpolate(src, dst):
    """Forward and gradient of ``resize_matmul`` against ``F.interpolate``
    with ``antialias=True`` on the same NCHW input."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3) + src).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3) + dst).astype(np.float32))
    outs, grads = [], []
    for fn in (lambda t: F.interpolate(t, size=dst, mode="bilinear",
                                       align_corners=False,
                                       antialias=True),
               lambda t: resize.resize_matmul(t, dst)):
        xi = x.clone().requires_grad_()
        y = fn(xi)
        (y * g).sum().backward()
        outs.append(y.detach())
        grads.append(xi.grad)
    for got, want in ((outs[1], outs[0]), (grads[1], grads[0])):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("src,dst", [((64, 48), (16, 12)),
                                     ((48, 64), (16, 40))])
def test_resize_linear_bf16_under_the_flag(switches, src, dst):
    """The seg loss's bf16 logits: ``resize_linear`` resizes them in
    float32 under the flag as without it. The absolute tolerance scales
    with the input's largest magnitude (a non-integer ratio sums about ten
    rounded float32 weights times inputs up to ~4)."""
    torch.use_deterministic_algorithms(True)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2,) + src + (4,)).astype(np.float32)).bfloat16()
    got = resize_linear(x, dst)
    want = F.interpolate(x.float().permute(0, 3, 1, 2), size=dst,
                         mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL * x.float().abs().max().item())


def test_linear_weights_rows():
    """Each row sums to 1; upsampling takes two neighbours, halving four
    (the widened triangle), quartering eight."""
    up = resize.linear_weights(4, 9)
    half = resize.linear_weights(8, 4)
    quarter = resize.linear_weights(16, 4)
    for m in (up, half, quarter):
        assert m.dtype == torch.float32
        np.testing.assert_allclose(m.sum(1).numpy(), 1.0, rtol=1e-6)
    assert (up > 0).sum(1).max().item() == 2
    assert (half > 0).sum(1).tolist() == [3, 4, 4, 3]
    assert (quarter > 0).sum(1).tolist() == [6, 8, 8, 6]


@pytest.mark.parametrize("on", [False, True])
def test_the_resizes_take_the_products_under_the_flag(switches, on):
    """``resize_linear`` (NHWC, antialiased where it shrinks) is
    ``resize_matmul`` bit for bit where it shrinks under the flag, and
    ``F.interpolate`` without it; its upsampling and the pixel decoder's
    ``_interpolate`` (NCHW, no antialiasing) are ``F.interpolate`` either
    way (the flag does not refuse the plain bilinear backward)."""
    torch.use_deterministic_algorithms(on)
    rng = np.random.default_rng(2)
    nhwc = torch.from_numpy(rng.normal(size=(2, 24, 20, 3)).astype(
        np.float32))
    nchw = nhwc.permute(0, 3, 1, 2)
    for dst in ((6, 5), (48, 40)):
        aa = dst[0] < 24
        got = resize_linear(nhwc, dst).permute(0, 3, 1, 2)
        want = resize.resize_matmul(nchw, dst) if on and aa else \
            F.interpolate(nchw, size=dst, mode="bilinear",
                          align_corners=False, antialias=aa)
        assert torch.equal(got, want)
        got = _interpolate(nchw, dst)
        want = F.interpolate(nchw, size=dst, mode="bilinear",
                             align_corners=False)
        assert torch.equal(got, want)


@pytest.mark.parametrize("src,dst", [((40, 56), (5, 7)), ((5, 7), (40, 56)),
                                     ((8, 8), (6, 20))])
def test_resize_linear_under_the_flag_matches_jax(switches, src, dst):
    """Under the flag the seg loss's resize still computes
    ``jax.image.resize(method="linear")``."""
    import jax
    import jax.numpy as jnp
    torch.use_deterministic_algorithms(True)
    x = np.random.default_rng(0).normal(size=(2,) + src + (3,)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,),
                            method="linear")
    got = resize_linear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the train tool with --deterministic
# ---------------------------------------------------------------------------

def test_train_cli_deterministic_reaches_the_steps(switches, tmp_path):
    """``tools/train.py --deterministic`` on the tiny config (cls, det, seg
    on the CPU): every step runs with the flag on, so the kernels' picks
    would take the ordered bodies, and no op on the CPU path refuses it."""
    from rscotr_tpu_torch.engine.hooks import Hook
    from rscotr_tpu_torch.tools import train as train_cli

    seen = []

    class Flag(Hook):
        def after_train_iter(self, runner):
            seen.append((next(k for k in runner.log_vars
                              if k.endswith(".loss")).split(".")[0],
                         torch.are_deterministic_algorithms_enabled(),
                         kernel_lib.ordered_sums(),
                         msda_bwd_body(32, [0]) & ORDERED))

    runner = train_cli.main(
        ["configs/multi/MTL_tiny_synthetic.py", "--work-dir",
         str(tmp_path), "--max-iters", "3", "--no-validate", "--device",
         "cpu", "--deterministic"], hooks=[Flag()])
    assert runner.step == 3
    assert [s[1:] for s in seen] == [(True, True, ORDERED)] * 3
    assert {s[0] for s in seen} == {"cls", "det", "seg"}
    assert all(np.isfinite(float(v)) for v in runner.log_vars.values())


# ---------------------------------------------------------------------------
# on the card (skip here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


# the kernels' tolerances against their plain versions (chip_smoke's BTOL)
BTOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2.0 ** -7)}


def _assert_grad_close(got, ref, dtype, slack=0):
    atol, rtol = BTOL[dtype]
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    bound = atol * ref.abs().max().item() + rtol * ref.abs() + slack
    assert ((got - ref).abs() - bound).max().item() <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,span", [(16, (-0.2, 1.2)), (24, (-0.2, 1.2)),
                                    (32, (0.0, 1.0)), (64, (-0.2, 1.2))])
def test_ordered_k1b_repeats_bit_for_bit(cuda_device, switches, dtype, D,
                                         span):
    """Two calls of K1b's ordered body (vector walk for D 16 / 32 / 64,
    lane walk for 24) give the same bits, within K1b's tolerance of the
    plain backward."""
    from rscotr_tpu_torch.ops.ms_deform_attn import (
        _msda_bwd_cuda, ms_deform_attn_bwd_torch)
    g = torch.Generator(cuda_device).manual_seed(D)
    shapes = ((12, 16), (6, 8), (3, 4), (2, 2))
    B, Q, H, P, L = 2, 300, 4, 4, len(shapes)
    Nv = sum(h * w for h, w in shapes)
    v = torch.randn(B, Nv, H, D, device=cuda_device, generator=g).to(dtype)
    loc = torch.rand(B, Q, H, L, P, 2, device=cuda_device, generator=g) * (
        span[1] - span[0]) + span[0]
    w = torch.rand(B, Q, H, L, P, device=cuda_device, generator=g)
    w = (w / w.sum((-1, -2), keepdim=True)).to(dtype)
    d_out = torch.randn(B, Q, H * D, device=cuda_device, generator=g).to(
        dtype)
    torch.use_deterministic_algorithms(True)
    first = _msda_bwd_cuda(v, shapes, loc, w, d_out)
    second = _msda_bwd_cuda(v, shapes, loc, w, d_out)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    want = ms_deform_attn_bwd_torch(v, shapes, loc, w, d_out)
    for got, ref in zip((first[0].to(dtype), first[1], first[2]), want):
        _assert_grad_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,masked", [(32, True), (32, False), (24, True)])
def test_ordered_k2b_repeats_bit_for_bit(cuda_device, switches, dtype, hd,
                                         masked):
    """Two calls of K2b's ordered body give the same bits; d_rel_bias
    within K2b's tolerance of the plain version (dq, dk, dv are the
    default body's, one writer each)."""
    from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
    from rscotr_tpu_torch.ops.window_attention import (
        _window_attention_bwd_cuda, window_attention_bwd_torch)
    g = torch.Generator(cuda_device).manual_seed(hd)
    B, nW, H, n = 2, 64, 3, 49
    q, k, v, d_out = (torch.randn(B, nW, H, n, hd, device=cuda_device,
                                  generator=g).to(dtype) for _ in range(4))
    bias = torch.randn(H, n, n, device=cuda_device, generator=g)
    mask = torch.as_tensor(_shift_attn_mask(56, 56, 7, 3)).to(
        cuda_device) if masked else None
    scale = hd ** -0.5
    args = (q, k, v, bias, mask, scale, d_out)
    torch.use_deterministic_algorithms(True)
    first = _window_attention_bwd_cuda(*args)
    second = _window_attention_bwd_cuda(*args)
    torch.use_deterministic_algorithms(False)
    default = _window_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first[:3], default[:3]))
    want = window_attention_bwd_torch(q, k, v, bias, mask, scale, d_out)
    _assert_grad_close(first[3], want[3], dtype)


@pytest.mark.cuda
def test_flagship_det_step_under_the_flag(cuda_device, switches):
    """Three flagship det steps (800^2, 200 DN + 600 queries) under
    ``set_random_seed(deterministic=True)``: no op refuses the mode, and
    every K1b / K2b launch takes its ordered body."""
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn_bwd
    from rscotr_tpu_torch.ops.window_attention import window_attention_bwd
    from rscotr_tpu_torch.tools.profile_train import det_batch
    from rscotr_tpu_torch.utils.config import load_cfg
    set_random_seed(0, deterministic=True)
    cfg = load_cfg("configs/multi/MTL_synthetic_flagship.py")
    model = build_model(cfg["model"], device=cuda_device,
                        generator=torch.Generator().manual_seed(0))
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=cfg["lr_config"],
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    masks = task_param_masks(n for n, _ in model.named_parameters())
    step = make_train_step(model, opt, "det", make_step_config(cfg),
                           masks["det"])
    batch = det_batch(np.random.default_rng(0))
    gen = torch.Generator().manual_seed(0)
    before = (ms_deform_attn_bwd.ordered_launches,
              window_attention_bwd.ordered_launches)
    for _ in range(3):
        lv = step(batch, gen)
        assert all(np.isfinite(float(x)) for x in lv.values())
    assert (ms_deform_attn_bwd.ordered_launches - before[0],
            window_attention_bwd.ordered_launches - before[1]) == (36, 36)
