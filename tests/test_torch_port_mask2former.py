"""Mask2Former semantic segmentation on the port (``Mask2FormerHead``
scheme 3 in ``RSCoTrSeg``, the seg entry of ``make_infer_steps``) against
the benchmark's plain reference (``bench_h100/reference/mask2former.py``),
on seeded random weights at a small width with Swin's window 12 kept, so
that the plain K2 path runs at n = 144; the published order of the
semantic step; the full configuration's parameters; K2's plan at n = 49,
64, 100 and 144; and, on the card, the long-window body against its plain
version."""

import json
import os

import numpy as np
import pytest
import torch

from bench_h100 import weights
from bench_h100.reference import mask2former as ref
from rscotr_tpu_torch.engine import make_infer_steps
from rscotr_tpu_torch.engine.train_step import TrainStepConfig, seg_loss_fn
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.models.heads.mask2former_head import (Mask2FormerHead,
                                                            SemanticInference)
from rscotr_tpu_torch.ops import window_attention as wa
from rscotr_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "bench_h100/tests/data/m2f_tiny.json")
FULL = os.path.join(ROOT, "bench_h100/configs/mask2former_swin_l.json")
F32 = ref.Precision("f32")
# float32 on the CPU, the same operations in another order: sums of a few
# hundred products of O(1) terms agree to about 1e-5 of their size
ATOL = 2e-5


def _tiny_cfg():
    with open(TINY) as f:
        return json.load(f)["model"]


def _model(cfg, seed):
    model = build_model(cfg, device="cpu")
    P = weights.make([(n, tuple(p.shape)) for n, p in model.named_parameters()],
                     seed, "cpu")
    weights.load(model, P)
    return model, P


def _record(model):
    """Hooks that keep each decoder layer's attention mask (one head's), and
    every prediction head's mask logits, of the next call."""
    head = model.seg_head
    got = {"masks": [], "logits": []}
    heads = head.num_heads

    def layer(_m, _a, kw):
        am = kw["cross_attn_mask"]
        got["masks"].append(am.reshape(-1, heads, *am.shape[1:])[:, 0].clone())

    def outputs(_m, _i, out):
        got.setdefault("cls", out[0].clone())

    for lay in head.transformer_decoder.layers:
        lay.register_forward_pre_hook(layer, with_kwargs=True)
    head.register_forward_hook(outputs)
    real = head._forward_head

    def forward_head(q, feature, hw):
        seg, am = real(q, feature, hw)
        got["logits"].append(seg.clone())
        return seg, am
    head._forward_head = forward_head
    return got


def _pixels(seed, B=2, H=96, W=96):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_port_matches_the_reference(seed):
    cfg = _tiny_cfg()
    model, P = _model(cfg, seed)
    got = _record(model)
    steps = make_infer_steps(model)
    x = _pixels(seed)
    scores = steps["seg_logits"](x)
    labels = steps["seg"](x)
    layers = cfg["decode_head"]["transformer_decoder"]["num_layers"]
    masks = got["masks"][:layers]
    r = ref.forward(torch.from_numpy(x), P, cfg, F32, masks)
    # every layer's attention mask is the one the reference makes itself
    assert all(torch.equal(m, o) for m, o in zip(masks, r["own_masks"]))
    for a, b in zip(got["logits"][:layers + 1], r["layer_logits"]):
        assert torch.allclose(a, b, atol=ATOL * b.abs().max(), rtol=0)
    assert torch.allclose(got["cls"].softmax(-1),
                          r["cls_logits"].softmax(-1), atol=1e-6)
    want = ref.semantic(r["cls_logits"], r["mask_logits"], x.shape[1:3], F32)
    assert scores.shape == want.shape == (2, 96, 96, 7)
    assert torch.allclose(scores, want, atol=1e-5)
    # labels: the reference's argmax wherever its top two scores are apart
    top = want.topk(2, -1).values
    clear = (top[..., 0] - top[..., 1]) > 1e-4
    assert torch.equal(labels[clear], want.argmax(-1)[clear])
    assert torch.equal(labels, scores.argmax(-1))


def test_all_blocked_rows_attend_everywhere():
    """A mask feature of ones makes each query's mask logits one constant,
    so a query whose constant is negative blocks every key: Mask2Former
    resets such a row to attend everywhere, in the program and in the
    reference alike."""
    cfg = _tiny_cfg()
    model, P = _model(cfg, 11)
    for name in ("weight", "bias"):
        p = getattr(model.seg_head.pixel_decoder.mask_feature, name)
        P[f"seg_head.pixel_decoder.mask_feature.{name}"] = \
            torch.zeros_like(p) if name == "weight" else torch.ones_like(p)
    weights.load(model, P)
    got = _record(model)
    x = _pixels(4)
    make_infer_steps(model)["seg"](x)
    layers = cfg["decode_head"]["transformer_decoder"]["num_layers"]
    first = got["logits"][0]
    blocked = (first.flatten(2).sigmoid() < 0.5).all(-1)
    assert blocked.any() and not blocked.all()
    # the reset rows attend everywhere in the program's mask
    assert not got["masks"][0][blocked].any()
    r = ref.forward(torch.from_numpy(x), P, cfg, F32)
    assert all(torch.equal(m, o)
               for m, o in zip(got["masks"][:layers], r["own_masks"]))


def test_semantic_step_upsamples_before_the_sigmoid():
    """The published order (upsample the logits, then the sigmoid) is what
    runs; the sigmoid first and then the upsampling gives other scores."""
    g = torch.Generator().manual_seed(0)
    cls = torch.randn(2, 5, 4, generator=g)
    masks = torch.randn(2, 5, 6, 6, generator=g) * 4
    got = SemanticInference()(cls, masks, (24, 24))
    want = ref.semantic(cls, masks, (24, 24), F32)
    assert got.shape == (2, 24, 24, 3)
    assert torch.allclose(got, want, atol=1e-6)
    probs = cls.softmax(-1)[..., :-1]
    up = torch.nn.functional.interpolate(masks.sigmoid(), size=(24, 24),
                                         mode="bilinear", align_corners=False)
    other = torch.einsum("bqk,bqhw->bhwk", probs, up)
    assert (other - got).abs().max() > 1e-2


def test_full_configuration_builds_with_the_references_parameters():
    with open(FULL) as f:
        cfg = json.load(f)["model"]
    model = build_model(cfg, device="meta")
    head = model.seg_head
    assert isinstance(head, Mask2FormerHead) and head.scheme == 3
    assert head.pixel_decoder.input_convs is not None
    assert model.backbone.stages[0].blocks[1].attn.w_msa.window_size == 12
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == ref.parameter_shapes(cfg)
    assert sum(int(np.prod(s)) for s in got.values()) == 215_488_779


def test_scheme_3_serves_only():
    cfg = _tiny_cfg()
    model = build_model(cfg, device="cpu")
    batch = {"img": torch.zeros(1, 96, 96, 3),
             "gt_semantic_seg": torch.zeros(1, 96, 96, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="scheme 3"):
        seg_loss_fn(model, batch, None, TrainStepConfig({"seg": 1.0}),
                    train=False)


def test_seg_request_spans():
    from torch.profiler import ProfilerActivity, profile
    model = build_model(_tiny_cfg(), device="cpu")
    fn = make_infer_steps(model)["seg"]
    x = _pixels(1, B=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(x)
    names = [e.name() for e in sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.name().startswith("rscotr.")), key=lambda e: e.start_ns())]
    assert names == [trace.REQUEST_SEG, trace.INPUT, trace.BACKBONE,
                     trace.SEG_PIXEL_DECODER, trace.ENCODER,
                     trace.SEG_DECODER, trace.SEG_SEMANTIC,
                     trace.SEG_SEMANTIC]


def _plan(n, kind="fwd", B=16, nW=16, H=24, hd=32):
    st = [n * 3 * H * hd, hd, 3 * H * hd] * 3
    ptrs = [4096, 4096 + 2 * H * hd, 4096 + 4 * H * hd]
    return wa.tensor_core_plan(kind, torch.bfloat16, (B, nW, H, n, hd), st,
                               ptrs)


def test_tensor_core_plan_by_window():
    """n <= 64 takes the tensor-core body as it did (windows of a block:
    16 * 16 * 24 tiles over 132 SMs x 4 resident blocks at n = 49, 3 at
    n = 64), 64 < n <= 144 the long-window body (images of a block: 384
    (window, head) pairs fill the SMs four times in two runs of 8), K2b and
    n > 144 the CUDA cores."""
    assert (_plan(49), _plan(64)) == (12, 16)
    assert (_plan(49, "bwd"), _plan(64, "bwd")) == (24, 24)
    assert _plan(100) == _plan(144) == 8
    assert _plan(144, nW=196, H=6) == 16       # Swin-L stage 1: one run
    assert _plan(144, nW=4, H=48) == 6         # stage 4: three runs
    assert _plan(100, "bwd") == _plan(144, "bwd") == 0
    assert _plan(169) == 0
    assert _plan(144, hd=64) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 144])
@pytest.mark.parametrize("masked", [False, True])
def test_long_window_body_matches_plain_on_card(n, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the long-window body runs only "
                    "on the card")
    from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
    g = torch.Generator(device="cuda").manual_seed(n)
    w = int(round(n ** 0.5))
    B, nW, H, hd = 3, 16, 5, 32
    q, k, v = (torch.randn(B, nW, H, n, hd, device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.randn(H, n, n, device="cuda", generator=g) * 0.5
    mask = torch.as_tensor(_shift_attn_mask(4 * w, 4 * w, w, w // 2),
                           device="cuda") if masked else None
    before = wa.window_attention.tc144_launches
    got = wa.window_attention(q, k, v, bias, mask)
    assert wa.window_attention.tc144_launches == before + 1
    want = wa.window_attention_torch(q, k, v, bias, mask)
    # bf16 outputs, P rounded to bf16 at the same place in both: a few
    # outputs may differ where a P entry lies on a rounding boundary
    err = (got.float() - want.float()).abs()
    assert err.max() < 2e-2
    assert (err > 1e-3 + 2 ** -7 * want.float().abs()).float().mean() < 1e-3
