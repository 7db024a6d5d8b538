"""The LayerNorm forward K7 (``rscotr_tpu_torch/ops/layer_norm.py``,
``csrc/layer_norm.cu``) and the modules that call it.

CPU cases hold the plain version, which the CPU runs where autograd records
nothing, against ``F.layer_norm(x.float())``, the formula ``LayerNorm`` had
before K7 and still runs under autograd; the modules' no-grad outputs
against that formula; their training outputs and gradients bit for bit;
and the operator under ``torch.export``. The ``cuda`` cases (skipped
without a card) hold K7 against the plain version and count its launches
per serving request. No JAX here: the ``cuda`` cases run on the card with
``--noconftest``.

Tolerances:
* float32 outputs, plain version or K7 against ``F.layer_norm`` / the plain
  version: 1e-5 relative and absolute. The statistics are float32 sums
  taken in other orders, and ``rsqrt`` is rounded differently (CUDA's
  ``rsqrtf`` is within 2 ulp): a few float32 ulps of outputs of order 1-10.
* bfloat16 outputs: within one bf16 ulp of the plain version's, since two
  float32 values a few ulps apart round to neighbouring bf16 values where
  they straddle a rounding boundary, plus the float32 bound above: an
  output near 0 is the difference of the affine terms, and their float32
  rounding error is larger than its bf16 ulp.
* modules without autograd, float32: 1e-5 relative and absolute (the norms'
  float32 differences carried through the block). bfloat16: the norms'
  bf16 outputs may lie one ulp apart (above), and each such flip moves a
  bf16 product by at most 2^-8 of one term; the block output is held to
  2^-6 of its largest entry, far under what a wrong statistic, weight or
  dtype moves (order 1).
"""

import copy
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rscotr_tpu_torch.models.backbones.swin import PatchMerging, SwinBlock
from rscotr_tpu_torch.models.layers import common
from rscotr_tpu_torch.models.layers.common import LayerNorm, init_weights
from rscotr_tpu_torch.models.layers.transformer import DeformableEncoderLayer
from rscotr_tpu_torch.ops import layer_norm as ln

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")
# the main path's widths: Swin-T's stages and 4C merging norms, the neck
WIDTHS = (96, 192, 384, 768, 1536, 256)
TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = ((16, 16), (8, 8))   # the encoder layer's levels


def parent_forward(self, x):
    """``LayerNorm.forward`` before K7: float32 in and out, autograd or
    not."""
    return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                        self.bias, self.eps)


def rows(n, C, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, C, generator=g) * 3 + torch.randn(n, 1, generator=g)
    w = torch.randn(C, generator=g)
    b = torch.randn(C, generator=g)
    return (x.to(dtype).to(device), w.to(device), b.to(device))


def bf16_ulp(ref):
    """One bf16 ulp of each (bf16-representable) entry of ``ref``."""
    _, e = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def assert_within_ulp(got, ref):
    assert got.dtype == torch.bfloat16 and ref.dtype == torch.bfloat16
    diff = (got.float() - ref.float()).abs()
    allow = bf16_ulp(ref) + TOL["atol"] + TOL["rtol"] * ref.float().abs()
    assert bool((diff <= allow).all()), (diff - allow).max().item()


def randomize(module, seed):
    """Initialise ``module`` and redraw its norms' weights and biases."""
    g = torch.Generator().manual_seed(seed)
    init_weights(module, g)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, LayerNorm):
                m.weight.copy_(1 + 0.3 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=g))
    return module


@pytest.fixture
def parent_norms(monkeypatch):
    """A context in which every ``LayerNorm`` computes the parent's
    formula."""
    def use():
        monkeypatch.setattr(common.LayerNorm, "forward", parent_forward)
    return use


# ---------------------------------------------------------------------------
# the plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", WIDTHS)
def test_plain_matches_f_layer_norm(C, dtype):
    x, w, b = rows(300, C, dtype, seed=C)
    want = F.layer_norm(x.float(), (C,), w, b, 1e-5)
    got = ln.layer_norm_torch(x, w, b, 1e-5)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)
    # the bf16 output is the f32 result rounded to nearest even
    got16 = ln.layer_norm_torch(x, w, b, 1e-5, torch.bfloat16)
    assert torch.equal(got16, got.to(torch.bfloat16))
    # the CPU dispatch and the operator are the plain version
    assert torch.equal(ln.layer_norm(x, w, b, 1e-5, torch.bfloat16), got16)
    assert torch.equal(torch.ops.rscotr_torch.layer_norm_fwd(
        x, w, b, 1e-5, False), got)


def test_plain_statistics_are_two_pass():
    """A large mean over a small spread: E[x^2] - mean^2 in float32 would
    lose the variance; the mean of squared deviations keeps it."""
    C = 96
    x = 1000.0 + torch.linspace(-1, 1, C).repeat(4, 1)
    w, b = torch.ones(C), torch.zeros(C)
    got = ln.layer_norm_torch(x, w, b)
    want = F.layer_norm(x.double(), (C,), eps=1e-5).float()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("C,dtype,want", [
    (96, torch.float32, (8, 3)), (96, torch.bfloat16, (4, 3)),
    (192, torch.float32, (16, 3)), (384, torch.float32, (32, 3)),
    (768, torch.float32, (32, 6)), (1536, torch.float32, (32, 12)),
    (1536, torch.bfloat16, (32, 6)), (256, torch.float32, (32, 2)),
    (256, torch.bfloat16, (32, 1)), (32, torch.float32, (8, 1)),
    (36, torch.float32, None), (6, torch.float32, None),
    (4096, torch.float32, None)])
def test_plan(C, dtype, want):
    """Lanes a row and chunks a lane, as csrc/layer_norm.cu picks them."""
    assert ln.plan(C, dtype) == want


def test_layer_norm_refuses():
    x, w, b = rows(4, 96, torch.float32, 0)
    with pytest.raises(TypeError, match="out_dtype"):
        ln.layer_norm(x, w, b, 1e-5, torch.float16)
    with pytest.raises(ValueError, match="no path"):
        ln.layer_norm(x.to("meta"), w.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# the modules


def swin_block(dtype, seed=0):
    return randomize(SwinBlock(96, 3, 7, shift=3, dtype=dtype), seed).eval()


def encoder_layer(dtype, seed=0):
    return randomize(DeformableEncoderLayer(
        64, 4, len(SHAPES), 2, 128, dtype=dtype), seed).eval()


def encoder_inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    N = sum(h * w for h, w in SHAPES)
    x = torch.randn(2, N, 64, generator=g)
    pos = torch.randn(2, N, 64, generator=g)
    ref = torch.rand(2, N, len(SHAPES), 2, generator=g)
    return x, pos, ref


def run_block(block, x):
    return block(x)


def run_encoder(layer, inputs):
    x, pos, ref = inputs
    return layer(x, pos, ref, SHAPES)


def module_case(kind, dtype):
    if kind == "swin":
        x = torch.randn(2, 14, 14, 96, generator=torch.Generator(
        ).manual_seed(1))
        return swin_block(dtype), run_block, x
    return encoder_layer(dtype), run_encoder, encoder_inputs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["swin", "encoder"])
def test_module_no_grad_matches_parent(kind, dtype, parent_norms):
    module, run, inputs = module_case(kind, dtype)
    with torch.no_grad():
        got = run(module, inputs)
    parent_norms()
    with torch.no_grad():
        want = run(module, inputs)
    assert got.dtype == want.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 2.0 ** -6 * scale


def test_swin_norms_round_to_the_block_dtype():
    """``norm1``, ``norm2`` and the merging norm return the block's bf16
    compute dtype (their readers are bf16 products), with and without
    autograd; every other norm returns float32."""
    block = swin_block(torch.bfloat16)
    merge = PatchMerging(96, dtype=torch.bfloat16)
    x = torch.randn(2, 14, 14, 96)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            assert block.norm1(x).dtype == torch.bfloat16
            assert block.norm2(x).dtype == torch.bfloat16
            assert merge.norm(torch.randn(2, 7, 7, 384)).dtype == \
                torch.bfloat16
            assert swin_block(torch.float32).norm1(x).dtype == torch.float32
            assert encoder_layer(torch.bfloat16).norms[0](
                torch.randn(2, 5, 64)).dtype == torch.float32


def grads_of(module, run, inputs, seed=2):
    """Training-mode output and the gradients of a fixed projection of it
    for the input and every parameter."""
    module = module.train()
    first = inputs if torch.is_tensor(inputs) else inputs[0]
    first = first.clone().requires_grad_(True)
    args = first if torch.is_tensor(inputs) else (first,) + inputs[1:]
    out = run(module, args)
    proj = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed))
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad((out.float() * proj).sum(),
                                (first,) + params)
    return out, dict(zip(("input",) + names, grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["swin", "encoder", "merging"])
def test_module_training_bit_equal_to_parent(kind, dtype, parent_norms):
    """Under autograd the modules run F.layer_norm: values and gradients
    bit-equal to the parent's, the bf16 rounding of norm1 / norm2 / the
    merging norm moved from the reader's cast into the norm."""
    if kind == "merging":
        module = randomize(PatchMerging(96, dtype=dtype), 0)
        run, inputs = (lambda m, x: m(x)), torch.randn(2, 14, 14, 96)
    else:
        module, run, inputs = module_case(kind, dtype)
    twin = copy.deepcopy(module)
    out, grads = grads_of(module, run, inputs)
    parent_norms()
    want, want_grads = grads_of(twin, run, inputs)
    assert out.dtype == want.dtype and torch.equal(out, want)
    assert grads.keys() == want_grads.keys()
    for k in grads:
        assert torch.equal(grads[k], want_grads[k]), k


# ---------------------------------------------------------------------------
# the operator under torch.export


class _Norms(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = LayerNorm(96, out_dtype=torch.bfloat16)
        self.b = LayerNorm(96)

    def forward(self, x):
        return self.a(x).float() + self.b(x)


def test_operator_opcheck():
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = rows(10, 96, dtype, 3)
        for bf16_out in (False, True):
            torch.library.opcheck(torch.ops.rscotr_torch.layer_norm_fwd
                                  .default, (x, w, b, 1e-5, bf16_out))


def test_export_holds_the_operator_and_runs_on_cpu():
    m = randomize(_Norms(), 4).eval()
    x = torch.randn(3, 5, 96)
    with torch.no_grad():
        want = m(x)
        program = torch.export.export(m, (x,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("rscotr_torch.layer_norm_fwd.default") == 2
    assert not any("layer_norm" in t and "rscotr" not in t for t in targets)
    got = program.module()(x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K7 on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


# (rows, C, input dtype): cls stage 1 (256 x 56^2) and the patch embedding's
# bf16 input, the later stages and merging norms, the det encoder (16 x
# 13,294) and the decoder (16 x 600), and ragged and small row counts
K7_CASES = [(802816, 96, torch.float32), (802816, 96, torch.bfloat16),
            (200704, 192, torch.float32), (200704, 384, torch.float32),
            (50176, 384, torch.float32), (12544, 768, torch.float32),
            (12544, 1536, torch.float32), (212704, 256, torch.float32),
            (9600, 256, torch.float32), (7, 96, torch.float32),
            (1, 256, torch.bfloat16), (33, 32, torch.float32),
            (129, 64, torch.bfloat16), (1000, 512, torch.float32),
            (1000, 1536, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,C,dtype", K7_CASES)
def test_k7_vs_plain(cuda_device, n, C, dtype):
    x, w, b = rows(n, C, dtype, seed=n + C, device=cuda_device)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = ln.layer_norm.launches
        got = ln.layer_norm(x, w, b, 1e-5, out_dtype)
        torch.cuda.synchronize()
        assert ln.layer_norm.launches == before + 1
        want = ln.layer_norm_torch(x, w, b, 1e-5, out_dtype)
        assert got.dtype == out_dtype and got.shape == x.shape
        if out_dtype == torch.float32:
            torch.testing.assert_close(got, want, **TOL)
        else:
            assert_within_ulp(got, want)
    # the operator takes the same kernel
    before = ln.layer_norm.launches
    got = torch.ops.rscotr_torch.layer_norm_fwd(x, w, b, 1e-5, False)
    assert ln.layer_norm.launches == before + 1
    torch.testing.assert_close(got, ln.layer_norm_torch(x, w, b), **TOL)


@pytest.mark.cuda
def test_k7_refuses_what_it_does_not_take(cuda_device):
    x, w, b = rows(64, 96, torch.float32, 0, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm(x.t().contiguous().t(), w, b)
    flat = torch.empty(64 * 96 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        ln.layer_norm(flat[1:].view(64, 96), w, b)
    for C in (36, 6):
        y, wc, bc = rows(4, C, torch.float32, 0, device=cuda_device)
        with pytest.raises(ValueError, match="width"):
            ln.layer_norm(y, wc, bc)
    with pytest.raises(ValueError, match="weight"):
        ln.layer_norm(x, w.double(), b)
    # a module makes a strided input contiguous first
    m = randomize(LayerNorm(96), 0).to(cuda_device)
    with torch.no_grad():
        got = m(x.t().contiguous().t())
    torch.testing.assert_close(got, ln.layer_norm_torch(x, m.weight,
                                                        m.bias), **TOL)


@pytest.mark.cuda
def test_k7_launches_per_serving_request(cuda_device):
    """Every LayerNorm call of a flagship cls and det request goes through
    K7: its launches equal the LayerNorm calls the request makes (each
    module once, the DINO decoder's shared output norm once a decoder
    layer), and autograd-recorded calls launch nothing."""
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_model_cfg
    cfg = load_model_cfg(FLAGSHIP)
    model = build_model(cfg, device=cuda_device,
                        generator=torch.Generator().manual_seed(0))
    calls = {"n": 0}

    def count(*_):
        calls["n"] += 1

    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.register_forward_hook(count)
    steps = make_infer_steps(model, max_per_img=100)
    rng = np.random.default_rng(0)
    reqs = {"cls": (rng.integers(0, 256, (4, 224, 224, 3), np.uint8),),
            "det": (rng.integers(0, 256, (2, 800, 800, 3), np.uint8),
                    np.array([[800, 800], [800, 640]], np.int32),
                    np.ones((2, 4), np.float32))}
    # Swin-T: patch embedding 1, 12 blocks x 2, 3 merging norms, the stage
    # outputs; det adds the encoder (6 x 2), the decoder (6 x 3 and its
    # output norm 6 times) and enc_output_norm
    for task, args in reqs.items():
        before, calls["n"] = ln.layer_norm.launches, 0
        steps[task](*args)
        torch.cuda.synchronize()
        assert calls["n"] > 28
        assert ln.layer_norm.launches - before == calls["n"], task
    x = torch.randn(8, 96, device=cuda_device, requires_grad=True)
    before = ln.layer_norm.launches
    model.backbone.patch_embed.norm(x).sum().backward()
    assert ln.layer_norm.launches == before
