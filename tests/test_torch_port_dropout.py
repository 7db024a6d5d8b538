"""The dropout rates of the port (ROADMAP C5, C18) on the CPU:

* ``ops.philox``: Philox4x32-10 against Random123's known answers (counter
  0 / key 0, the pi-digit vector, all ones), the keep threshold at the
  rates' edges;
* the plain K2 / K2b with attention dropout (``window_attention_torch``,
  ``window_attention_bwd_torch`` through ``window_attention``) against a
  hand composition softmax -> keep / (1 - p) -> P v on the same bits, and
  their gradients against autograd through that composition (atol 1e-5,
  float32); the operators' ``opcheck`` with the new arguments; rate 1 gives
  zeros, the same seed the same output, another seed another;
* the sites against JAX at rate 1.0, where both packages are
  deterministic: the tiny MTL's Swin with ``attn_drop_rate=1`` (JAX's
  unfused path) and its shared encoder with ``dropout=1`` and
  ``ffn_drop=1``, each built by both packages' builders from the tiny
  config, JAX's init perturbed (so that no bias is zero and a misplaced
  dropout shows) and carried across: the train-mode Swin maps and encoder
  output within 1e-4 (float32 sums in another order, JAX jitted under
  highest matmul precision); a ``WindowMSA`` at ``attn_drop=1`` returns its
  ``proj`` bias;
* rate 0.5, statistically: the keep fraction of 2^20 draws within 5
  binomial sigma of 0.5, and the mean of ``window_attention`` over 64
  seeds within 6 of its standard errors (from the exact variance,
  sum_j P_ij^2 v_jd^2 p / (1 - p)) of the eval output, per element;
* ROADMAP C18: a DINO decoder rate and the seg head's rates are accepted
  and change nothing, in both packages (JAX's modules equal to the build
  without them, the port's train-mode outputs bit-equal);
* the ``cuda``-marked cases run K2 / K2b with dropout against the plain
  versions on the card: the keep pattern bit for bit (read through an
  identity v and a one-hot dO), the values within the kernel tests'
  tolerances; they skip here. This file imports JAX only inside the
  fixtures that compare with it, so the ``cuda`` cases run on the card
  with ``--noconftest``.
"""

import os

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.models.backbones import swin
from rscotr_tpu_torch.models.build import build_model
from rscotr_tpu_torch.ops import philox
from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                   window_attention_bwd,
                                                   window_attention_bwd_torch,
                                                   window_attention_torch)
from rscotr_tpu_torch.utils.config import load_model_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
SITE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch keeps to 2 threads beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), 0, (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     0x299f31d0 << 32 | 0xa4093822,
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ((0xffffffff,) * 4, 0xffffffffffffffff,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's philox4x32_10 vectors (key given as key[1] << 32 |
    key[0])."""
    assert tuple(int(w) for w in philox.philox4x32(counter, key)) == want


def test_keep_threshold_and_mask_edges():
    assert philox.keep_threshold(0.0) == 0
    assert philox.keep_threshold(1.0) == 2 ** 32
    assert philox.keep_threshold(0.5) == 2 ** 31
    assert philox.keep_scale(1.0) == 0.0 and philox.keep_scale(0.2) == 1.25
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="outside"):
            philox.keep_threshold(bad)
    assert philox.keep_mask((3, 5), 0.0, 7).all()
    assert not philox.keep_mask((3, 5), 1.0, 7).any()
    # the counter is the flat index: a sub-block of a larger mask is the
    # larger mask's elements at those indices
    big = philox.keep_mask((4, 6), 0.3, 11)
    idx = torch.arange(24).reshape(4, 6)
    word = philox.philox4x32((idx, 0, 0, 0), 11)[0]
    assert torch.equal(big, word >= philox.keep_threshold(0.3))
    with pytest.raises(ValueError, match="Generator"):
        philox.draw_seed(None)
    g = torch.Generator().manual_seed(3)
    assert 0 <= philox.draw_seed(g) < 2 ** 63


# ---------------------------------------------------------------------------
# the plain K2 / K2b with dropout
# ---------------------------------------------------------------------------

def _wa_inputs(seed, B=2, nW=3, H=2, n=49, hd=8, masked=True,
               dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, nW, H, n, hd)).astype(
        np.float32)).to(dtype) for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(H, n, n)).astype(np.float32))
    mask = None
    if masked:
        mask = torch.from_numpy(
            (rng.uniform(size=(nW, n, n)) < 0.3).astype(np.float32) * -100.0)
    return q, k, v, bias, mask


def _composition(q, k, v, bias, mask, scale, p, seed):
    s = torch.einsum("bwhqd,bwhkd->bwhqk", q * scale, k) + bias[None, None]
    if mask is not None:
        s = s + mask[None, :, None]
    keep = philox.keep_mask(s.shape, p, seed)
    probs = torch.where(keep, s.softmax(-1) * philox.keep_scale(p),
                        torch.zeros(()))
    return torch.einsum("bwhqk,bwhkd->bwhqd", probs, v)


@pytest.mark.parametrize("p,masked", [(0.1, True), (0.5, False),
                                      (0.9, True)])
def test_plain_dropout_vs_composition(p, masked):
    q, k, v, bias, mask = _wa_inputs(1, masked=masked)
    scale, seed = 0.35, 1234
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    got = window_attention(*leaves[:3], leaves[3], mask, scale, p, seed)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    want = _composition(*ref_leaves[:3], ref_leaves[3], mask, scale, p, seed)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    d_out = torch.from_numpy(np.random.default_rng(2).normal(
        size=got.shape).astype(np.float32))
    g_got = torch.autograd.grad(got, leaves, d_out)
    g_want = torch.autograd.grad(want, ref_leaves, d_out)
    for name, a, b in zip(("dq", "dk", "dv", "d_rel_bias"), g_got, g_want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)
    # the backward alone, through the operator
    direct = window_attention_bwd(q, k, v, bias, mask, scale, d_out, p, seed)
    for a, b in zip(direct, g_got):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_plain_dropout_seeds_and_edges():
    q, k, v, bias, mask = _wa_inputs(3)
    a = window_attention_torch(q, k, v, bias, mask, 0.3, 0.2, 5)
    assert torch.equal(a, window_attention_torch(q, k, v, bias, mask, 0.3,
                                                 0.2, 5))
    assert not torch.equal(a, window_attention_torch(q, k, v, bias, mask,
                                                     0.3, 0.2, 6))
    assert torch.equal(window_attention_torch(q, k, v, bias, mask, 0.3, 0.0,
                                              5),
                       window_attention_torch(q, k, v, bias, mask, 0.3))
    zero = window_attention_torch(q, k, v, bias, mask, 0.3, 1.0, 5)
    assert torch.equal(zero, torch.zeros_like(zero))
    grads = window_attention_bwd_torch(q, k, v, bias, mask, 0.3,
                                       torch.ones_like(q), 1.0, 5)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)
    with pytest.raises(ValueError, match="outside"):
        window_attention(q, k, v, bias, mask, 0.3, 1.5, 5)


def test_plain_dropout_bf16_rounds_p_dropped():
    """bf16: P' = P keep / (1 - p) is the operand rounded to bf16."""
    q, k, v, bias, mask = _wa_inputs(4, dtype=torch.bfloat16)
    got = window_attention_torch(q, k, v, bias, mask, 0.3, 0.25, 9)
    want = _composition(q.float(), k.float(), v.float(), bias, mask, 0.3,
                        0.25, 9)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=2 ** -6, atol=1e-2)


@pytest.mark.parametrize("op", ["fwd", "bwd"])
def test_operators_opcheck_with_dropout(op):
    q, k, v, bias, mask = _wa_inputs(5, B=1, nW=2, H=1)
    if op == "fwd":
        args = (q, k, v, bias, mask, 0.3, 0.25, 77)
        torch.library.opcheck(torch.ops.rscotr_torch.window_attn_fwd, args)
    else:
        args = (q, k, v, bias, mask, 0.3, torch.ones_like(q), 0.25, 77)
        torch.library.opcheck(torch.ops.rscotr_torch.window_attn_bwd, args)


# ---------------------------------------------------------------------------
# rate 0.5, statistically
# ---------------------------------------------------------------------------

def test_keep_fraction_and_mean_over_seeds():
    n = 2 ** 20
    frac = philox.keep_mask((n,), 0.5, 2024).float().mean().item()
    assert abs(frac - 0.5) <= 5 * (0.25 / n) ** 0.5, frac
    q, k, v, bias, mask = _wa_inputs(6, B=1, nW=2, H=2, hd=4)
    p, seeds = 0.5, 64
    ev = window_attention_torch(q, k, v, bias, mask, 0.3)
    mean = sum(window_attention_torch(q, k, v, bias, mask, 0.3, p, s)
               for s in range(seeds)) / seeds
    probs = torch.softmax(
        torch.einsum("bwhqd,bwhkd->bwhqk", q * 0.3, k) + bias[None, None]
        + mask[None, :, None], -1)
    var = torch.einsum("bwhqk,bwhkd->bwhqd", probs ** 2, v ** 2) * p / (1 - p)
    z = (mean - ev).abs() / (var / seeds).sqrt().clamp_min(1e-12)
    assert z.max().item() <= 6.0, z.max().item()


# ---------------------------------------------------------------------------
# the sites against JAX at rate 1.0
# ---------------------------------------------------------------------------

def _rates(cfg, swin_attn=0.0, enc=0.0, ffn=0.0, dec=0.0, seg=0.0):
    cfg["backbone"]["attn_drop_rate"] = swin_attn
    layers = cfg["shared_encoder"]["transformerlayers"]
    layers["attn_cfgs"]["dropout"] = enc
    layers["ffn_cfgs"]["ffn_drop"] = ffn
    if dec:
        dl = cfg["bbox_head"]["transformer"]["decoder"]["transformerlayers"]
        for a in dl["attn_cfgs"]:
            a["dropout"] = dec
        dl["ffn_cfgs"]["ffn_drop"] = dec
    if seg:
        sl = cfg["seg_head"]["transformer_decoder"]["transformerlayers"]
        sl["attn_cfgs"]["dropout"] = seg
        sl["ffn_cfgs"]["ffn_drop"] = seg
    return cfg


def _perturbed(tree, seed):
    """JAX's init plus N(0, 0.05) noise on every leaf (numpy), so that no
    bias is zero and a dropout at another place of a branch shows."""
    import jax
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        0, 0.05, np.shape(x))).astype(np.float32), tree)


def _jax_train_apply(module, tree, *args):
    """``module.apply`` in training mode (deterministic=False), jitted,
    under highest matmul precision; ``args[-1]`` is static (the level
    shapes of an encoder call) when it is a tuple."""
    import jax
    import jax.numpy as jnp
    static = args[-1] if isinstance(args[-1], tuple) else None
    arrays = args[:-1] if static is not None else args

    def run(t, *xs):
        extra = (static,) if static is not None else ()
        return module.apply({"params": t}, *xs, *extra, deterministic=False,
                            rngs={"dropout": jax.random.key(1)})
    with jax.default_matmul_precision("highest"):
        out = jax.jit(run)(tree, *(jnp.asarray(a) for a in arrays))
    return jax.tree.map(np.asarray, out)


def _prefixed(tree, prefix):
    sd = state_dict_from_jax({prefix: tree})
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def rate_one():
    """The tiny MTL's Swin (``attn_drop_rate=1``, JAX's unfused path) and
    shared encoder (``dropout=1``, ``ffn_drop=1``), each built by both
    packages' builders from the tiny config, JAX's init perturbed and
    carried across; the port's in training mode."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from rscotr_tpu.models import build as jbuild
    from rscotr_tpu_torch.models import build as pbuild
    cfg = _rates(load_model_cfg(TINY), swin_attn=1.0, enc=1.0, ffn=1.0)
    rng = np.random.default_rng(1)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1))
    N = sum(h * w for h, w in shapes)
    inputs = {
        "img": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
        "tokens": rng.normal(size=(2, N, 64)).astype(np.float32),
        "pos": rng.normal(size=(2, N, 64)).astype(np.float32),
        "ref": rng.uniform(0.1, 0.9, (2, N, 4, 2)).astype(np.float32),
        "shapes": shapes}
    out = {}
    for name, args in (("backbone", (inputs["img"],)),
                       ("shared_encoder", (inputs["tokens"], inputs["pos"],
                                           inputs["ref"], shapes))):
        jfn = getattr(jbuild, "build_" + ("backbone" if name == "backbone"
                                          else "shared_encoder"))
        jm = jfn(cfg[name])
        init_args = tuple(jnp.asarray(a) for a in args[:3]) + args[3:]
        tree = _perturbed(jax.jit(lambda k: jm.init(k, *init_args))(
            jax.random.key(0))["params"] if name == "backbone" else
            jm.init(jax.random.key(0), *init_args)["params"], 0)
        pfn = pbuild.build_backbone if name == "backbone" else \
            pbuild.build_shared_encoder
        module = pfn(cfg[name], torch.float32, torch.device("cpu"))
        module.load_state_dict(_prefixed(tree, name), strict=True)
        out[name] = (module.train(), _jax_train_apply(jm, tree, *args))
    return inputs, out


def test_rate_one_sites_match_jax(rate_one):
    inputs, out = rate_one
    g = torch.Generator().manual_seed(0)
    swin_m, want = out["backbone"]
    got = swin_m(torch.from_numpy(inputs["img"]), g)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=SITE_TOL,
                                   atol=SITE_TOL)
    enc, want = out["shared_encoder"]
    got = enc(*(torch.from_numpy(inputs[k]) for k in ("tokens", "pos",
                                                      "ref")),
              inputs["shapes"], generator=g)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=SITE_TOL,
                               atol=SITE_TOL)


def test_window_msa_rate_one_is_proj_bias():
    msa = swin.WindowMSA(16, 2, 7, attn_drop=1.0)
    for p in msa.parameters():
        torch.nn.init.normal_(p, std=0.5, generator=torch.Generator()
                              .manual_seed(2))
    x = torch.randn(4, 49, 16)
    out = msa.train()(x, 2, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(out, msa.proj.bias.expand_as(out), rtol=0,
                               atol=1e-6)
    assert not torch.allclose(msa.eval()(x, 2), out)


# ---------------------------------------------------------------------------
# ROADMAP C18: the rates JAX drops, in both packages
# ---------------------------------------------------------------------------

def test_dropped_rates_change_nothing_in_both_packages():
    """JAX's build gives the same (dataclass-equal) modules with the
    decoder's and the seg head's rates as without, and another with an
    encoder rate; the port's train-mode det and seg outputs with them are
    bit-equal to those without."""
    pytest.importorskip("jax")
    from rscotr_tpu.models import build_model as jax_build_model
    base = load_model_cfg(TINY)
    dropped = _rates(load_model_cfg(TINY), dec=0.3, seg=0.3)
    assert jax_build_model(dropped) == jax_build_model(base)
    assert jax_build_model(_rates(load_model_cfg(TINY), enc=0.3)) != \
        jax_build_model(base)
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(
        np.float32))
    det = torch.from_numpy(rng.normal(size=(1, 128, 128, 3)).astype(
        np.float32))
    hw = torch.tensor([[128, 128]], dtype=torch.int32)
    outs = []
    for cfg in (base, dropped):
        model = build_model(cfg, device="cpu").train()
        with torch.no_grad():
            outs.append([model.forward_seg(
                img, generator=torch.Generator().manual_seed(0))] + list(
                model.forward_det(det, hw, generator=torch.Generator()
                                  .manual_seed(0))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K2 / K2b with dropout on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _probe_inputs(device, dtype, B=2, nW=5, H=3, n=49):
    """q, k random; v = I (hd 64 >= n): the output row i is P'_i, so its
    non-zeros are the kept keys; no mask, so every P is above 0."""
    g = torch.Generator(device).manual_seed(0)
    q, k = (torch.randn(B, nW, H, n, 64, device=device, generator=g
                        ).to(dtype) for _ in range(2))
    v = torch.eye(n, 64, device=device, dtype=dtype).expand(
        B, nW, H, n, 64).contiguous()
    bias = torch.zeros(H, n, n, device=device)
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_keep_pattern_bit_for_bit(cuda_device, dtype):
    q, k, v, bias = _probe_inputs(cuda_device, dtype)
    p, seed = 0.1, 31337
    want = philox.keep_mask(q.shape[:3] + (49, 49), p, seed, cuda_device)
    out = window_attention(q, k, v, bias, None, 0.125, p, seed)
    assert torch.equal(out[..., :49] != 0, want)
    # K2b: dV = P'^T dO with dO one-hot per query row reads P' transposed
    d_out = torch.eye(49, 64, device=cuda_device, dtype=dtype).expand_as(
        q).contiguous()
    dv = window_attention_bwd(q, k, v, bias, None, 0.125, d_out, p,
                              seed)[2]
    assert torch.equal(dv[..., :49].transpose(-1, -2) != 0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_dropout_vs_plain(cuda_device, dtype, masked):
    q, k, v, bias, mask = (None if t is None else t.to(cuda_device)
                           for t in _wa_inputs(7, B=2, nW=4, H=3, hd=32,
                                               masked=masked, dtype=dtype))
    p, seed, scale = 0.1, 99, 32 ** -0.5
    got = window_attention(q, k, v, bias, mask, scale, p, seed)
    want = window_attention_torch(q, k, v, bias, mask, scale, p, seed)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 10)
    d_out = torch.randn_like(got)
    got_b = window_attention_bwd(q, k, v, bias, mask, scale, d_out, p, seed)
    want_b = window_attention_bwd_torch(q, k, v, bias, mask, scale, d_out,
                                        p, seed)
    for a, b in zip(got_b, want_b):
        bound = tol * 10 * b.float().abs().max().item() + 1e-6
        assert (a.float() - b.float()).abs().max().item() <= bound
