"""The FLOP and byte formulas at small shapes, against counting the
tensors and products directly, and the analytic model FLOPs against
``FlopCounterMode`` over the program's forward on the tiny MTL."""

import pytest
import torch

from bench_h100 import harness
from bench_h100.counts import kernels, mtl, peaks
from bench_h100.tests import _tiny


def test_msda_fwd_counts_every_corner_and_each_tensor_once():
    B, Q, Nv, H, D, L, P = 2, 5, 30, 4, 8, 3, 2
    flops, nbytes = kernels.msda_fwd(B, Q, Nv, H, D, L, P)
    corners = sum(4 for _ in range(B * Q * H * L * P))
    assert flops == 2 * D * corners
    tensors = [torch.empty(B, Nv, H, D, dtype=torch.bfloat16),
               torch.empty(B, Q, H, L, P, 2, dtype=torch.float32),
               torch.empty(B, Q, H, L, P, dtype=torch.bfloat16),
               torch.empty(B, Q, H * D, dtype=torch.bfloat16)]
    assert nbytes == sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd_counts_two_products_and_bytes(masked):
    B, nW, H, n, hd = 2, 3, 2, 49, 16
    flops, nbytes = kernels.window_attn_fwd(B, nW, H, n, hd, masked)
    q = torch.randn(B, nW, H, n, hd)
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        torch.matmul(torch.matmul(q, q.transpose(-1, -2)), q)
    assert flops == fc.get_total_flops()
    want = 4 * q.numel() * 2 + H * n * n * 4 + (nW * n * n * 4 if masked
                                                  else 0)
    assert nbytes == want


def test_bound_is_the_larger_of_the_two():
    assert kernels.bound_s(1e12, 1.0, 1e12, 1e12) == 1.0
    assert kernels.bound_s(1.0, 2e12, 1e12, 1e12) == 2.0


def test_peaks_by_device_name():
    assert peaks.flops("NVIDIA H100 80GB HBM3") == 989e12
    assert peaks.bytes_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.flops("cpu") is None


def _counted(entry, traffic, cfg):
    from torch.utils.flop_counter import FlopCounterMode
    from rscotr_tpu_torch.engine.infer import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    import rscotr_tpu_torch.ops  # noqa: F401
    model = build_model(cfg, tasks=(entry,), device="cpu")
    model.requires_grad_(False)
    fn = make_infer_steps(model, max_per_img=traffic.get("max_per_img",
                                                         300))[entry]
    B, (h, w) = traffic["batch"], traffic["image_hw"]
    x = torch.zeros(B, h, w, 3, dtype=torch.uint8)
    args = (x, torch.tensor([[h, w]] * B)) if entry == "det" else (x,)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def test_cls_flops_equal_the_flop_counter():
    cfg = _tiny.config("mtl_det_scene")["model"]
    tr = {"entry": "cls", "batch": 2, "image_hw": [64, 64]}
    assert harness.check("cls").count(cfg, tr)[0] == \
        _counted("cls", tr, cfg)


def test_det_flops_equal_the_flop_counter_less_unused_branches():
    """The program also runs every earlier decoder layer's class and box
    branches on its normed state, which the served boxes do not read."""
    cfg = _tiny.config("mtl_det_scene")["model"]
    tr = {"entry": "det", "batch": 1, "image_hw": [128, 128],
          "max_per_img": 20}
    h = cfg["bbox_head"]
    C = cfg["shared_encoder"]["transformerlayers"]["attn_cfgs"]["embed_dims"]
    L = h["transformer"]["decoder"]["num_layers"]
    extra = (L - 1) * h["num_query"] * (2 * C * h["num_classes"] +
                                       2 * (2 * C * C + 4 * C))
    assert harness.check("det").count(cfg, tr)[0] + extra == \
        _counted("det", tr, cfg)


def test_resnet_det_flops_equal_the_flop_counter_less_unused_branches():
    cfg = _tiny.config("dino_4scale_r50_det_scene")["model"]
    tr = {"entry": "det", "batch": 1, "image_hw": [256, 256],
          "max_per_img": 20}
    h = cfg["bbox_head"]
    C = cfg["neck"]["out_channels"]
    L = h["transformer"]["decoder"]["num_layers"]
    extra = (L - 1) * h["num_query"] * (2 * C * h["num_classes"] +
                                       2 * (2 * C * C + 4 * C))
    assert harness.check("det").count(cfg, tr)[0] + extra == \
        _counted("det", tr, cfg)


def test_kernel_calls_per_request():
    cfg = _tiny.config("mtl_det_scene")["model"]
    _, calls = mtl.det(cfg, 2, 128, 128)
    enc = cfg["shared_encoder"]["num_layers"]
    dec = cfg["bbox_head"]["transformer"]["decoder"]["num_layers"]
    assert len(calls["msda_fwd"]) == enc + dec
    assert len(calls["window_attn_fwd"]) == sum(cfg["backbone"]["depths"])
