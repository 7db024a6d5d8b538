"""Ops of the PyTorch port: plain tensor functions and the wrappers of the
hand-written CUDA kernels (``ms_deform_attn.ms_deform_attn`` = K1 forward,
K1b the whole MSDA backward via ``ms_deform_attn.ms_deform_attn_bwd``;
``scatter_mm.scatter_add_mm`` = K3', the value-gradient scatter of the
quad-gather path; ``window_attention.window_attention``
= K2 forward, K2b backward via ``window_attention.window_attention_bwd``;
``layer_norm.layer_norm`` = K7, the LayerNorm forward outside autograd).

Importing the package registers K1, K1b, K2, K2b and K7 as the operators
``torch.ops.rscotr_torch.msda_fwd``, ``msda_bwd``, ``window_attn_fwd``,
``window_attn_bwd`` and ``layer_norm_fwd`` (``torch.export.load`` needs the
forwards before it loads an artifact of ``rscotr_tpu_torch.export``), and
their FLOP formulas for ``FlopCounterMode`` (``ops/flops.py``)."""

from rscotr_tpu_torch.ops import (  # noqa: F401
    layer_norm, ms_deform_attn, window_attention)
from rscotr_tpu_torch.ops import flops  # noqa: F401,E402
