"""Tensor-parallel placement of the port (counterpart of
rscotr_tpu/parallel/tp.py) with DTensor over a 2-D (data, model) device
mesh: JAX's Megatron rules, under the port's module names.

* FFN up projection (``ffn.layers.0.0``: the transformer FFNs and the Swin
  MLP) column-sharded, down projection (``ffn.layers.1``) row-sharded;
* the MSDA ``value_proj`` column-sharded and its ``output_proj``
  row-sharded: the layer reshapes ``value`` with its local head count and
  launches K1 / K1b on the local heads, their offsets and weights sliced
  from the replicated projections (whose gradients are then summed over
  the model group, ``sum_grad_over_tp``);
* the attention q / k / v projections column-sharded by heads and
  ``attn.out_proj`` row-sharded. The port fuses q, k and v in one
  ``in_proj_weight`` (3C, C) (mmcv's layout), so a flat split would cross
  the q / k / v boundary (the hazard JAX names for Swin's qkv): under TP
  the fused weight is held as (3, C, C) (the bias as (3, C)) sharded on
  its dim 1, every rank holding q, k and v of its own heads
  (``MultiheadAttention`` computes its local heads from it);
* Swin's window-attention ``qkv`` / ``proj`` stay replicated, as in JAX;
  so does everything else (norms, embeddings, convolutions, heads).

A dim that does not divide by the model axis keeps its leaf replicated.
JAX keeps TP as a mechanism only (``train_model`` has no TP branch), and
so does the port: it is reached through this module. A DTensor never
reaches a kernel wrapper (``ops``: K1b and K2b are ``ctypes`` calls on
``data_ptr()``); the wrappers refuse one.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

_COL, _ROW = "col", "row"

# (port name regex, kind); first match wins
_RULES: Tuple[Tuple[str, str], ...] = (
    (r"\.ffns?\.(\d+\.)?layers\.0\.0\.", _COL),
    (r"\.ffns?\.(\d+\.)?layers\.1\.", _ROW),
    (r"\.attn\.in_proj_", _COL),
    (r"\.value_proj\.", _COL),
    (r"\.attn\.out_proj\.", _ROW),
    (r"\.output_proj\.", _ROW),
)


class _SumGradOverTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (Megatron's "f"): a replicated tensor of which each rank uses
    its own heads' slice gets every head's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grad_over_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``mesh``'s group."""
    return _SumGradOverTP.apply(x, mesh.get_group())


def make_mesh_2d(n_data: int, n_model: int, device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the default group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def _spec_for(name: str, shape, n_model: int) -> Optional[int]:
    """The port dim of parameter ``name`` sharded over ``model`` (JAX's
    ``_spec_for`` in the port's layout), None for replicated."""
    is_w = name.endswith(".weight") or name.endswith("in_proj_weight")
    is_b = name.endswith(".bias") or name.endswith("in_proj_bias")
    if not (is_w or is_b):
        return None
    fused = ".attn.in_proj_" in name
    for pat, kind in _RULES:
        if not re.search(pat, name):
            continue
        out = shape[0] // 3 if fused else shape[0]
        if kind == _COL:
            if is_w and len(shape) == 2 and out % n_model == 0:
                return 0
            if is_b and out % n_model == 0:
                return 0
        elif is_w and len(shape) == 2 and shape[1] % n_model == 0:
            return 1
        return None
    return None


def tp_param_specs(model: nn.Module, n_model: int
                   ) -> Dict[str, Optional[int]]:
    """{parameter name: its port dim sharded over ``model`` or None}. A
    fused ``in_proj`` dim 0 is sharded per q / k / v part."""
    return {n: _spec_for(n, tuple(p.shape), n_model)
            for n, p in model.named_parameters()}


def describe_tp(model: nn.Module, n_model: int, n_data: int = 1) -> str:
    """Human-readable summary: how many leaves / bytes shard over 'model'
    (JAX's ``describe_tp``)."""
    specs = tp_param_specs(model, n_model)
    n_sharded = n_total = 0
    b_sharded = b_total = 0
    for n, p in model.named_parameters():
        size = p.numel() * p.element_size()
        n_total += 1
        b_total += size
        if specs[n] is not None:
            n_sharded += 1
            b_sharded += size
    return (f"TP over mesh {{'data': {n_data}, 'model': {n_model}}}: "
            f"{n_sharded}/{n_total} param leaves sharded "
            f"({b_sharded / 1e6:.1f}/{b_total / 1e6:.1f} MB)")


@torch.no_grad()
def _shard_fused(mod: nn.Module, tp_mesh) -> None:
    """The fused q / k / v projection of ``mod`` (an ``_InOutProj``) as
    (3, C, C) / (3, C) DTensors sharded on dim 1: every rank holds its
    heads' rows of q, k and v."""
    from torch.distributed.tensor import Shard, distribute_tensor
    C = mod.in_proj_weight.shape[1]
    w = mod.in_proj_weight.detach().reshape(3, C, C)
    b = mod.in_proj_bias.detach().reshape(3, C)
    mod.in_proj_weight = nn.Parameter(distribute_tensor(
        w, tp_mesh, [Shard(1)], src_data_rank=None))
    mod.in_proj_bias = nn.Parameter(distribute_tensor(
        b, tp_mesh, [Shard(1)], src_data_rank=None))


def parallelize(model: nn.Module, mesh) -> nn.Module:
    """Place ``model``'s parameters by ``tp_param_specs`` over the
    ``model`` dim of the 2-D ``mesh`` (``make_mesh_2d``), in place; every
    rank must hold the same weights first. Returns ``model``."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    tp_mesh = mesh["model"]
    n = tp_mesh.size()
    specs = tp_param_specs(model, n)
    plan = {}
    for mname, mod in model.named_modules():
        if hasattr(mod, "in_proj_weight") and \
                specs.get(f"{mname}.in_proj_weight") == 0:
            _shard_fused(mod, tp_mesh)
            continue
        if not isinstance(mod, nn.Linear):
            continue
        w = specs.get(f"{mname}.weight")
        if w == 0:
            plan[mname] = ColwiseParallel()
        elif w == 1:
            plan[mname] = RowwiseParallel()
    if plan:
        parallelize_module(model, tp_mesh, plan)
    return model
