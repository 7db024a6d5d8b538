"""FSDP of the port (counterpart of rscotr_tpu/parallel/fsdp.py): the
parameters and the AdamW moments sharded over the ranks with FSDP2's
``fully_shard``, where JAX annotates per-leaf shardings and lets GSPMD
insert the collectives.

* Units: each Swin block and patch merging (a Swin stage has no forward
  of its own: the backbone calls its blocks, its out norm, then its
  downsample), each deformable encoder layer, each DINO and Mask2Former
  decoder layer gets its own ``fully_shard``, then the root (the rest).
  ``forward_cls``, ``forward_det`` and ``forward_seg`` are registered as
  FSDP forward methods, so calling one unshards the root as ``forward``
  would.
* Which dim: ``fsdp_dim`` applies JAX's ``_fsdp_spec`` rule to each
  parameter seen in JAX's layout (``jax_view``: a Linear weight (out, in)
  is JAX's (in, out) kernel, a Conv2d weight (O, I, kh, kw) its (kh, kw, I,
  O), the fused attention ``in_proj_weight`` (3C, C) three (C, C)
  kernels): the largest divisible dim, or the fixed dim of
  ``_FIXED_DIM_PATHS`` (Swin ``attn.qkv`` on its input, ``attn.proj`` on
  its output), then maps the chosen dim back to the port's layout.
* Small leaves: below ``min_leaf_size`` elements, or with no divisible
  dim, a parameter stays whole on every rank (FSDP2's ``ignored_params``);
  ``parallel.ddp.GradSync`` sums its gradient. So does the DINO head's
  label embedding, which the det loss reads before ``forward_det``
  (``READ_OUTSIDE_FORWARD``).
* The gradient reduce-scatter is a SUM (divide factor 1), the rule of
  ``parallel/ddp.py``: each rank's loss is its share of the global loss.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# Below this many elements a leaf stays replicated: an all-gather dispatch
# costs more than holding 8 copies of a LayerNorm bias.
DEFAULT_MIN_LEAF_SIZE = 2 ** 14

# the JAX package's fixed dims (rscotr_tpu/parallel/fsdp.py), under the
# port's names; the dims are JAX's (kernel (in, out))
_FIXED_DIM_PATHS: Tuple[Tuple[re.Pattern, int], ...] = (
    (re.compile(r"attn\.w_msa\.qkv\.weight$"), 0),
    (re.compile(r"attn\.w_msa\.proj\.weight$"), 1),
)

# parameters the det loss reads outside the model's forward methods (the
# CDN label queries, engine/train_step.py det_loss_fn): their gradient
# arrives after FSDP's post-backward hook of forward_det has run, so they
# stay whole and GradSync sums them
READ_OUTSIDE_FORWARD = ("bbox_head.label_embedding.weight",)

# the FSDP units below the root, by class name
UNIT_CLASSES = ("SwinBlock", "PatchMerging", "DeformableEncoderLayer",
                "DinoDecoderLayer", "MaskedAttentionDecoderLayer")
FORWARD_METHODS = ("forward_cls", "forward_det", "forward_seg")


def _fsdp_spec(shape: Tuple[int, ...], axis_size: int, min_size: int,
               fixed_dim: Optional[int] = None) -> Optional[int]:
    """JAX's ``_fsdp_spec`` for a leaf with no base spec: the dim to shard
    (the largest divisible one, ties to the lower index; or only
    ``fixed_dim``), None to keep it whole."""
    if not shape or int(np.prod(shape)) < min_size:
        return None
    dims = sorted(range(len(shape)), key=lambda d: -shape[d])
    if fixed_dim is not None:
        dims = [fixed_dim] if fixed_dim < len(shape) else []
    for d in dims:
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            return d
    return None


def jax_view(module: nn.Module, pname: str, shape: Sequence[int]
             ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(the shape of the JAX leaf that holds this parameter, the port dim
    of each JAX dim). A fused ``in_proj_weight`` / ``in_proj_bias`` is
    seen as one of its three q / k / v leaves."""
    shape = tuple(int(s) for s in shape)
    if pname == "weight" and isinstance(module, nn.Linear):
        return (shape[1], shape[0]), (1, 0)
    if pname == "weight" and isinstance(module, nn.Conv2d):
        return (shape[2], shape[3], shape[1], shape[0]), (2, 3, 1, 0)
    if pname == "in_proj_weight":
        return (shape[1], shape[0] // 3), (1, 0)
    if pname == "in_proj_bias":
        return (shape[0] // 3,), (0,)
    return shape, tuple(range(len(shape)))


def fsdp_dim(name: str, module: nn.Module, pname: str, shape,
             axis_size: int, min_leaf_size: int = DEFAULT_MIN_LEAF_SIZE
             ) -> Optional[int]:
    """The port dim that FSDP shards parameter ``name`` on (JAX's choice
    for its leaf, mapped to the port's layout), None to keep it whole
    (always for ``READ_OUTSIDE_FORWARD``)."""
    if name in READ_OUTSIDE_FORWARD:
        return None
    jshape, to_port = jax_view(module, pname, shape)
    fixed = next((d for pat, d in _FIXED_DIM_PATHS if pat.search(name)),
                 None)
    d = _fsdp_spec(jshape, axis_size, min_leaf_size, fixed_dim=fixed)
    return None if d is None else to_port[d]


def _owners(model: nn.Module):
    """(full name, owning module, local name, parameter) for every
    parameter of ``model``."""
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            yield (f"{mname}.{pname}" if mname else pname), mod, pname, p


def fsdp_param_dims(model: nn.Module, axis_size: int,
                    min_leaf_size: int = DEFAULT_MIN_LEAF_SIZE
                    ) -> Dict[str, Optional[int]]:
    """{parameter name: its FSDP dim or None}, in ``named_parameters``
    order."""
    return {n: fsdp_dim(n, mod, pn, p.shape, axis_size, min_leaf_size)
            for n, mod, pn, p in _owners(model)}


def describe_fsdp(model: nn.Module, axis_size: int,
                  min_leaf_size: int = DEFAULT_MIN_LEAF_SIZE) -> str:
    """Human-readable summary: sharded fraction + per-device param bytes
    (JAX's ``describe_fsdp`` for a mesh of ``axis_size`` devices)."""
    n_sharded = n_total = 0
    b_total = b_local = 0
    for n, mod, pn, p in _owners(model):
        size = p.numel() * p.element_size()
        n_total += 1
        b_total += size
        if fsdp_dim(n, mod, pn, p.shape, axis_size,
                    min_leaf_size) is not None:
            n_sharded += 1
            b_local += size // axis_size
        else:
            b_local += size
    return (f"FSDP over mesh {{'data': {axis_size}}}: {n_sharded}/{n_total} "
            f"param leaves sharded; {b_local / 1e6:.1f} MB/device vs "
            f"{b_total / 1e6:.1f} MB replicated")


def _units(model: nn.Module) -> List[nn.Module]:
    return [m for m in model.modules()
            if type(m).__name__ in UNIT_CLASSES and m is not model]


def shard_model(model: nn.Module, mesh=None,
                min_leaf_size: int = DEFAULT_MIN_LEAF_SIZE) -> List[str]:
    """``fully_shard`` ``model`` in place (units, then the root) over the
    1-D ``mesh`` (default: every rank of the default group, on the model's
    device type). Returns the names of the parameters left whole, whose
    gradients ``GradSync`` sums."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard

    dev = next(model.parameters()).device
    if mesh is None:
        mesh = init_device_mesh(dev.type, (dist.get_world_size(),),
                                mesh_dim_names=("data",))
    n = mesh.size()
    dims = fsdp_param_dims(model, n, min_leaf_size)
    by_id = {id(p): name for name, _, _, p in _owners(model)}
    whole = {id(p) for name, _, _, p in _owners(model) if dims[name] is None}

    def placement(p):
        d = dims[by_id[id(p)]]
        return Shard(d) if d is not None else None

    def shard(module):
        ignored = {p for p in module.parameters() if id(p) in whole}
        fully_shard(module, mesh=mesh, shard_placement_fn=placement,
                    ignored_params=ignored or None)

    for unit in _units(model):
        shard(unit)
    shard(model)
    for name in FORWARD_METHODS:
        if hasattr(model, name):
            register_fsdp_forward_method(model, name)
    for m in model.modules():
        if hasattr(m, "set_gradient_divide_factor"):
            # a plain SUM (gloo has no PREMUL_SUM)
            m.set_gradient_divide_factor(1.0)
            m.set_force_sum_reduction_for_comms(True)
    return [name for name, d in dims.items() if d is None]


def fsdp_managed(model: nn.Module) -> Iterable[str]:
    """Names of the parameters FSDP shards (DTensors) in ``model``."""
    from torch.distributed.tensor import DTensor
    return [n for n, p in model.named_parameters()
            if isinstance(p, DTensor)]


@torch.no_grad()
def load_full_weights(src: nn.Module, dst: nn.Module) -> None:
    """Copy the full weights of the FSDP model ``src`` into the plain
    model ``dst`` (a collective: every rank calls it; each rank ends with
    the full weights)."""
    from rscotr_tpu_torch.parallel.ddp import full_tensor
    dst.load_state_dict({k: full_tensor(v) for k, v in
                         src.state_dict().items()}, strict=True)

