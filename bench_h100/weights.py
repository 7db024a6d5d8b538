"""Random weights from the seed, made on the device in one draw.

Every parameter of the model is a slice of one ``randn`` drawn by a
``torch.Generator`` on the model's device, scaled by its leaf's role:
matrices and kernels by 1 / sqrt(fan-in), the weights of norms as
1 + 0.1 N(0, 1), biases and other vectors as 0.02 N(0, 1). The same flat
dict of float32 tensors goes into the program (``load``) and to the
reference, so neither side's own initialisation is used.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

SALT = 0x5EED_0001


def make(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """``shapes``: (name, shape) of each parameter, in the model's order."""
    sizes = [math.prod(s) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed((int(seed) ^ SALT)
                                                   % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    with torch.no_grad():
        for (name, shape), n in zip(shapes, sizes):
            t = flat[at:at + n].view(shape)
            at += n
            if len(shape) >= 2:
                t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            elif name.endswith("weight"):
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.02)
            out[name] = t
    return out


def load(model, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` into the model's parameters, name by name, and set
    every frozen BatchNorm's running statistics to mean 0 and variance 1,
    as the reference takes them."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise ValueError("weights and model disagree on parameter names")
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])
        for n, b in model.named_buffers():
            if n.endswith("running_mean"):
                b.zero_()
            elif n.endswith("running_var"):
                b.fill_(1.0)
