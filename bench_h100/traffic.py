"""The one generator of request traffic: it reads a traffic file's
parameters and makes the requests' inputs from the seed.

A closed-loop image mix (``"kind": "closed_loop"``) has ``batch`` images
of ``image_hw`` a request, uint8 HWC in host memory. With ``scene_hw`` each
request is one scene of that size cut into ``batch`` tiles of ``image_hw``
(row-major); without it, ``batch`` separate images. ``pool`` distinct
requests are made and sent in turn. Every seed gives the same sizes; the
pixels are uniform draws of a ``torch.Generator`` on the device, made in
one call and copied to host memory once.
"""

from __future__ import annotations

from typing import List

import numpy as np

SALT = 0x7EAF_F1C0


def pool(traffic: dict, seed: int, device) -> List[np.ndarray]:
    import torch
    if traffic["kind"] != "closed_loop":
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    n, B = int(traffic["pool"]), int(traffic["batch"])
    h, w = (int(v) for v in traffic["image_hw"])
    g = torch.Generator(device=device).manual_seed((int(seed) ^ SALT)
                                                   % (2 ** 63))
    if "scene_hw" in traffic:
        H, W = (int(v) for v in traffic["scene_hw"])
        if H % h or W % w or (H // h) * (W // w) != B:
            raise ValueError(f"scene {H}x{W} does not cut into {B} tiles "
                             f"of {h}x{w}")
        x = torch.randint(0, 256, (n, H // h, h, W // w, w, 3), generator=g,
                          device=device, dtype=torch.uint8)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, B, h, w, 3)
    else:
        x = torch.randint(0, 256, (n, B, h, w, 3), generator=g,
                          device=device, dtype=torch.uint8)
    host = x.contiguous().cpu().numpy()
    return [host[i] for i in range(n)]


def sample(traffic: dict, seed: int) -> List[int]:
    """The request indices whose outputs are compared with the reference:
    ``check.requests`` of the first ``check.among_first``, drawn from the
    seed."""
    c = traffic["check"]
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), SALT])
    return sorted(int(i) for i in rng.choice(int(c["among_first"]),
                                             int(c["requests"]),
                                             replace=False))
