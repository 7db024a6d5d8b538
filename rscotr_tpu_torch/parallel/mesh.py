"""Process-group setup of the port (counterpart of
rscotr_tpu/parallel/mesh.py): one process per rank over
``torch.distributed``, where JAX has one controller and a device mesh.

* ``initialize_distributed(launcher, backend, device)``: ``pytorch`` reads
  the ``env://`` variables that ``torch.distributed.run`` sets (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
  ``slurm`` and ``mpi`` map their launchers' rank and size variables to
  those names first, as JAX's ``initialize_distributed`` maps torchrun's;
  ``jax`` names the TPU-pod launcher and is refused. The backend is the
  config's ``dist_params.backend`` (mmcv's key), else ``nccl`` on the card
  and ``gloo`` on the CPU. ``init_method`` (``file://...`` in the tests,
  with ``world`` and ``rank_id``) replaces ``env://``.
* ``world_size()`` / ``rank()`` read the default group (1 / 0 without
  one); ``local_device(device)`` is ``cuda:{LOCAL_RANK % device_count}`` on
  the card.
* ``broadcast_module(model)`` sends rank 0's parameters and buffers to
  every rank: JAX replicates one host-local tree (``replicate_global``);
  the port starts every rank from rank 0's weights, DDP's rule.
* ``pad_batch_to_devices`` is JAX's numpy helper, copied.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# launcher -> (rank, world size, local rank) variables it sets
_LAUNCHER_ENV = {
    "slurm": ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    "mpi": ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
            "OMPI_COMM_WORLD_LOCAL_RANK"),
}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK % device_count}`` for a
    CUDA ``device`` given without an index, else ``device`` as given. A
    rank that finds no card raises (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but this process "
                           "finds no CUDA device (pass --device cpu to run "
                           "on the CPU)")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def _map_launcher_env(launcher: str) -> None:
    """Set ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (and a local
    ``MASTER_ADDR`` / ``MASTER_PORT`` when unset) from a slurm or mpi
    launcher's own variables."""
    env = os.environ
    r, w, lr = _LAUNCHER_ENV[launcher]
    if r not in env or w not in env:
        raise RuntimeError(f"--launcher {launcher}: {r} and {w} are not set "
                           "(not started by that launcher?)")
    env.setdefault("RANK", env[r])
    env.setdefault("WORLD_SIZE", env[w])
    env.setdefault("LOCAL_RANK", env.get(lr, "0"))
    if launcher == "slurm" and "MASTER_ADDR" not in env:
        nodes = env.get("SLURM_NODELIST", "localhost")
        env["MASTER_ADDR"] = nodes.split(",")[0].split("[")[0]
    env.setdefault("MASTER_ADDR", "localhost")
    env.setdefault("MASTER_PORT", "29500")


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(launcher: str = "none",
                           backend: Optional[str] = None, device="cuda",
                           init_method: Optional[str] = None,
                           world: Optional[int] = None,
                           rank_id: Optional[int] = None,
                           timeout_s: float = 600.0) -> torch.device:
    """Join the process group of ``launcher`` and return this rank's
    device (``local_device(device)``). ``none`` joins nothing. With a
    CUDA device the rank's card becomes the current one before the group
    is made, so NCCL binds to it."""
    if launcher == "none":
        return local_device(device)
    if launcher == "jax":
        raise ValueError(
            "--launcher jax starts JAX processes on a TPU pod slice "
            "(jax.distributed); the PyTorch port has no counterpart: launch "
            "it with torch.distributed.run and --launcher pytorch (or "
            "slurm / mpi)")
    if launcher in _LAUNCHER_ENV:
        _map_launcher_env(launcher)
    elif launcher != "pytorch":
        raise ValueError(f"unknown launcher {launcher!r}")
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if is_initialized():
        return dev
    backend = backend or default_backend(dev)
    kw = {} if world is None else dict(world_size=world, rank=rank_id)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    from rscotr_tpu_torch.parallel.multihost import make_host_groups
    make_host_groups()
    return dev


def destroy_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()


@torch.no_grad()
def broadcast_module(model: torch.nn.Module, src: int = 0) -> None:
    """Every rank takes rank ``src``'s parameters and buffers (a no-op in
    one process)."""
    if world_size() == 1:
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src)


def pad_batch_to_devices(batch: Dict[str, np.ndarray],
                         n_devices: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad leading axis to a multiple of n_devices (eval-time)."""
    n = len(next(iter(batch.values())))
    target = ((n + n_devices - 1) // n_devices) * n_devices
    if target == n:
        return batch, n
    out = {}
    for k, v in batch.items():
        pad = [(0, target - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad)
    return out, n
