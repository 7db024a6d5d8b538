"""Checkpoints of the port as mmcv ``.pth`` files (counterpart of
rscotr_tpu/engine/checkpoint.py, whose checkpoints are orbax directories).

A checkpoint is ``{"meta": {..., "iter": N}, "state_dict": <the model's
state dict>, "optimizer": <MtlOptimizer.state_dict()>}`` (``optimizer``
only when one was saved). The port's state dict is the reference's mm
layout, so the file is what the reference's ``load_checkpoint`` reads, and
the JAX package's ``tools/convert_checkpoint.py`` turns it into an orbax
checkpoint (forward) or makes one from an orbax checkpoint
(``--to-torch``). Meta is plain JSON types, so ``torch.load(...,
weights_only=True)`` reads the whole file.

Under ``torch.distributed`` a save is a collective on every rank: the
full state is gathered to rank 0's host (an FSDP model's shards and the
optimizer's sharded moments by ``parallel.ddp.gather_shards``, c10d's
all-gather, which gloo also carries for CUDA tensors), rank 0 writes the
file one process would write, and a barrier follows.
Async saves stay for one process, as in JAX. A load reads the file on
every rank, before the model is sharded.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Callable, Dict, Optional

import torch

_ITER_RE = re.compile(r"iter_(\d+)\.pth")
_CONVERT = ("python tools/convert_checkpoint.py CONFIG {path} OUT.pth "
            "--to-torch")


class CheckpointWriter:
    """At most one checkpoint write in flight, on a thread of its own. The
    next ``submit`` and ``wait`` join it; ``wait`` re-raises its failure
    (once), so a failed write surfaces in the training loop."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, write) -> None:
        self.wait()

        def job():
            try:
                write()
            except BaseException as e:  # noqa: B036 -- re-raised by wait
                self._error = e

        self._thread = threading.Thread(target=job, name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's state dict as full CPU tensors on rank 0 (the other
    ranks of a process group get an empty dict). A collective when the
    model holds DTensors (FSDP's shards, gathered one by one). Fused
    projections that tensor parallelism keeps as (3, C, C) / (3, C) go
    back to the port's (3C, C) / (3C,)."""
    from rscotr_tpu_torch.parallel.ddp import full_tensor
    from rscotr_tpu_torch.parallel.multihost import process_index
    out = {}
    for k, v in model.state_dict().items():
        v = full_tensor(v)
        if k.endswith("in_proj_weight") and v.dim() == 3:
            v = v.reshape(-1, v.shape[-1])
        elif k.endswith("in_proj_bias") and v.dim() == 2:
            v = v.reshape(-1)
        if process_index() == 0:
            # a copy even for CPU tensors: the loop updates them in place
            # while a writer thread serializes
            out[k] = v.detach().to("cpu", copy=True)
    return out


def save_checkpoint(work_dir: str, step: int, model, optimizer=None,
                    meta: Optional[Dict[str, Any]] = None,
                    name: Optional[str] = None,
                    writer: Optional[CheckpointWriter] = None,
                    post_save: Optional[Callable[[], None]] = None) -> str:
    """Write ``work_dir/iter_{step}.pth`` (or ``work_dir/{name}[.pth]``)
    and return its path. A regular save then points
    ``work_dir/last_checkpoint`` at it; a named save (``best_checkpoint``)
    leaves the pointer alone. The file is written under a temporary name
    and renamed, and the pointer after that, so neither ever names an
    incomplete file; ``post_save`` runs after both (the checkpoint hook
    prunes there).

    The state is copied to the host before this returns. With a
    ``writer`` the file is written on its thread (the training loop waits
    for the copy only); without one, here. Under ``torch.distributed``
    every rank calls it: the state is gathered, rank 0 writes (``writer``
    and ``post_save`` run there only, the write in this call), then the
    ranks meet at a barrier."""
    from rscotr_tpu_torch.parallel.multihost import (host_group,
                                                     process_count,
                                                     process_index)
    work_dir = os.path.abspath(work_dir)
    if name is None:
        fname = f"iter_{int(step)}.pth"
    else:
        fname = name if name.endswith(".pth") else f"{name}.pth"
    path = os.path.join(work_dir, fname)
    m = json.loads(json.dumps(dict(meta or {}, iter=int(step)), default=str))
    ckpt = {"meta": m, "state_dict": full_state_dict(model)}
    if optimizer is not None:
        ckpt["optimizer"] = optimizer.state_dict()
    if process_count() > 1:
        if process_index() == 0:
            write_file(path, ckpt, work_dir, name, post_save)
        torch.distributed.barrier(group=host_group("main"))
        return path

    def write():
        write_file(path, ckpt, work_dir, name, post_save)

    if writer is not None:
        writer.submit(write)
    else:
        write()
    return path


def write_file(path: str, ckpt: dict, work_dir: str, name: Optional[str],
               post_save: Optional[Callable[[], None]]) -> None:
    """``torch.save`` under a temporary name, the rename, the
    ``last_checkpoint`` pointer (regular saves), then ``post_save``."""

    os.makedirs(work_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    if name is None:
        pointer = os.path.join(work_dir, "last_checkpoint")
        with open(pointer + ".tmp", "w") as f:
            f.write(path)
        os.replace(pointer + ".tmp", pointer)
    if post_save is not None:
        post_save()


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    """mmcv ``find_latest_checkpoint``: the file ``last_checkpoint`` names,
    else the ``iter_N.pth`` of the largest N, else None."""
    if not os.path.isdir(work_dir):
        return None
    pointer = os.path.join(work_dir, "last_checkpoint")
    if os.path.isfile(pointer):
        with open(pointer) as f:
            p = f.read().strip()
        if os.path.isfile(p):
            return p
    best, best_iter = None, -1
    for f in os.listdir(work_dir):
        m = _ITER_RE.fullmatch(f)
        if m and int(m.group(1)) > best_iter:
            best, best_iter = os.path.join(work_dir, f), int(m.group(1))
    return best


def _refuse_dir(path: str, given: str):
    raise ValueError(
        f"{given!r} resolves to the directory {path}, not a .pth file: an "
        "orbax checkpoint of the JAX package? rscotr_tpu_torch reads mm "
        "format only; convert it first: " + _CONVERT.format(path=path))


def resolve_checkpoint(path: str) -> str:
    """The ``.pth`` file a checkpoint argument names, with the JAX
    package's aliases:

    - a ``.pth`` file: itself;
    - a work_dir: its latest checkpoint (``find_latest_checkpoint``);
    - ``.../latest[.pth]``: the latest checkpoint in that directory;
    - ``.../best...[.pth]``: ``best_checkpoint.pth`` in that directory;
    - ``.../name``: ``.../name.pth``.

    A directory that is no work_dir (an orbax checkpoint) is refused with
    the command that converts it."""
    p = os.path.abspath(path)
    if os.path.isfile(p):
        return p
    if os.path.isdir(p):
        if os.path.isfile(os.path.join(p, "last_checkpoint")) or any(
                _ITER_RE.fullmatch(f) for f in os.listdir(p)):
            latest = find_latest_checkpoint(p)
            if latest is not None:
                return latest
        _refuse_dir(p, path)
    base = os.path.basename(p)
    stem = base[:-4] if base.endswith(".pth") else base
    parent = os.path.dirname(p)
    if stem == "latest":
        latest = find_latest_checkpoint(parent)
        if latest is not None:
            return latest
    elif stem.startswith("best"):
        cand = os.path.join(parent, "best_checkpoint.pth")
        if os.path.isfile(cand):
            return cand
    cand = os.path.join(parent, stem + ".pth")
    if os.path.isfile(cand):
        return cand
    if os.path.isdir(os.path.join(parent, stem)):
        _refuse_dir(os.path.join(parent, stem), path)
    raise FileNotFoundError(
        f"checkpoint {path!r} not found (tried the file, a work_dir's "
        "latest, and the latest / best / name.pth aliases)")


def load_checkpoint(path: str, model=None, optimizer=None,
                    map_location="cpu") -> Dict[str, Any]:
    """Read the checkpoint ``path`` resolves to: ``{"meta", "state_dict",
    "optimizer"}`` (meta ``{}`` and optimizer None where the file has
    none). The state dict is unwrapped from a ``state_dict`` or ``model``
    entry and its DDP ``module.`` prefixes dropped, as the JAX package's
    converter does; given a ``model``, it is loaded with ``strict=True``
    (every key present, none extra), and given an ``optimizer``, its
    state too."""
    path = resolve_checkpoint(path)
    raw = torch.load(path, map_location=map_location, weights_only=True)
    state, meta = raw, {}
    if isinstance(raw, dict):
        meta = raw.get("meta") or {}
        for key in ("state_dict", "model"):
            if isinstance(raw.get(key), dict):
                state = raw[key]
                break
    state = {k.removeprefix("module."): v for k, v in state.items()
             if isinstance(v, torch.Tensor)}
    if model is not None:
        model.load_state_dict(state, strict=True)
    opt_state = raw.get("optimizer") if isinstance(raw, dict) else None
    if optimizer is not None:
        if opt_state is None:
            raise KeyError(f"{path}: no optimizer state to load")
        optimizer.load_state_dict(opt_state)
    return {"meta": meta, "state_dict": state, "optimizer": opt_state,
            "path": path}
