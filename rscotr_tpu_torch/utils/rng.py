"""RNG plumbing of the port (counterpart of rscotr_tpu/utils/rng.py): one
root seed -> named ``torch.Generator`` streams and a numpy generator.

JAX folds keys: ``fold_in(root, name)``, then ``fold_in(k, step)``. The
port's counterpart is a pure function of the integers, ``mix_seed(seed,
*ints)``, that seeds a CPU ``torch.Generator`` (CPU generators keep the
draws off the card's critical path, as ``make_train_step`` takes them).
The one rule for a training step lives here, ``step_generator(seed,
step)``: the runner hands step ``s`` a generator that depends on ``(seed,
s)`` alone, as JAX's runner hands it ``fold_in(root, s)``
(rscotr_tpu/engine/runner.py:219), so a resumed step draws what the same
step drew in an uninterrupted run.

Under data parallelism each rank steps its share of the global batch: the
rows ``rank, rank + world, ...`` of the one-process batch (the rank stride
of the loaders). ``step_shard(world, rank, group)`` says so for the step's
duration, and ``per_sample(draw, B)`` makes a per-sample draw for the
global batch (``draw(B * world)``, so every rank's generator advances as
the one process's does) and keeps this rank's rows.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, TypeVar

import numpy as np
import torch


def mix_seed(*ints: int) -> int:
    """A 64-bit seed that is a pure function of the integers (numpy's
    ``SeedSequence`` hash: well mixed, independent of the platform). The
    count leads, since ``SeedSequence`` reads trailing zeros as absent."""
    words = [len(ints)] + [int(i) & 0xFFFFFFFFFFFFFFFF for i in ints]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of training step ``step`` (0-based) of a run
    seeded ``seed``."""
    return torch.Generator().manual_seed(mix_seed(seed, step))


class StepShard:
    """The share of the global batch that the current step runs: ``world``
    ranks, this one ``rank``, their ``group`` (None: the default group)."""
    world = 1
    rank = 0
    group = None


SHARD = StepShard()
T = TypeVar("T")


@contextlib.contextmanager
def step_shard(world: int, rank: int, group=None):
    prev = (SHARD.world, SHARD.rank, SHARD.group)
    SHARD.world, SHARD.rank, SHARD.group = int(world), int(rank), group
    try:
        yield SHARD
    finally:
        SHARD.world, SHARD.rank, SHARD.group = prev


def per_sample(draw: Callable[[int], T], B: int) -> T:
    """``draw(n)`` returns a tensor (or a dict of tensors) whose first axis
    is ``n`` samples. In one process: ``draw(B)``. In a step of
    ``step_shard(world, rank)``: ``draw(B * world)``, this rank's rows
    ``rank::world`` of it."""
    w = SHARD.world
    if w == 1:
        return draw(B)
    out = draw(B * w)
    if isinstance(out, dict):
        return {k: v[SHARD.rank::w] for k, v in out.items()}
    return out[SHARD.rank::w]


def _stable_hash(name: str) -> int:
    h = 2166136261
    for ch in name.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


class RngPool:
    """Named, step-foldable generator streams derived from one root seed."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.numpy = np.random.Generator(np.random.PCG64(self.seed))

    def make(self, name: str, step: Optional[int] = None) -> torch.Generator:
        ints = [self.seed, _stable_hash(name)]
        if step is not None:
            ints.append(step)
        return torch.Generator().manual_seed(mix_seed(*ints))


# cuBLAS's fixed workspace: torch's deterministic mode refuses a CUDA
# matmul without it; cuBLAS reads it when it makes a handle
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def deterministic_cublas() -> None:
    """Set ``CUBLAS_WORKSPACE_CONFIG`` unless the caller has set it (before
    the process's first CUDA matmul, for cuBLAS to take it)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


def set_random_seed(seed: int, deterministic: bool = False) -> RngPool:
    """Seed numpy's and torch's global generators (mmcv
    ``set_random_seed``). ``deterministic``: a training run on the card that
    repeats bit for bit, as JAX's does by default.
    ``torch.use_deterministic_algorithms(True)``, with which K1b and K2b
    take their ordered bodies (``ops.kernel_lib.ordered_sums``), the seg
    loss's antialiased shrink its matrix products (``ops.resize``), and any aten
    op without a deterministic implementation raises; cuDNN's
    deterministic algorithms without its benchmark search; and
    ``CUBLAS_WORKSPACE_CONFIG`` (``deterministic_cublas``)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        deterministic_cublas()
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return RngPool(seed)
