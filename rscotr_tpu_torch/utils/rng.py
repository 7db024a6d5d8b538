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
"""

from __future__ import annotations

from typing import Optional

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


def set_random_seed(seed: int, deterministic: bool = False) -> RngPool:
    """Seed numpy's and torch's global generators (mmcv
    ``set_random_seed``); ``deterministic`` makes cuDNN pick deterministic
    algorithms and turns off its benchmark search."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return RngPool(seed)
