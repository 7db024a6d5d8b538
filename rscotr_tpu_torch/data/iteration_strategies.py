"""Multi-task iteration strategies (counterpart of
rscotr_tpu/data/iteration_strategies.py): each strategy is called once a
draw and returns the index of the dataset to draw from.
``should_exhaust_all_iterators`` sets the epoch semantics of the
``MultiDataLoader`` (end the epoch when every child is exhausted, or
re-ignite exhausted children forever).

The random strategies draw from ``np.random.PCG64(seed)`` with the calls the
JAX package makes, so a seed gives the same draw sequence in both packages.
The task order depends on the strategy's seed alone, not on the data seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from rscotr_tpu_torch.utils.registry import STRATEGIES


class IterationStrategy:
    should_exhaust_all_iterators: bool = False

    def __init__(self, dataloaders: Dict[str, object], seed: int = 0,
                 **kwargs):
        self.dataloaders = dataloaders
        self.num = len(dataloaders)
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def __call__(self) -> int:
        raise NotImplementedError

    def set_step(self, step: int) -> None:
        """Put a cyclic strategy where it stands after ``step`` draws; the
        random ones keep their stream (as in the JAX package, whose runner
        calls this nowhere: a resumed run starts the data stream again,
        ROADMAP C9)."""


@STRATEGIES.register_module(name="constant")
class ConstantIterationStrategy(IterationStrategy):
    should_exhaust_all_iterators = True

    def __init__(self, dataloaders, idx: int = 0, **kwargs):
        super().__init__(dataloaders, **kwargs)
        self._idx = idx

    def __call__(self) -> int:
        return self._idx


@STRATEGIES.register_module(name="round_robin")
class RoundRobinIterationStrategy(IterationStrategy):
    """The reference's default."""

    def __init__(self, dataloaders, start_idx: int = 0, **kwargs):
        super().__init__(dataloaders, **kwargs)
        self._cur = start_idx

    def __call__(self) -> int:
        idx = self._cur
        self._cur = (self._cur + 1) % self.num
        return idx

    def set_step(self, step: int) -> None:
        self._cur = step % self.num


@STRATEGIES.register_module(name="repeated_sequence")
class RepeatedSequenceIterationStrategy(IterationStrategy):
    """An explicit index sequence, e.g. [1, 2, 2, 0, 0, 0], repeated."""

    def __init__(self, dataloaders, sequence: Sequence[int] = (0,),
                 **kwargs):
        super().__init__(dataloaders, **kwargs)
        self._seq = list(sequence)
        self._pos = 0

    def __call__(self) -> int:
        idx = self._seq[self._pos]
        self._pos = (self._pos + 1) % len(self._seq)
        return idx

    def set_step(self, step: int) -> None:
        self._pos = step % len(self._seq)


@STRATEGIES.register_module(name="random")
class RandomIterationStrategy(IterationStrategy):
    def __call__(self) -> int:
        return int(self.rng.integers(0, self.num))


@STRATEGIES.register_module(name="weighted_random")
class WeightedRandomIterationStrategy(IterationStrategy):
    def __init__(self, dataloaders, p: Optional[Sequence[float]] = None,
                 **kwargs):
        super().__init__(dataloaders, **kwargs)
        p = np.asarray(p if p is not None else [1.0] * self.num, np.float64)
        self._p = p / p.sum()

    def __call__(self) -> int:
        return int(self.rng.choice(self.num, p=self._p))


@STRATEGIES.register_module(name="size_proportional")
class SizeProportionalIterationStrategy(IterationStrategy):
    should_exhaust_all_iterators = True

    def __init__(self, dataloaders, **kwargs):
        super().__init__(dataloaders, **kwargs)
        sizes = np.asarray([len(dl.dataset) if hasattr(dl, "dataset")
                            else len(dl) for dl in dataloaders.values()],
                           np.float64)
        self._p = sizes / sizes.sum()

    def __call__(self) -> int:
        return int(self.rng.choice(self.num, p=self._p))


STRATEGIES.register_module(name="uniform_random")(RandomIterationStrategy)
STRATEGIES.register_module(name="size_weighted_random")(
    SizeProportionalIterationStrategy)
STRATEGIES.register_module(name="batch-weighted_random")(
    WeightedRandomIterationStrategy)

strategies_map = {
    "constant": ConstantIterationStrategy,
    "round_robin": RoundRobinIterationStrategy,
    "repeated_sequence": RepeatedSequenceIterationStrategy,
    "random": RandomIterationStrategy,
    "uniform_random": RandomIterationStrategy,
    "weighted_random": WeightedRandomIterationStrategy,
    "batch-weighted_random": WeightedRandomIterationStrategy,
    "size_proportional": SizeProportionalIterationStrategy,
    "size_weighted_random": SizeProportionalIterationStrategy,
}
