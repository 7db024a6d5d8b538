"""Multi-process gather helpers (counterpart of
rscotr_tpu/parallel/multihost.py) over ``torch.distributed``.

``all_gather_pyobjects`` gathers one picklable object from every rank
(``dist.all_gather_object``); one process returns ``[obj]`` and calls no
collective. ``merge_strided_results`` is JAX's, copied.

Host-side agreements run on gloo groups of their own, made once on every
rank when the default group is (``host_group``): ``"main"`` for the loop's
collectives on host values (the preemption flag, gathered eval results),
``"loader"`` for the loader thread's (the det batch's bucket and DN width).
Two threads never share a group, so each group sees its collectives in the
same order on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.distributed as dist

from rscotr_tpu_torch.parallel.mesh import is_initialized, rank, world_size

_GROUPS: Dict[str, Any] = {}
_NAMES = ("main", "loader")


def process_count() -> int:
    return world_size()


def process_index() -> int:
    return rank()


def make_host_groups() -> None:
    """Make the gloo groups of ``host_group`` (a collective: every rank
    calls it at the same point, right after the default group is made)."""
    if _GROUPS.get("_pg") is dist.group.WORLD:
        return
    _GROUPS.clear()
    _GROUPS["_pg"] = dist.group.WORLD
    for name in _NAMES:
        _GROUPS[name] = dist.new_group(backend="gloo")


def host_group(name: str = "main"):
    """The gloo group ``name`` (``"main"`` or ``"loader"``) of the current
    default group."""
    if _GROUPS.get("_pg") is not dist.group.WORLD:
        make_host_groups()
    return _GROUPS[name]


def all_gather_pyobjects(obj: Any) -> List[Any]:
    """Gather one arbitrary picklable object from every process.

    Returns the list [obj_from_process_0, ..., obj_from_process_{P-1}]
    on every process. P == 1 returns [obj] without any collective.
    """
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj, group=host_group("main"))
    return out


def all_reduce_max(values, group: str = "main") -> List[int]:
    """Element-wise max of a list of ints over the ranks (host values, on
    the gloo group ``group``); one process returns them as they are."""
    values = [int(v) for v in values]
    if not is_initialized() or world_size() == 1:
        return values
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group(group))
    return t.tolist()


def merge_strided_results(per_process: List[dict]) -> dict:
    """Merge per-process {dataset: [(global_idx, result), ...]} shards into
    {dataset: [result, ...]} ordered by global index."""
    merged: dict = {}
    for shard in per_process:
        for name, items in shard.items():
            merged.setdefault(name, []).extend(items)
    return {name: [r for _, r in sorted(items, key=lambda x: x[0])]
            for name, items in merged.items()}
