"""Data-parallel gradient sync of the port. In JAX the gradient psum is
implicit in the jitted step over the mesh; here each rank runs its own
step, and ``GradSync`` all-reduces the gradients between ``backward`` and
the optimizer's update.

Why not ``DistributedDataParallel``: DDP syncs from the hooks its own
``forward`` arms, and the port's loss functions call ``model.forward_cls``,
``forward_det`` and ``forward_seg``; each step also leaves the other tasks'
heads unused. ``GradSync`` instead reduces the gradients of the parameters
in the step's task mask, in buckets of at most ``BUCKET_BYTES`` (a
parameter without a gradient counts as zeros, as the optimizer counts it;
a DTensor's local shard under tensor parallelism), and leaves out the
parameters that FSDP reduces itself (``skip``).

The reduction is a SUM. Each rank's loss is its share of the global loss:
the det and seg terms divide by normalizers that ``reduce_sum`` makes
global (mmdet's ``reduce_mean`` of ``num_pos`` and ``cls_avg``, the seg
count of non-ignored pixels); the cls loss, a mean over equal local
batches, is scaled by ``1 / world`` in the step. The sum of the shares'
gradients is then the gradient of the global loss, what one process
computes on the global batch.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from rscotr_tpu_torch.utils.rng import SHARD

# the gradient sum's bucket: one all-reduce per 25 MiB of gradients
BUCKET_BYTES = 25 * 2 ** 20


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself, not a copy, outside
    autograd), any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def gather_shards(local_t: torch.Tensor, mesh, placements, shape
                  ) -> torch.Tensor:
    """The full tensor of global ``shape`` whose shard on this rank is
    ``local_t``, laid out by ``placements`` over ``mesh`` (a collective on
    each sharded mesh dim's group). It uses c10d's
    ``all_gather_into_tensor``, which gloo carries for CUDA tensors, where
    DTensor's ``full_tensor`` (functional collectives) crashes over gloo
    with CUDA tensors (torch 2.11)."""
    full = local_t.detach()
    for i, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        group = mesh.get_group(i)
        n, d = dist.get_world_size(group), pl.dim
        size = shape[d]
        chunk = -(-size // n)
        sizes = [max(0, min(chunk, size - k * chunk)) for k in range(n)]
        pad = list(full.shape)
        pad[d] = chunk
        padded = full.new_zeros(pad)
        padded.narrow(d, 0, full.shape[d]).copy_(full)
        buf = full.new_empty((n * pad[0],) + tuple(pad[1:]))
        dist.all_gather_into_tensor(buf, padded.contiguous(), group=group)
        parts = buf.view([n] + pad).unbind(0)
        full = torch.cat([q.narrow(d, 0, k) for q, k in zip(parts, sizes)],
                         dim=d)
    return full


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full tensor (``gather_shards``); any other tensor as it
    is."""
    if not isinstance(t, DTensor):
        return t
    return gather_shards(t.to_local(), t.device_mesh, t.placements, t.shape)


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (detached) summed over the ranks of the current step
    (``utils.rng.step_shard``); ``x`` itself in one process."""
    if SHARD.world == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=SHARD.group)
    return y


class GradSync:
    """Sums the task-masked gradients over ``group`` (the default group
    when None). ``skip``: parameter names whose gradients another
    mechanism reduces (FSDP's sharded parameters)."""

    def __init__(self, group=None, skip: Iterable[str] = ()):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.skip = set(skip)

    @torch.no_grad()
    def __call__(self, params: Mapping[str, torch.Tensor],
                 mask: Optional[Mapping[str, float]] = None) -> None:
        names = [n for n in params if n not in self.skip
                 and (mask is None or float(mask[n]) > 0)]
        buckets, cur, size = [], [], 0
        for n in names:
            p = params[n]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = local(p.grad)
            nbytes = g.numel() * g.element_size()
            if cur and (size + nbytes > BUCKET_BYTES
                        or g.dtype != cur[0].dtype):
                buckets.append(cur)
                cur, size = [], 0
            cur.append(g)
            size += nbytes
        if cur:
            buckets.append(cur)
        for grads in buckets:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            torch._foreach_copy_(grads, [
                f.view_as(g) for f, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])


def sum_log_vars(log_vars: Dict[str, torch.Tensor], keys, group=None
                 ) -> Dict[str, torch.Tensor]:
    """The ``keys`` of ``log_vars`` (per-rank loss shares, device scalars)
    summed over the ranks in one all-reduce; the other entries as they
    are."""
    keys = [k for k in keys if k in log_vars]
    if not keys or not dist.is_initialized() or \
            dist.get_world_size(group) == 1:
        return dict(log_vars)
    flat = torch.stack([torch.as_tensor(log_vars[k]).float().reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=group)
    out = dict(log_vars)
    out.update(zip(keys, flat.unbind(0)))
    return out
