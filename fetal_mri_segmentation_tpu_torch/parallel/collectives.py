"""The collectives of the port's meshes, over ``torch.distributed`` process
groups.

Where the JAX package names a mesh axis (``axis_name="data"``) and lets XLA
insert ``psum``, or shards the volume's depth axis and lets XLA's SPMD
partitioner insert halo exchanges and global reductions, the port passes
the process group of its mesh (``parallel/data_parallel.py::DataMesh``,
``parallel/spatial.py::HybridMesh``) and calls ``torch.distributed``
itself:

- :func:`all_reduce_sum`, :func:`all_reduce_sum_grad`,
  :func:`sum_gradients`: sums of float32 tensors (the dice's partial sums,
  the norms' moments, the gradients);
- :func:`halo_exchange`: a depth slab extended by its neighbours' boundary
  rows, with the backward that returns the rows' gradients to their owners
  (every 3^3 conv of a depth-sharded forward);
- :func:`all_gather_cat`: the whole volume from its slabs (the spatial
  predictor's output, and a level of a depth-sharded forward whose slabs
  can no longer be halved), with :func:`own_rows` its inverse.

NCCL and gloo both take all of them, gloo also for CUDA tensors (staged
through the host). Neither offers the point-to-point path for CUDA tensors
under gloo, so the halo travels by ``all_gather``: each rank contributes its
two boundary slabs and keeps its neighbours' (with two ranks that is exactly
what a send and a receive would move). The gathers move raw bytes (a uint8
view), so any dtype crosses either backend.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, outside autograd (the
    counterpart of ``psum(stop_gradient(t))``). ``t`` is left as it is."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSumGrad(torch.autograd.Function):
    """``y = sum over ranks of x`` with the matching backward: every rank's
    ``x`` reaches every rank's ``y``, so the gradient of ``x`` is the sum
    over ranks of the gradients of ``y``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.group), None


def all_reduce_sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of ``t`` over the ranks of ``group`` (sync
    BatchNorm's moments, a depth-sharded InstanceNorm's). Every rank must
    run the backward, in the same order, as it ran the forward."""
    return _AllReduceSumGrad.apply(t, group)


def sum_gradients(params: List[torch.Tensor], group) -> None:
    """Replace every ``p.grad`` by its sum over the ranks of ``group``: one
    all-reduce of the flattened gradients, copied back in place."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape and dtype on all ranks), in group rank
    order, moved as bytes."""
    t = t.contiguous()
    raw = t.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return [p.view(t.dtype).view(t.shape) for p in parts]


class _GatherCat(torch.autograd.Function):
    """See :func:`all_gather_cat`."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.meta = (group, dim)
        return torch.cat(_all_gather(t, group), dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.meta
        # every rank ran the gathered tensor's consumers on its own rows of
        # their result: its rows' gradient is the sum of every rank's
        return own_rows(all_reduce_sum(g.contiguous(), group), group,
                        dim), None, None


def all_gather_cat(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (the whole
    volume from its depth slabs). Differentiable: the backward gives each
    rank its own rows of the gradient summed over the ranks (a reduce
    scatter), so where every rank runs the same layers on the whole tensor
    and keeps its own rows of their output (``models/layers.py::
    gather_level``), each row's gradient reaches its owner once. Every rank
    of the group calls it in the same order, forward and backward."""
    return _GatherCat.apply(t, group, int(dim))


def own_rows(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's slab of ``t`` split evenly along ``dim`` over the ranks
    of ``group`` in rank order: the inverse of :func:`all_gather_cat`."""
    rows = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * rows, rows)


def _edges(x: torch.Tensor, axis: int, first: int, last: int) -> torch.Tensor:
    """The first ``first`` and the last ``last`` rows of ``x`` along
    ``axis``, in one tensor."""
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 0, first), x.narrow(axis, n - last, last)],
                     axis)


class _HaloExchange(torch.autograd.Function):
    """See :func:`halo_exchange`."""

    @staticmethod
    def forward(ctx, x, group, lo, hi, axis):
        ctx.meta = (group, lo, hi, axis)
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        # each rank sends its first hi rows (the previous rank's high halo)
        # and its last lo rows (the next rank's low halo)
        parts = _all_gather(_edges(x, axis, hi, lo), group)
        shape = list(x.shape)
        shape[axis] = lo
        low = (parts[rank - 1].narrow(axis, hi, lo) if rank > 0
               else x.new_zeros(shape))
        shape[axis] = hi
        high = (parts[rank + 1].narrow(axis, 0, hi) if rank < n - 1
                else x.new_zeros(shape))
        return torch.cat([low, x, high], axis)

    @staticmethod
    def backward(ctx, g):
        group, lo, hi, axis = ctx.meta
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        rows = g.shape[axis] - lo - hi
        # the low halo's gradient belongs to the previous rank's last lo
        # rows, the high halo's to the next rank's first hi rows
        parts = _all_gather(_edges(g, axis, lo, hi), group)
        dx = g.narrow(axis, lo, rows).clone()
        if rank < n - 1:
            dx.narrow(axis, rows - lo, lo).add_(parts[rank + 1].narrow(
                axis, 0, lo))
        if rank > 0:
            dx.narrow(axis, 0, hi).add_(parts[rank - 1].narrow(axis, lo, hi))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, group, lo: int, hi: int,
                  axis: int = 1) -> torch.Tensor:
    """This rank's slab of a tensor split along ``axis`` over the ranks of
    ``group`` in rank order (an NDHWC slab of the depth axis by default),
    extended by ``lo`` rows of the previous rank's slab before it and ``hi``
    rows of the next rank's after it. The first rank gets zeros below and
    the last rank zeros above: a SAME convolution's zero padding of the
    whole tensor. Differentiable: the backward adds each halo row's
    gradient into the row of the rank that owns it. Every rank of the group
    calls it in the same order, forward and backward; every slab has at
    least ``max(lo, hi)`` rows."""
    return _HaloExchange.apply(x, group, int(lo), int(hi), int(axis))
