"""The two all-reduces of data-parallel training, over a
``torch.distributed`` process group.

Where the JAX package names a mesh axis (``axis_name="data"``) and lets XLA
insert ``psum``, the port passes the process group of its data mesh
(``parallel/data_parallel.py::DataMesh.group``) and calls
``torch.distributed.all_reduce`` itself. Both functions sum float32 tensors
and leave the same value on every rank; NCCL and gloo both take them (gloo
also for CUDA tensors, staged through the host).
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
    BatchNorm's moments). Every rank must run the backward, in the same
    order, as it ran the forward."""
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
