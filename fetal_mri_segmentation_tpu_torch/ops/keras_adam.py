"""Keras Adam as one multi-tensor update (A1): the Hopper kernel and its
plain twin.

No TPU kernel is ported here: the JAX package updates in optax's XLA ops.
This replaces the port's eager update of one leaf
(:func:`keras_adam_reference`, about 13 launches a leaf: some 1,500 a step
for Isensee2017's 114 leaves) on the card::

    m <- m b1 + g (1 - b1)          v <- v b2 + (g (1 - b2)) g
    p <- p + ((m alpha) / (sqrt(v) + eps)) (-lr)

``csrc/keras_adam.cu`` computes every operation in fp32, rounded on its
own as the composite rounds it, from fp32 scalars rounded as PyTorch rounds
the composite's Python numbers (:func:`scalars`), so its p, m and v are
the composite's bit for bit.

:class:`LeafTable` holds the launch table of a group's leaves: a row of
(p, g, m, v, numel) a leaf and each leaf's step size, in host memory the C
entry reads while it launches. It is built once and kept under a stamp of
the p, m and v pointers (:func:`leaf_table`): a load that replaces the
moments (``optimizer.load_state_dict``,
``utils/params.py::load_optax_adam_state``) makes a new one. Moments that
were loaded non-contiguous are made contiguous in the optimizer's state
when it is built. At each step :func:`keras_adam` fills in the gradients'
pointers (``zero_grad(set_to_none=True)`` gives new ones every step), the
step sizes and the scalars, and makes one launch for each ``MAX_LEAVES``
leaves on the current stream (two for Isensee2017, one for the U-Net's
30). A write through a raw pointer does not bump a tensor's version, so
the stepped parameters and moments are bumped in one call afterwards, and
operands made from an old version are made again (``ops/cuda_lib.py::
cached``). The launches count in ``keras_adam.launches``, the leaves they
stepped in ``keras_adam.leaves``; while a profiler runs, each launch sits
in the host op ``PROFILER_NAME``.

The kernel takes contiguous fp32 leaves, gradients and moments on one
CUDA device, and raises on anything else; it does not fall back.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.ops import cuda_lib

MAX_LEAVES = 80  # csrc/keras_adam.cu::kMaxLeaves: leaves a launch
_ROW = 5         # csrc/keras_adam.cu::kRow: p, g, m, v, numel
_LONG = ctypes.sizeof(ctypes.c_longlong)
_FLOAT = ctypes.sizeof(ctypes.c_float)
# the host op the launches sit in while a profiler runs
PROFILER_NAME = "fetal::keras_adam"


def takes(p: torch.Tensor) -> bool:
    """Whether leaf ``p`` takes the kernel: a leaf on a CUDA device."""
    return p.is_cuda


def keras_adam_reference(p: torch.Tensor, g: torch.Tensor,
                         mu: torch.Tensor, nu: torch.Tensor, alpha: float,
                         b1: float, b2: float, eps: float,
                         lr: float) -> None:
    """One leaf's update in eager ops, in place: the CPU's route, and what
    the kernel equals bit for bit. ``alpha``: the step size of the leaf's
    count (``training/state.py::_step_size``)."""
    mu.mul_(b1).add_(g * (1 - b1))
    nu.mul_(b2).add_(g.mul(1 - b2).mul_(g))
    p.add_(mu.mul(alpha).div_(nu.sqrt().add_(eps))
           .mul_(-float(np.float32(lr))))


def scalars(b1: float, b2: float, eps: float, lr: float) -> List[float]:
    """The kernel's fp32 b1, 1 - b1, b2, 1 - b2, eps and -lr: each Python
    number of the composite rounded to fp32 once, as PyTorch rounds a
    scalar operand of an fp32 tensor."""
    return [float(np.float32(v)) for v in
            (b1, 1 - b1, b2, 1 - b2, eps, -float(np.float32(lr)))]


def _stamp(params: Sequence[torch.Tensor], states: Sequence[dict]) -> tuple:
    return tuple(t.data_ptr() for p, s in zip(params, states)
                 for t in (p, s["mu"], s["nu"]))


class LeafTable:
    """The launch table of ``params`` with the optimizer's ``states`` of
    them (``count``, ``mu``, ``nu``); see the module docstring."""

    def __init__(self, params: Sequence[torch.Tensor],
                 states: Sequence[dict]):
        device = params[0].device
        for p, s in zip(params, states):
            if p.dtype != torch.float32:
                raise TypeError(f"keras_adam: a {p.dtype} leaf of shape "
                                f"{tuple(p.shape)}; the kernel takes fp32")
            if not p.is_contiguous() or p.device != device:
                raise ValueError(
                    f"keras_adam: a leaf of shape {tuple(p.shape)} on "
                    f"{p.device}, contiguous {p.is_contiguous()}; the "
                    f"kernel takes contiguous leaves on one device "
                    f"({device})")
            for key in ("mu", "nu"):
                t = s[key]
                if (t.dtype != torch.float32 or t.shape != p.shape
                        or t.device != device):
                    raise ValueError(
                        f"keras_adam: moment {key} {t.dtype} "
                        f"{tuple(t.shape)} on {t.device} for a leaf "
                        f"{tuple(p.shape)} on {device}")
                s[key] = t.contiguous()
        n = len(params)
        self.device = params[0].get_device()
        self.stamp = _stamp(params, states)
        self.rows = (ctypes.c_longlong * (_ROW * n))()
        self.rows[0::_ROW] = [p.data_ptr() for p in params]
        self.rows[2::_ROW] = [s["mu"].data_ptr() for s in states]
        self.rows[3::_ROW] = [s["nu"].data_ptr() for s in states]
        self.rows[4::_ROW] = [p.numel() for p in params]
        self.alpha = (ctypes.c_float * n)()
        self.scalars = (ctypes.c_float * 6)()
        rows = ctypes.addressof(self.rows)
        alpha = ctypes.addressof(self.alpha)
        self.launches = [
            (min(MAX_LEAVES, n - i), rows + _ROW * _LONG * i,
             alpha + _FLOAT * i) for i in range(0, n, MAX_LEAVES)]
        # every tensor the launches write, for their version counters
        self.written = [*params, *(s["mu"] for s in states),
                        *(s["nu"] for s in states)]


def leaf_table(table, params: Sequence[torch.Tensor],
               states: Sequence[dict]) -> LeafTable:
    """``table`` while it still describes ``params`` and their moments,
    else a new :class:`LeafTable`."""
    if table is not None and table.stamp == _stamp(params, states):
        return table
    return LeafTable(params, states)


def keras_adam(table: LeafTable, grads: Sequence[torch.Tensor],
               alphas: Sequence[float], b1: float, b2: float, eps: float,
               lr: float) -> None:
    """One Keras Adam step of every leaf of ``table``, in place, with the
    leaves' gradients ``grads`` and step sizes ``alphas``: one launch for
    each ``MAX_LEAVES`` leaves on the current stream."""
    for g in grads:
        if not g.is_contiguous():
            raise ValueError(f"keras_adam: a gradient of shape "
                             f"{tuple(g.shape)} is not contiguous")
    table.rows[1::_ROW] = [g.data_ptr() for g in grads]
    table.alpha[:] = alphas
    table.scalars[:] = scalars(b1, b2, eps, lr)
    for leaves, rows, alpha in table.launches:
        cuda_lib.run("fetal_keras_adam", PROFILER_NAME,
                     (leaves, rows, alpha, ctypes.addressof(table.scalars)),
                     table.device)
    keras_adam.launches += len(table.launches)
    keras_adam.leaves += len(grads)
    torch.autograd.graph.increment_version(table.written)


keras_adam.launches = 0
keras_adam.leaves = 0
