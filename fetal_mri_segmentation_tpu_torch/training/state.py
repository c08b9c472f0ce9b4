"""Training state and the Keras-style Adam (port of
``fetal_mri_segmentation_tpu/training/state.py``).

:class:`KerasAdam` computes the update of the JAX package's
``scale_by_keras_adam`` chained with ``scale_by_learning_rate``::

    m <- b1 m + (1 - b1) g          v <- b2 v + (1 - b2) g g
    alpha = sqrt(1 - b2^t) / (1 - b1^t)
    p <- p + (alpha m / (sqrt(v) + eps)) * (-lr)

with eps = 1e-7 added to the UNCORRECTED sqrt(v), which ``torch.optim.Adam``
does not compute. ``alpha`` and ``lr`` are float32 numbers, as the JAX
package computes them on the device. An optional ``clip_norm`` applies
optax's ``clip_by_global_norm`` to the gradients first. The learning rate
is set at run time with :meth:`KerasAdam.set_learning_rate` (the epoch-level
schedules). Parameters change in place under ``torch.no_grad()``, which
bumps their version counters, so operands the kernels prepared from an old
version are made again (``ops/cuda_lib.py::cached``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import numpy as np
import torch
from torch import nn


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: every gradient scaled by
    ``max_norm / ||g||`` when the global norm ``||g||`` reaches
    ``max_norm``; decided on the device, with no host round trip."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _step_size(count: int, b1: float, b2: float) -> float:
    """alpha(t) in float32, as ``scale_by_keras_adam`` computes it."""
    t = np.float32(count)
    one = np.float32(1.0)
    return float(np.sqrt(one - np.float32(b2) ** t)
                 / (one - np.float32(b1) ** t))


class KerasAdam(torch.optim.Optimizer):
    """Adam with the Keras epsilon (see the module docstring).

    State per parameter: ``count`` (steps taken), ``mu`` and ``nu`` (the
    optax ``ScaleByAdamState`` moments)."""

    def __init__(self, params: Iterable, lr: float = 5e-4,
                 betas=(0.9, 0.999), eps: float = 1e-7,
                 clip_norm: Optional[float] = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        self.clip_norm = clip_norm

    @property
    def learning_rate(self) -> float:
        return float(self.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float) -> None:
        for group in self.param_groups:
            group["lr"] = float(lr)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm)
        grad_of = dict(zip(map(id, params), grads))
        for group in self.param_groups:
            b1, b2 = group["betas"]
            neg_lr = -float(np.float32(group["lr"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = grad_of[id(p)]
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["count"] += 1
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_(g * (1 - b1))
                nu.mul_(b2).add_(g.mul(1 - b2).mul_(g))
                alpha = _step_size(state["count"], b1, b2)
                p.add_(mu.mul(alpha).div_(nu.sqrt().add_(group["eps"]))
                       .mul_(neg_lr))
        return loss


def make_optimizer(params: Iterable, initial_learning_rate: float,
                   clip_norm: Optional[float] = None) -> KerasAdam:
    """Adam with a run-time learning rate, after an optional global-norm
    clip (the JAX package's ``make_optimizer``)."""
    return KerasAdam(params, lr=initial_learning_rate, clip_norm=clip_norm)


@dataclasses.dataclass
class TrainState:
    """The model (parameters), its optimizer and the step count. The train
    step updates all three in place. The optimizer holds the parameters
    only; BatchNorm's running statistics are the model's buffers, moved by
    its training forward and saved with its ``state_dict``."""

    model: nn.Module
    optimizer: KerasAdam
    step: int = 0

    @property
    def learning_rate(self) -> float:
        return self.optimizer.learning_rate

    def set_learning_rate(self, lr: float) -> "TrainState":
        self.optimizer.set_learning_rate(lr)
        return self


def create_train_state(model: nn.Module, config,
                       clip_norm: Optional[float] = None) -> TrainState:
    """A fresh state over ``model``'s current parameters, Adam at
    ``config.initial_learning_rate``."""
    return TrainState(model, make_optimizer(
        model.parameters(), config.initial_learning_rate, clip_norm))
