"""Train and eval steps (port of
``fetal_mri_segmentation_tpu/training/train_step.py``).

One train step: augmentation on the device (``ops/augment.py``), the
forward pass (through the Hopper kernels where the config switches them on),
the dice loss, the backward pass and the Keras-style Adam update, with no
host round trip: the metrics stay on the device as 0-d tensors. While a
profiler runs, a step is one ``train.step`` span (a request of
``utils/profiling.py``) around ``train.augment`` (the batch's cast, the
augmentation and the dropout masks), ``train.forward`` (the loss
included), ``train.backward`` (the gradient sum across ranks included)
and ``train.update`` (the optimizer's step).

Batches are channels-first ``(B, C, D, H, W)`` at the boundary; the step
transposes to the model's NDHWC and back. x may arrive as bf16 and y as
uint8 (the loop's compressed staging); both are cast to float32 on entry.
The train step runs the model in training mode (``model.train()``: batch
statistics for BatchNorm, Isensee2017's upsample-then-conv decoder and its
spatial dropout), the eval step in eval mode. Isensee2017's dropout masks
are drawn from the step's generator after the augmentation (the JAX step
splits one key into the two). ``config.remat`` recomputes the forward in
the backward pass (``torch.utils.checkpoint``, non-reentrant), the port of
``jax.checkpoint``: the masks are drawn before the checkpointed forward and
passed in, so the recompute drops the same channels (an explicit
generator is not restored by the checkpoint), and a model with BatchNorm
runs without remat, as in the JAX step, since the recompute would move the
running statistics twice.

``axis_name`` is the data-parallel form of both steps (the JAX steps'
``axis_name="data"``): the process group of the data mesh. The batch is
then this rank's rows of the global batch; the loss and the metrics are the
GLOBAL batch's (``ops/dice.py::_collective_ratio``), identical on every
rank; each rank's backward gives its share of the global gradient, and the
shares are SUMMED over the ranks before the optimizer steps
(``parallel/collectives.py::sum_gradients``), so the global-norm clip and
Adam see the single-device gradient on every rank.

``partition`` is the hybrid data x spatial form (``parallel/spatial.py::
HybridMesh``, the JAX GSPMD steps): every rank gets the GLOBAL batch,
augments it and draws Isensee2017's dropout masks for all of it from a
generator seeded alike on every rank (``permute`` exchanges D with H and W,
so augmentation acts before the depth is cut), then keeps its rows and its
depth slab. ``axis_name`` is then the whole mesh's group: the loss and the
metrics are the global batch's, and the ranks' gradient shares are summed
as above. The result equals the single-device step on the global batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fetal_mri_segmentation_tpu_torch.config import check_supported
from fetal_mri_segmentation_tpu_torch.models.layers import BatchNorm
from fetal_mri_segmentation_tpu_torch.ops.augment import augment_batch
from fetal_mri_segmentation_tpu_torch.ops.dice import (
    dice_coefficient, weighted_dice_coefficient_loss)
from fetal_mri_segmentation_tpu_torch.parallel.collectives import (
    sum_gradients)
from fetal_mri_segmentation_tpu_torch.utils.profiling import span


def get_loss_fn(config) -> Callable:
    """``loss(y, pred, sample_mask, axis_name, rows)``: the weighted dice
    for Isensee or ``n_labels > 1``, else the negative dice with padded
    samples' truth and prediction zeroed (the ragged batch's dice,
    exactly). With ``axis_name`` (a process group) the value is the global
    batch's on every rank. ``rows`` ``(first, total)``: y holds rows
    [first, first + B) of a global batch split in depth too (a hybrid
    mesh), and ``sample_mask`` is the global batch's."""
    if config.model_name == "isensee" or config.n_labels > 1:
        def loss(y, pred, sample_mask=None, axis_name=None, rows=None):
            return weighted_dice_coefficient_loss(
                y, pred, axis_name=axis_name, sample_mask=sample_mask,
                rows=rows)
    else:
        def loss(y, pred, sample_mask=None, axis_name=None, rows=None):
            # the negative dice, as dice_coefficient_loss computes it
            return -_masked_dice(y, pred, _local(sample_mask, rows, y),
                                 axis_name)
    return loss


def _forward(model, x_ncdhw: torch.Tensor,
             dropout_masks=None) -> torch.Tensor:
    """The model on channels-first input; channels-first output.
    ``dropout_masks``: Isensee2017's keep-masks for a training forward."""
    kw = {} if dropout_masks is None else {"dropout_masks": dropout_masks}
    return model(x_ncdhw.permute(0, 2, 3, 4, 1), **kw).permute(0, 4, 1, 2, 3)


def _entry(model, x, y):
    device = next(model.parameters()).device
    x = x.to(device, non_blocking=True)
    y = y.to(device, non_blocking=True)
    return (x if x.dtype == torch.float32 else x.float(),
            y if y.dtype == torch.float32 else y.float())


def make_train_step(model, config, *,
                    generator: Optional[torch.Generator] = None,
                    axis_name=None, partition=None,
                    debug_return_batch: bool = False) -> Callable:
    """``step(state, x, y, n_valid=None) -> metrics``; updates ``state``
    (parameters, optimizer, step count) in place.

    ``generator`` draws the augmentation and Isensee2017's dropout masks
    (on the model's device); it is needed only when the config augments or
    drops. ``n_valid`` < batch masks the padded tail of a ragged batch out
    of the loss and the metrics. ``axis_name``: the data mesh's process
    group (see the module docstring); x, y and ``n_valid`` are then this
    rank's. ``partition``: a hybrid mesh (see the module docstring); x, y
    and ``n_valid`` are then the global batch's. ``debug_return_batch``:
    the step returns ``(metrics, (x, y))`` with the batch as it was trained
    on, after augmentation (this rank's part of it)."""
    check_supported(config)
    loss_fn = get_loss_fn(config)
    do_augment = config.augment and any(
        [config.flip, config.permute, config.contrast, config.distort,
         config.rotate])
    if do_augment and generator is None:
        raise ValueError("config.augment is on: make_train_step needs a "
                         "torch.Generator on the model's device")
    needs_dropout = config.model_name == "isensee" and config.dropout_rate > 0
    if needs_dropout and generator is None:
        raise ValueError(f"dropout_rate={config.dropout_rate}: "
                         "make_train_step needs a torch.Generator on the "
                         "model's device for the dropout masks")
    remat = bool(getattr(config, "remat", False)) and not any(
        isinstance(m, BatchNorm) for m in model.modules())

    def step(state, x, y, n_valid=None):
        with span("train.step"):
            return phases(state, x, y, n_valid)

    def phases(state, x, y, n_valid):
        with span("train.augment"):
            x, y = _entry(model, x, y)
            if do_augment:
                x, y = augment_batch(generator, x, y, flip=config.flip,
                                     permute=config.permute,
                                     contrast=config.contrast,
                                     scale_deviation=config.distort,
                                     rotate=config.rotate)
            sample_mask = _sample_mask(x, n_valid)
            model.train()
            masks = (model.dropout_masks(x.shape[0], generator, x.device)
                     if needs_dropout else None)
            rows = None
            if partition is not None:
                rows = partition.row_range(x.shape[0])
                x, y = partition.shard(x, y)
                if masks is not None:
                    masks = [m[rows[0]:rows[0] + x.shape[0]] for m in masks]
        with span("train.forward"):
            if remat:
                pred = checkpoint(_forward, model, x, masks,
                                  use_reentrant=False)
            else:
                pred = _forward(model, x, masks)
            loss = loss_fn(y, pred, sample_mask, axis_name, rows)
        with span("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if axis_name is not None:
                # summed, not averaged: each rank holds its share of the
                # global loss's gradient (DistributedDataParallel would
                # divide by N)
                sum_gradients(list(model.parameters()), axis_name)
        with span("train.update"):
            state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            metrics = _metrics(config, loss.detach(), y, pred.detach(),
                               _local(sample_mask, rows, y), axis_name)
        if debug_return_batch:
            return metrics, (x, y)
        return metrics

    return step


def make_eval_step(model, config, *, partition=None) -> Callable:
    """``eval_step(state, x, y, n_valid=None, axis_name=None) -> metrics``:
    no augmentation, no gradient. ``axis_name``: the data mesh's process
    group; the metrics are then the global batch's. ``partition``: a
    hybrid mesh, as in :func:`make_train_step`."""
    loss_fn = get_loss_fn(config)

    @torch.no_grad()
    def step(state, x, y, n_valid=None, axis_name=None):
        x, y = _entry(model, x, y)
        model.eval()
        sample_mask = _sample_mask(x, n_valid)
        rows = None
        if partition is not None:
            rows = partition.row_range(x.shape[0])
            x, y = partition.shard(x, y)
        pred = _forward(model, x)
        return _metrics(config, loss_fn(y, pred, sample_mask, axis_name, rows),
                        y, pred, _local(sample_mask, rows, y), axis_name)

    return step


def _metrics(config, loss, y, pred, sample_mask, axis_name) -> dict:
    metrics = {"loss": loss,
               "dice": _masked_dice(y, pred, sample_mask, axis_name)}
    metrics.update(_label_wise_metrics(config, y, pred, sample_mask,
                                       axis_name))
    return metrics


def _local(sample_mask, rows, y):
    """This rank's rows of the global batch's ``sample_mask`` (it is this
    rank's already where there are no ``rows``)."""
    if sample_mask is None or rows is None:
        return sample_mask
    return sample_mask[rows[0]:rows[0] + y.shape[0]]


def _sample_mask(x: torch.Tensor, n_valid) -> Optional[torch.Tensor]:
    """(B,) float mask of the real (non-padding) samples, or None."""
    if n_valid is None:
        return None
    return (torch.arange(x.shape[0], device=x.device) < n_valid).float()


def _label_wise_metrics(config, y, pred, sample_mask,
                        axis_name=None) -> dict:
    """``label_{i}_dice_coef`` per label, when the config asks for them and
    there is more than one label."""
    if not getattr(config, "include_label_wise_dice_coefficients", False):
        return {}
    if config.n_labels <= 1:
        return {}
    return {f"label_{i}_dice_coef": _masked_dice(
        y[:, i:i + 1], pred[:, i:i + 1], sample_mask, axis_name)
        for i in range(config.n_labels)}


def _masked_dice(y, pred, sample_mask, axis_name=None) -> torch.Tensor:
    """The batch's dice with padded samples left out exactly."""
    if sample_mask is not None:
        m = sample_mask.reshape((-1,) + (1,) * (y.ndim - 1))
        y = y * m
        pred = pred * m
    return dice_coefficient(y, pred, axis_name=axis_name)


def pad_batch(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad a final partial batch to ``batch_size``; returns (x, y,
    n_valid)."""
    n = x.shape[0]
    if n == batch_size:
        return x, y, n
    pad = [(0, batch_size - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad), np.pad(y, pad), n
