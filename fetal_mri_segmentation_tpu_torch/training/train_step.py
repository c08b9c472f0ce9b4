"""Train and eval steps (port of
``fetal_mri_segmentation_tpu/training/train_step.py``).

One train step: augmentation on the device (``ops/augment.py``), the
forward pass (through the Hopper kernels where the config switches them on),
the dice loss, the backward pass and the Keras-style Adam update, with no
host round trip: the metrics stay on the device as 0-d tensors.

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
    dice_coefficient, dice_coefficient_loss, weighted_dice_coefficient_loss)


def get_loss_fn(config) -> Callable:
    """``loss(y, pred, sample_mask)``: the weighted dice for Isensee or
    ``n_labels > 1``, else the negative dice with padded samples' truth and
    prediction zeroed (the ragged batch's dice, exactly)."""
    if config.model_name == "isensee" or config.n_labels > 1:
        def loss(y, pred, sample_mask=None):
            return weighted_dice_coefficient_loss(y, pred,
                                                  sample_mask=sample_mask)
    else:
        def loss(y, pred, sample_mask=None):
            if sample_mask is not None:
                m = sample_mask.reshape((-1,) + (1,) * (y.ndim - 1))
                y = y * m
                pred = pred * m
            return dice_coefficient_loss(y, pred)
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
                    generator: Optional[torch.Generator] = None
                    ) -> Callable:
    """``step(state, x, y, n_valid=None) -> metrics``; updates ``state``
    (parameters, optimizer, step count) in place.

    ``generator`` draws the augmentation and Isensee2017's dropout masks
    (on the model's device); it is needed only when the config augments or
    drops. ``n_valid`` < batch masks the padded tail of a ragged batch out
    of the loss and the metrics."""
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
        if remat:
            pred = checkpoint(_forward, model, x, masks, use_reentrant=False)
        else:
            pred = _forward(model, x, masks)
        loss = loss_fn(y, pred, sample_mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            pred = pred.detach()
            metrics = {"loss": loss.detach(),
                       "dice": _masked_dice(y, pred, sample_mask)}
            metrics.update(_label_wise_metrics(config, y, pred,
                                               sample_mask))
        return metrics

    return step


def make_eval_step(model, config) -> Callable:
    """``eval_step(state, x, y, n_valid=None) -> metrics``: no augmentation,
    no gradient."""
    loss_fn = get_loss_fn(config)

    @torch.no_grad()
    def step(state, x, y, n_valid=None):
        x, y = _entry(model, x, y)
        model.eval()
        pred = _forward(model, x)
        sample_mask = _sample_mask(x, n_valid)
        metrics = {"loss": loss_fn(y, pred, sample_mask),
                   "dice": _masked_dice(y, pred, sample_mask)}
        metrics.update(_label_wise_metrics(config, y, pred, sample_mask))
        return metrics

    return step


def _sample_mask(x: torch.Tensor, n_valid) -> Optional[torch.Tensor]:
    """(B,) float mask of the real (non-padding) samples, or None."""
    if n_valid is None:
        return None
    return (torch.arange(x.shape[0], device=x.device) < n_valid).float()


def _label_wise_metrics(config, y, pred, sample_mask) -> dict:
    """``label_{i}_dice_coef`` per label, when the config asks for them and
    there is more than one label."""
    if not getattr(config, "include_label_wise_dice_coefficients", False):
        return {}
    if config.n_labels <= 1:
        return {}
    return {f"label_{i}_dice_coef": _masked_dice(
        y[:, i:i + 1], pred[:, i:i + 1], sample_mask)
        for i in range(config.n_labels)}


def _masked_dice(y, pred, sample_mask) -> torch.Tensor:
    """The batch's dice with padded samples left out exactly."""
    if sample_mask is not None:
        m = sample_mask.reshape((-1,) + (1,) * (y.ndim - 1))
        y = y * m
        pred = pred * m
    return dice_coefficient(y, pred)


def pad_batch(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad a final partial batch to ``batch_size``; returns (x, y,
    n_valid)."""
    n = x.shape[0]
    if n == batch_size:
        return x, y, n
    pad = [(0, batch_size - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad), np.pad(y, pad), n
