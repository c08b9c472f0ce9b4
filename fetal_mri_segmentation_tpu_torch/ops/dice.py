"""Soft-Dice losses and metrics (port of
``fetal_mri_segmentation_tpu/ops/dice.py``).

- ``dice = (2*sum(t*p) + smooth) / (sum(t) + sum(p) + smooth)`` over the
  flattened tensors, ``smooth = 1.0``; the loss is the NEGATIVE dice.
- Weighted (multi-class) dice: per-channel dice over the spatial axes with
  ``smooth = 1e-5`` and ``smooth/2`` inside the numerator, then the mean
  over channels (and over the real samples, with ``sample_mask``).

Reductions run in float32 whatever the compute dtype. Layout is
channels-first ``(B, C, D, H, W)``.

``axis_name`` is the data-parallel form. The JAX package names a mesh axis
there; the port passes the ``torch.distributed`` process group of its data
mesh (``parallel/data_parallel.py::DataMesh.group``). The partial sums are
then summed over the ranks, so every rank holds the dice of the GLOBAL
batch, and each rank's gradient is that global dice's gradient restricted
to its own samples: the ranks' gradients add up to the single-device
gradient (``parallel/collectives.py::sum_gradients``). On a hybrid mesh
(``parallel/spatial.py``) a rank holds a depth slab of some samples and
``axis_name`` is the whole mesh's group: the flattened dice's sums add up
over slabs as they do over samples, and the weighted dice places its
per-(sample, channel) sums at their global rows (``rows``) before the sum,
so that each sample's dice is taken over its whole volume.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fetal_mri_segmentation_tpu_torch.parallel.collectives import (
    all_reduce_sum)


def _collective_ratio(locals_: dict, f, axis_name=None) -> torch.Tensor:
    """``f(global partial sums)`` under an optional process group, with a
    gradient that is this rank's exact share of the global value's.

    The globals are all-reduced outside autograd (one all-reduce of the
    stacked sums). The gradient path is the first-order surrogate
    ``sum_k (df/dg_k) * local_k`` with ``df/dg_k`` held constant, whose
    value cancels: each rank's gradient is d(global f)/d(theta) through its
    own samples only, and the sum over ranks is the global gradient. The
    partial sums may be tensors of one shape (summed elementwise)."""
    if axis_name is None:
        return f(locals_)
    keys = list(locals_)
    summed = all_reduce_sum(
        torch.stack([locals_[k].float() for k in keys]), axis_name)
    glob = dict(zip(keys, summed.unbind(0)))
    if not (torch.is_grad_enabled()
            and any(v.requires_grad for v in locals_.values())):
        return f(glob)
    with torch.enable_grad():
        leaves = {k: v.clone().requires_grad_() for k, v in glob.items()}
        value = f(leaves)
        dfdg = torch.autograd.grad(value, [leaves[k] for k in keys],
                                   allow_unused=True)
    surrogate = sum((d * locals_[k]).sum() for k, d in zip(keys, dfdg)
                    if d is not None)
    # (surrogate - surrogate) first: exactly zero, so the value is the same
    # bits on every rank, and the ranks' epoch-level decisions agree
    return value.detach() + (surrogate - surrogate.detach())


def dice_coefficient(y_true: torch.Tensor, y_pred: torch.Tensor,
                     smooth: float = 1.0,
                     axis_name=None) -> torch.Tensor:
    """Global soft Dice over the flattened tensors (over every rank's
    tensors with ``axis_name``: the dice is not linear in the batch, so a
    mean of per-rank dices would be another objective)."""
    t = y_true.reshape(-1).float()
    p = y_pred.reshape(-1).float()
    locals_ = {"intersection": torch.sum(t * p),
               "sums": torch.sum(t) + torch.sum(p)}

    def f(g):
        return (2.0 * g["intersection"] + smooth) / (g["sums"] + smooth)

    return _collective_ratio(locals_, f, axis_name)


def dice_coefficient_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                          smooth: float = 1.0,
                          axis_name=None) -> torch.Tensor:
    """Negative dice (not 1 - dice)."""
    return -dice_coefficient(y_true, y_pred, smooth=smooth,
                             axis_name=axis_name)


def weighted_dice_coefficient(y_true: torch.Tensor, y_pred: torch.Tensor,
                              axis=(-3, -2, -1), smooth: float = 1e-5,
                              axis_name=None,
                              sample_mask: Optional[torch.Tensor] = None,
                              rows=None) -> torch.Tensor:
    """Per-channel dice over the spatial axes, mean over channels.

    ``sample_mask`` (B,): 1 for real samples, 0 for padding; masked
    samples are left out of the mean. With ``axis_name`` the masked total
    and count are summed over the ranks: the mean over the global ragged
    batch. ``rows`` ``(first, total)``: these are rows [first, first + B)
    of a global batch of ``total`` samples whose depth is split over the
    ranks too (a hybrid mesh); the per-(sample, channel) sums are summed
    over ``axis_name`` at their global rows before the ratio, and
    ``sample_mask`` is then the global batch's (``total``,)."""
    y_true = y_true.float()
    y_pred = y_pred.float()
    sums = {"inter": torch.sum(y_true * y_pred, dim=axis),
            "true": torch.sum(y_true, dim=axis),
            "pred": torch.sum(y_pred, dim=axis)}

    def total_and_count(g):
        terms = (2.0 * (g["inter"] + smooth / 2.0)
                 / (g["true"] + g["pred"] + smooth))  # (B, C) for 5-D inputs
        if sample_mask is None:
            return torch.sum(terms), torch.full((), float(terms.numel()),
                                                device=terms.device)
        m = sample_mask.float().reshape(
            terms.shape[:1] + (1,) * (terms.ndim - 1))
        return (torch.sum(terms * m),
                torch.sum(m) * (terms.numel() / terms.shape[0]))

    def ratio(total, count):
        return total / torch.clamp(count, min=1.0)

    if rows is not None:
        first, total = rows
        placed = {k: F.pad(v, (0, 0, first, total - first - v.shape[0]))
                  for k, v in sums.items()}
        return _collective_ratio(
            placed, lambda g: ratio(*total_and_count(g)), axis_name)
    total, count = total_and_count(sums)
    return _collective_ratio({"total": total, "count": count},
                             lambda g: ratio(g["total"], g["count"]),
                             axis_name)


def weighted_dice_coefficient_loss(y_true: torch.Tensor,
                                   y_pred: torch.Tensor,
                                   axis_name=None,
                                   sample_mask: Optional[torch.Tensor] = None,
                                   rows=None) -> torch.Tensor:
    """Negative weighted dice."""
    return -weighted_dice_coefficient(y_true, y_pred, axis_name=axis_name,
                                      sample_mask=sample_mask, rows=rows)


def label_wise_dice_coefficient(y_true: torch.Tensor, y_pred: torch.Tensor,
                                label_index: int) -> torch.Tensor:
    """Dice of one label channel (channels-first axis 1)."""
    return dice_coefficient(y_true[:, label_index], y_pred[:, label_index])


def get_label_dice_coefficient_function(label_index: int):
    """Closure named ``label_{i}_dice_coef`` (the training log's column)."""

    def f(y_true, y_pred):
        return label_wise_dice_coefficient(y_true, y_pred, label_index)

    f.__name__ = f"label_{label_index}_dice_coef"
    return f


def hard_dice(y_true, y_pred) -> float:
    """Hard (binary) Dice on host arrays, no smoothing; empty against empty
    is 1.0."""
    t = np.asarray(y_true).astype(bool)
    p = np.asarray(y_pred).astype(bool)
    denom = t.sum() + p.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(t, p).sum() / denom)
