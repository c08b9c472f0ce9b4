"""Soft-Dice losses and metrics (port of
``fetal_mri_segmentation_tpu/ops/dice.py``).

- ``dice = (2*sum(t*p) + smooth) / (sum(t) + sum(p) + smooth)`` over the
  flattened tensors, ``smooth = 1.0``; the loss is the NEGATIVE dice.
- Weighted (multi-class) dice: per-channel dice over the spatial axes with
  ``smooth = 1e-5`` and ``smooth/2`` inside the numerator, then the mean
  over channels (and over the real samples, with ``sample_mask``).

Reductions run in float32 whatever the compute dtype. Layout is
channels-first ``(B, C, D, H, W)``. The collective form
(``axis_name``, the data-parallel dice) waits for DDP (ROADMAP.md queue 1,
"DDP"): a name other than None raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _collective_ratio(locals_: dict, f, axis_name: Optional[str]
                      ) -> torch.Tensor:
    """``f(partial sums)`` on one device; the cross-device form waits for
    DDP."""
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r}: the collective dice needs DDP, not "
            "ported yet (ROADMAP.md queue 1, DDP)")
    return f(locals_)


def dice_coefficient(y_true: torch.Tensor, y_pred: torch.Tensor,
                     smooth: float = 1.0,
                     axis_name: Optional[str] = None) -> torch.Tensor:
    """Global soft Dice over the flattened tensors."""
    t = y_true.reshape(-1).float()
    p = y_pred.reshape(-1).float()
    locals_ = {"intersection": torch.sum(t * p),
               "sums": torch.sum(t) + torch.sum(p)}

    def f(g):
        return (2.0 * g["intersection"] + smooth) / (g["sums"] + smooth)

    return _collective_ratio(locals_, f, axis_name)


def dice_coefficient_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                          smooth: float = 1.0,
                          axis_name: Optional[str] = None) -> torch.Tensor:
    """Negative dice (not 1 - dice)."""
    return -dice_coefficient(y_true, y_pred, smooth=smooth,
                             axis_name=axis_name)


def weighted_dice_coefficient(y_true: torch.Tensor, y_pred: torch.Tensor,
                              axis=(-3, -2, -1), smooth: float = 1e-5,
                              axis_name: Optional[str] = None,
                              sample_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Per-channel dice over the spatial axes, mean over channels.

    ``sample_mask`` (B,): 1 for real samples, 0 for padding; masked
    samples are left out of the mean."""
    y_true = y_true.float()
    y_pred = y_pred.float()
    num = 2.0 * (torch.sum(y_true * y_pred, dim=axis) + smooth / 2.0)
    den = (torch.sum(y_true, dim=axis) + torch.sum(y_pred, dim=axis)
           + smooth)
    terms = num / den  # (B, C) for 5-D inputs
    if sample_mask is not None:
        m = sample_mask.float().reshape(
            terms.shape[:1] + (1,) * (terms.ndim - 1))
        total = torch.sum(terms * m)
        count = torch.sum(m) * (terms.numel() / terms.shape[0])
    else:
        total = torch.sum(terms)
        count = torch.full((), float(terms.numel()), device=terms.device)

    def f(g):
        return g["total"] / torch.clamp(g["count"], min=1.0)

    return _collective_ratio({"total": total, "count": count}, f, axis_name)


def weighted_dice_coefficient_loss(y_true: torch.Tensor,
                                   y_pred: torch.Tensor,
                                   axis_name: Optional[str] = None,
                                   sample_mask: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Negative weighted dice."""
    return -weighted_dice_coefficient(y_true, y_pred, axis_name=axis_name,
                                      sample_mask=sample_mask)


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
