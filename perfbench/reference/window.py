"""Plain sliding-window prediction: the patch grid, the Gaussian overlap-add
and the threshold, written from the reference's description
(ellisdg/3DUnetCNN ``unet3d/utils/patches.py`` and ``prediction.py``, with
the Gaussian importance weighting of nnU-Net), in float32 or float64.

- Corners: a grid with step ``patch - overlap`` per axis, centred on the
  volume: ``n = ceil(size / step)`` corners starting at
  ``-ceil((step * n - size + overlap) / 2)``; reads outside the volume are
  zeros.
- Weights: a separable Gaussian over the patch, sigma ``size * 0.125`` per
  axis, peak 1, floored at 1e-3; the prediction is the weighted sum of the
  patches' probabilities over the sum of the weights.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def corners(size: Sequence[int], patch: Sequence[int], overlap: int):
    axes = []
    for n, p in zip(size, patch):
        step = p - overlap
        count = math.ceil(n / step)
        start = -math.ceil((step * count - n + overlap) / 2)
        axes.append(list(range(start, start + n, step)))
    return [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


def gaussian(patch: Sequence[int], sigma_scale: float = 0.125,
             dtype=torch.float64, device=None) -> torch.Tensor:
    w = None
    for axis, n in enumerate(patch):
        x = torch.arange(n, dtype=torch.float64, device=device) - (n - 1) / 2
        g = torch.exp(-0.5 * (x / max(n * sigma_scale, 1e-8)) ** 2)
        shape = [1, 1, 1]
        shape[axis] = n
        g = g.view(shape)
        w = g if w is None else w * g
    w = w / w.max()
    return torch.clamp(w, min=1e-3).to(dtype)


def probabilities(volume: torch.Tensor, logits_fn: Callable, patch,
                  overlap: int, batch: int = 4) -> torch.Tensor:
    """volume (C, D, H, W) float32 -> sigmoid probabilities (L, D, H, W)
    in float64, overlap-added. ``logits_fn`` maps (B, C, d, h, w) float32
    patches to (B, L, d, h, w) logits."""
    size = tuple(volume.shape[1:])
    grid = corners(size, patch, overlap)
    lo = [min(c[a] for c in grid) for a in range(3)]
    hi = [max(c[a] for c in grid) + patch[a] for a in range(3)]
    pad = []
    for a in (2, 1, 0):
        pad += [-lo[a], hi[a] - size[a]]
    padded = torch.nn.functional.pad(volume, pad)
    w = gaussian(patch, device=volume.device)
    acc = wsum = None
    for i in range(0, len(grid), batch):
        chunk = grid[i:i + batch]
        win = [tuple(slice(c[a] - lo[a], c[a] - lo[a] + patch[a])
                     for a in range(3)) for c in chunk]
        x = torch.stack([padded[(slice(None),) + s] for s in win])
        prob = torch.sigmoid(logits_fn(x).double())
        if acc is None:
            acc = torch.zeros((prob.shape[1],) + padded.shape[1:],
                              dtype=torch.float64, device=volume.device)
            wsum = torch.zeros(padded.shape[1:], dtype=torch.float64,
                               device=volume.device)
        for s, pr in zip(win, prob):
            acc[(slice(None),) + s] += pr * w
            wsum[s] += w
    crop = tuple(slice(-lo[a], -lo[a] + size[a]) for a in range(3))
    return (acc / wsum.clamp(min=1e-8))[(slice(None),) + crop]


def flip_margin(labels: torch.Tensor, prob: torch.Tensor,
                threshold: float = 0.5) -> float:
    """The widest distance from the threshold of a reference probability
    (``prob``, (1, D, H, W)) whose label the map ``labels`` (D, H, W) has
    wrong; 0 where none differs."""
    ref = prob[0] > threshold
    flipped = (labels.to(ref.device) != 0) != ref
    if not bool(flipped.any()):
        return 0.0
    return float((prob[0] - threshold).abs()[flipped].max())
