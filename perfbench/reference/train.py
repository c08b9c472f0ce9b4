"""Plain float32 train steps: the fetal fork's augmentation, the soft-Dice
loss and Keras' Adam, written from their descriptions.

- Augmentation, per example, in the fork's order: a flip of each spatial
  axis with p = 0.5; one of the 48 symmetries of the cube, uniform (the
  reference's ``generate_permutation_keys`` / ``permute_data``: rotations
  in the (D, W) and (H, W) planes, axis flips, then an optional reversal
  of the spatial axes, the keys sorted); contrast ``x * s + t * std(x)``
  with ``s ~ U(1 - f, 1 + f)``, ``t ~ U(-f, f)`` and the population std
  over the example. The draws are redrawn here from a generator seeded as
  the program's was, in the order the program documents for its
  generator: flips (B, 3) uniforms, symmetries (B,) integers, contrast
  (2, B) uniforms.
- Loss: the family's (``perfbench/families/<model_name>.py::loss``): the
  negative soft Dice over the flattened batch, smooth 1
  (``dice_loss``), or the negative weighted Dice, the mean over (sample,
  label) of each one's Dice over its voxels, smooth 1e-5
  (``weighted_dice_loss``).
- Dropout: the family's keep-masks (``dropout_masks``), drawn from the
  same generator right after the augmentation's draws, as the program's
  step draws them.
- Adam as Keras 2 computes it: ``m <- b1 m + (1 - b1) g``,
  ``v <- b2 v + (1 - b2) g^2``, ``p <- p - lr * sqrt(1 - b2^t) /
  (1 - b1^t) * m / (sqrt(v) + 1e-7)``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import torch

from perfbench.families import family

KEYS = tuple(sorted(set(itertools.product(
    itertools.combinations_with_replacement(range(2), 2),
    range(2), range(2), range(2), range(2)))))


def symmetry(x: torch.Tensor, key) -> torch.Tensor:
    """One cube symmetry of x (C, D, H, W)."""
    (rot_y, rot_z), flip_x, flip_y, flip_z, transpose = key
    if rot_y:
        x = torch.rot90(x, rot_y, dims=(1, 3))
    if rot_z:
        x = torch.rot90(x, rot_z, dims=(2, 3))
    dims = [d for d, f in zip((1, 2, 3), (flip_x, flip_y, flip_z)) if f]
    if dims:
        x = x.flip(dims)
    if transpose:
        x = x.permute(0, 3, 2, 1)
    return x


def augment(generator, x, y, flip: bool, permute: bool, contrast):
    """x, y (B, C, D, H, W) float32, augmented per example."""
    b = x.shape[0]
    dev = generator.device
    if flip:
        flips = (torch.rand((b, 3), generator=generator, device=dev) < 0.5
                 ).tolist()
        fx, fy = [], []
        for i in range(b):
            dims = [d + 1 for d in range(3) if flips[i][d]]
            fx.append(x[i].flip(dims) if dims else x[i])
            fy.append(y[i].flip(dims) if dims else y[i])
        x, y = torch.stack(fx), torch.stack(fy)
    if permute:
        keys = torch.randint(0, len(KEYS), (b,), generator=generator,
                             device=dev).tolist()
        x = torch.stack([symmetry(x[i], KEYS[k]) for i, k in enumerate(keys)])
        y = torch.stack([symmetry(y[i], KEYS[k]) for i, k in enumerate(keys)])
    if contrast:
        u = torch.rand((2, b), generator=generator, device=dev).to(x.device)
        s = 1.0 - contrast + 2.0 * contrast * u[0]
        t = -contrast + 2.0 * contrast * u[1]
        std = x.reshape(b, -1).std(dim=1, correction=0)
        view = (b, 1, 1, 1, 1)
        x = x * s.view(view) + t.view(view) * std.view(view)
    return x.contiguous(), y.contiguous()


def dice_loss(y, pred, smooth: float = 1.0):
    t, p = y.reshape(-1), pred.reshape(-1)
    return -(2.0 * (t * p).sum() + smooth) / (t.sum() + p.sum() + smooth)


def weighted_dice_loss(y, pred, smooth: float = 1e-5):
    """y, pred (B, L, D, H, W)."""
    dims = (2, 3, 4)
    dice = (2.0 * ((y * pred).sum(dims) + smooth / 2)
            / (y.sum(dims) + pred.sum(dims) + smooth))
    return -dice.mean()


def run_steps(params: Dict[str, torch.Tensor], batches: List, cfg: dict,
              generator, quant=None) -> dict:
    """Train float32 copies of ``params`` on ``batches`` [(x, y), ...];
    returns each step's loss, the first step's gradient per leaf and the
    parameters after the last step."""
    fam = family(cfg)
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    lr = float(cfg["initial_learning_rate"])
    b1, b2, eps = 0.9, 0.999, 1e-7
    losses, first_grad = [], None
    aug = cfg.get("augment", True)
    for t, (x, y) in enumerate(batches, start=1):
        x, y = x.float(), y.float()
        if aug:
            x, y = augment(generator, x, y, cfg.get("flip", True),
                           cfg.get("permute", True), cfg.get("contrast"))
        masks = fam.dropout_masks(generator, x.shape[0], cfg)
        logits = fam.forward(p, x, cfg, quant, masks)
        loss = fam.loss(y, torch.sigmoid(logits), cfg)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(p, grads)}
        alpha = (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).add_(g * g, alpha=1 - b2)
                w.sub_(lr * alpha * m[k] / (v2[k].sqrt() + eps))
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: w.detach() for k, w in p.items()}}
