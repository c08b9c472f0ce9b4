"""Isensee2017: Isensee et al. 2017 (arXiv:1802.10508) as ellisdg/3DUnetCNN
``isensee2017_model`` builds it: every block a 3^3 conv (stride 2 on the
encoder's entry below level 0), InstanceNorm (biased variance, eps 1e-3,
learned scale and bias) and LeakyReLU(0.3); context modules with a
residual add and SpatialDropout3D between their two blocks (training
only); up-sampling modules (nearest x2, then a conv block); concatenation
[encoder output, up-sampled]; localization modules (3^3 then 1^3 block);
deep supervision heads summed coarsest to finest with nearest up-sampling
between, then a sigmoid. Trained with the negative weighted Dice."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.flops import conv_op, itemsize, voxels
from perfbench.reference import train
from perfbench.reference.models import conv, instance_norm, up2

NORM_CLASSES = ("InstanceNorm", "FoldedInstanceNorm", "BatchNorm")


def depth(cfg: dict) -> int:
    return int(cfg["depth"]) if cfg.get("depth") is not None else 5


def filters(cfg: dict):
    return [int(cfg["n_base_filters"]) * 2 ** level
            for level in range(depth(cfg))]


def param_spec(cfg: dict, in_channels: int = 1):
    nl = int(cfg["n_labels"])
    nseg = int(cfg.get("n_segmentation_levels", 3))
    fs = filters(cfg)
    spec = []

    def block(name, cin, cout, k=3):
        spec.append((f"{name}.conv.weight", (cout, cin, k, k, k)))
        spec.append((f"{name}.conv.bias", (cout,)))
        spec.append((f"{name}.in.scale", (cout,)))
        spec.append((f"{name}.in.bias", (cout,)))

    cin = in_channels
    for level, f in enumerate(fs):
        block(f"enc{level}_in", cin, f)
        block(f"enc{level}_ctx1", f, f)
        block(f"enc{level}_ctx2", f, f)
        cin = f
    for level in range(len(fs) - 2, -1, -1):
        f = fs[level]
        block(f"dec{level}_up", cin, f)
        block(f"dec{level}_loc1", 2 * f, f)
        block(f"dec{level}_loc2", f, f, k=1)
        if level < nseg:
            spec += [(f"seg{level}.weight", (nl, f, 1, 1, 1)),
                     (f"seg{level}.bias", (nl,))]
        cin = f
    return spec


def init(name: str, shape, z):
    """Conv weights He-normal, the heads' a tenth of that; conv biases
    N(0, 0.05^2); InstanceNorm scales 1 + N(0, 0.1^2) and biases
    N(0, 0.1^2)."""
    if name.endswith("in.scale"):
        return 1.0 + 0.1 * z
    if name.endswith("in.bias"):
        return 0.1 * z
    if len(shape) == 1:
        return 0.05 * z
    gain = 0.1 if name.startswith("seg") else 1.0
    return z * (gain * math.sqrt(2.0 / math.prod(shape[1:])))


def head_key(cfg: dict) -> str:
    return "seg0.bias"


def forward(p, x, cfg: dict, quant=None, dropout_masks=None):
    """x (B, C, D, H, W) float32 -> logits (B, n_labels, D, H, W).
    ``dropout_masks``: (B, f_L) keep-masks per level (training)."""
    n = depth(cfg)
    nseg = int(cfg.get("n_segmentation_levels", 3))
    rate = float(cfg.get("dropout_rate", 0.3))

    def block(name, h, stride=1):
        h = conv(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], stride,
                 quant=quant)
        h = instance_norm(h, p[f"{name}.in.scale"], p[f"{name}.in.bias"])
        return F.leaky_relu(h, 0.3)

    outs = []
    for level in range(n):
        entry = block(f"enc{level}_in", x, 1 if level == 0 else 2)
        h = block(f"enc{level}_ctx1", entry)
        if dropout_masks is not None:
            keep = dropout_masks[level].float()[:, :, None, None, None]
            h = h * keep / (1.0 - rate)
        h = block(f"enc{level}_ctx2", h)
        x = entry + h
        outs.append(x)
    segs = {}
    for level in range(n - 2, -1, -1):
        x = block(f"dec{level}_up", up2(x))
        x = torch.cat([outs[level], x], 1)
        x = block(f"dec{level}_loc2", block(f"dec{level}_loc1", x))
        if level < nseg:
            segs[level] = conv(x, p[f"seg{level}.weight"],
                               p[f"seg{level}.bias"], quant=quant)
    out = None
    for level in reversed(range(nseg)):
        out = segs[level] if out is None else out + segs[level]
        if level > 0:
            out = up2(out)
    return out


def ops(cfg: dict, patch, in_channels: int = 1):
    item = itemsize(cfg)
    nl = int(cfg["n_labels"])
    nseg = int(cfg.get("n_segmentation_levels", 3))
    fs = filters(cfg)
    out = []

    def vox(level):
        return voxels(patch, level)

    def add(name, level, cout, taps_in, in_vox, group="conv"):
        out.append(conv_op(name, vox(level), cout, taps_in, in_vox, item,
                           group))

    cin = in_channels
    for level, f in enumerate(fs):
        src = vox(level - 1) if level else vox(0)
        add(f"enc{level}_in", level, f, [(cin, 27)], [src])
        add(f"enc{level}_ctx1", level, f, [(f, 27)], [vox(level)])
        add(f"enc{level}_ctx2", level, f, [(f, 27)], [vox(level)])
        cin = f
    for level in range(len(fs) - 2, -1, -1):
        f = fs[level]
        add(f"dec{level}_up", level, f, [(cin, 8)], [vox(level + 1)])
        add(f"dec{level}_loc1", level, f, [(2 * f, 27)], [vox(level)])
        add(f"dec{level}_loc2", level, f, [(f, 1)], [vox(level)])
        if level < nseg:
            add(f"seg{level}", level, nl, [(f, 1)], [vox(level)], group=None)
        cin = f
    return out


def ranges():
    return {"ConvBlock": "conv", **{c: "norm" for c in NORM_CLASSES}}


def dropout_masks(generator, batch: int, cfg: dict):
    """One (batch, f_L) keep-mask per level, drawn from ``generator`` in
    level order, each (sample, channel) kept where its uniform is below
    1 - rate: ``models/layers.py::draw_dropout_masks``'s draws, which the
    program's train step makes right after the augmentation's
    (``training/train_step.py``). None without dropout."""
    rate = float(cfg.get("dropout_rate", 0.3))
    if rate <= 0:
        return None
    return [torch.rand((batch, f), generator=generator,
                       device=generator.device) < 1.0 - rate
            for f in filters(cfg)]


def loss(y, pred, cfg: dict):
    return train.weighted_dice_loss(y, pred)
