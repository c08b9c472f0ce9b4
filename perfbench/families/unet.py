"""3D U-Net: Cicek et al. 2016 as ellisdg/3DUnetCNN ``unet_model_3d``
builds it: per encoder level two 3^3 conv + ReLU blocks (f, then 2f
channels), 2^3 max pooling; per decoder level nearest x2 up-sampling,
concatenation [up-sampled, skip], two 3^3 conv + ReLU blocks with the
skip's channels; a 1^3 head and a sigmoid. Trained with the negative soft
Dice (the weighted Dice for more than one label)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.flops import conv_op, itemsize, voxels
from perfbench.reference import train
from perfbench.reference.models import conv, up2

NORM_CLASSES = ("InstanceNorm", "FoldedInstanceNorm", "BatchNorm")


def depth(cfg: dict) -> int:
    return int(cfg["depth"]) if cfg.get("depth") is not None else 4


def param_spec(cfg: dict, in_channels: int = 1):
    nl, nbf = int(cfg["n_labels"]), int(cfg["n_base_filters"])
    spec = []

    def block(name, cin, cout):
        spec.append((f"{name}.conv.weight", (cout, cin, 3, 3, 3)))
        spec.append((f"{name}.conv.bias", (cout,)))

    cin = in_channels
    for level in range(depth(cfg)):
        f = nbf * 2 ** level
        block(f"enc{level}_conv1", cin, f)
        block(f"enc{level}_conv2", f, 2 * f)
        cin = 2 * f
    for level in range(depth(cfg) - 2, -1, -1):
        skip = 2 * nbf * 2 ** level
        block(f"dec{level}_conv1", cin + skip, skip)
        block(f"dec{level}_conv2", skip, skip)
        cin = skip
    spec += [("head.weight", (nl, cin, 1, 1, 1)), ("head.bias", (nl,))]
    return spec


def init(name: str, shape, z):
    """Conv weights He-normal, the head's a tenth of that; biases
    N(0, 0.05^2)."""
    if len(shape) == 1:
        return 0.05 * z
    gain = 0.1 if name.startswith("head.") else 1.0
    return z * (gain * math.sqrt(2.0 / math.prod(shape[1:])))


def head_key(cfg: dict) -> str:
    return "head.bias"


def forward(p, x, cfg: dict, quant=None, dropout_masks=None):
    """x (B, C, D, H, W) float32 -> logits (B, n_labels, D, H, W)."""
    n = depth(cfg)

    def block(name, h):
        return F.relu(conv(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"],
                           quant=quant))

    skips = []
    for level in range(n):
        x = block(f"enc{level}_conv2", block(f"enc{level}_conv1", x))
        if level < n - 1:
            skips.append(x)
            x = F.max_pool3d(x, 2)
    for level in range(n - 2, -1, -1):
        x = torch.cat([up2(x), skips[level]], 1)
        x = block(f"dec{level}_conv2", block(f"dec{level}_conv1", x))
    return conv(x, p["head.weight"], p["head.bias"], quant=quant)


def ops(cfg: dict, patch, in_channels: int = 1):
    item = itemsize(cfg)
    nl, nbf = int(cfg["n_labels"]), int(cfg["n_base_filters"])
    out = []

    def vox(level):
        return voxels(patch, level)

    def add(name, level, cout, taps_in, in_vox, group="conv"):
        out.append(conv_op(name, vox(level), cout, taps_in, in_vox, item,
                           group))

    cin = in_channels
    for level in range(depth(cfg)):
        f = nbf * 2 ** level
        add(f"enc{level}_conv1", level, f, [(cin, 27)], [vox(level)])
        add(f"enc{level}_conv2", level, 2 * f, [(f, 27)], [vox(level)])
        cin = 2 * f
    for level in range(depth(cfg) - 2, -1, -1):
        skip = 2 * nbf * 2 ** level
        add(f"dec{level}_conv1", level, skip, [(cin, 8), (skip, 27)],
            [vox(level + 1), vox(level)])
        add(f"dec{level}_conv2", level, skip, [(skip, 27)], [vox(level)])
        cin = skip
    add("head", 0, nl, [(cin, 1)], [vox(0)], group=None)
    return out


def ranges():
    return {"ConvBlock": "conv", **{c: "norm" for c in NORM_CLASSES}}


def dropout_masks(generator, batch: int, cfg: dict):
    return None


def loss(y, pred, cfg: dict):
    if int(cfg["n_labels"]) > 1:
        return train.weighted_dice_loss(y, pred)
    return train.dice_loss(y, pred)
