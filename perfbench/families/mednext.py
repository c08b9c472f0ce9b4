"""MedNeXt: Roy et al. 2023 (arXiv:2303.09975) as the public code's
``create_mednext_v1(model_id, kernel_size)`` builds it
(github.com/MIC-DKFZ/MedNeXt, ``mednextv1/blocks.py`` and
``MedNextV1.py``): a 1^3 stem, four encoder stages of ConvNeXt-style
blocks (a depthwise k^3 conv, GroupNorm(C, C), a 1^3 conv to R C, exact
GELU, a 1^3 conv back, the residual) each followed by a down block, a
bottleneck, four decoder stages ``x = skip + up(x)`` then blocks, a 1^3
transposed-conv head, then a sigmoid. No dropout, no deep supervision.
Trained with the negative soft Dice (the weighted Dice for more than one
label). ``mednext_size`` (S, B, M, L) and ``mednext_kernel`` (3, 5) pick
the public table and the kernel.

Everything from ``SIZES`` to ``network`` is a copy of the repository's
plain reference ``reference/mednext.py`` (its docstring names each
departure from the public code), which a family file may not import;
``tests/test_torch_copies.py`` holds the two equal. Each block is
recomputed in the backward pass where a gradient is taken
(``torch.utils.checkpoint``, non-reentrant): the same mathematics,
recomputed, so that the float32 reference of a batch of two 128^3
patches (about 70 GB kept otherwise) fits on the card beside what the
program leaves allocated. ``quant`` rounds the operands of every conv
and, in training, the gradient reaching its output by e5m2
(``reference/models.py``'s float8 control, as ``models.conv`` rounds
the U-Net families').

``ops``: the depthwise convs in group ``"dwconv"`` (FLOPs 2 k^3 C per
output voxel, and per INPUT voxel for the up blocks' transposed ones;
bytes the input read, the output written and the weights); each block's
1^3 conv, GELU, 1^3 conv chain in group ``"mlp"`` (FLOPs the two GEMMs;
bytes those of a fused kernel: x read, y written and the weights, the R C
intermediates not counted); the stem, the 1^3 residual convs and the head
in no group. Norms and GELU are no tensor-core work and are not counted.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.flops import Op, conv_op, itemsize, voxels
from perfbench.reference import models, train

# create_mednext_v1's sizes: (exp_r, block_counts), 32 base channels each
SIZES = {"S": ((2,) * 9, (2,) * 9),
         "B": ((2, 3, 4, 4, 4, 4, 4, 3, 2), (2,) * 9),
         "M": ((2, 3, 4, 4, 4, 4, 4, 3, 2), (3, 4, 4, 4, 4, 4, 4, 4, 3)),
         "L": ((3, 4, 8, 8, 8, 8, 8, 4, 3), (3, 4, 8, 8, 8, 8, 8, 4, 3))}
GN_EPS = 1e-5
LEVELS = 4
# the front padding of the up blocks' outputs, (W, H, D) for NCDHW
UP_PAD = (1, 0, 1, 0, 1, 0)

Params = Dict[str, torch.Tensor]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def tables(cfg: dict) -> Tuple[tuple, tuple, int]:
    """(exp_r, block_counts, kernel) of the configured size."""
    exp_r, counts = SIZES[str(cfg.get("mednext_size", "L"))]
    return exp_r, counts, int(cfg.get("mednext_kernel", 5))


def param_spec(cfg: dict, in_channels: int = 1) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in the port's ``state_dict``
    order (the public model's module order)."""
    fs, nl = int(cfg["n_base_filters"]), int(cfg["n_labels"])
    exp_r, counts, k = tables(cfg)
    spec = [("stem.weight", (fs, in_channels, 1, 1, 1)), ("stem.bias", (fs,))]

    def block(name, cin, cout, r, res=None):
        spec.extend([(f"{name}.conv1.weight", (cin, 1, k, k, k)),
                     (f"{name}.conv1.bias", (cin,)),
                     (f"{name}.norm.scale", (cin,)),
                     (f"{name}.norm.bias", (cin,)),
                     (f"{name}.mlp.conv2.weight", (r * cin, cin, 1, 1, 1)),
                     (f"{name}.mlp.conv2.bias", (r * cin,)),
                     (f"{name}.mlp.conv3.weight", (cout, r * cin, 1, 1, 1)),
                     (f"{name}.mlp.conv3.bias", (cout,))])
        if res == "down":
            spec.extend([(f"{name}.res_conv.weight", (cout, cin, 1, 1, 1)),
                         (f"{name}.res_conv.bias", (cout,))])
        elif res == "up":
            # a transposed conv's weight is (in, out, ...)
            spec.extend([(f"{name}.res_conv.weight", (cin, cout, 1, 1, 1)),
                         (f"{name}.res_conv.bias", (cout,))])

    for i in range(LEVELS):
        c = fs * 2 ** i
        for j in range(counts[i]):
            block(f"enc_block_{i}.{j}", c, c, exp_r[i])
        block(f"down_{i}", c, 2 * c, exp_r[i + 1], "down")
    for j in range(counts[LEVELS]):
        block(f"bottleneck.{j}", fs * 2 ** LEVELS, fs * 2 ** LEVELS,
              exp_r[LEVELS])
    for i in reversed(range(LEVELS)):
        c = fs * 2 ** i
        block(f"up_{i}", 2 * c, c, exp_r[8 - i], "up")
        for j in range(counts[8 - i]):
            block(f"dec_block_{i}.{j}", c, c, exp_r[8 - i])
    spec += [("out_0.conv_out.weight", (fs, nl, 1, 1, 1)),
             ("out_0.conv_out.bias", (nl,))]
    return spec


def conv(x, w, b, quant: Callable, grad: Callable, transposed=False, **kw):
    """A conv (``transposed``: a transposed conv) with its operands passed
    through ``quant`` and its output through ``grad``."""
    op = F.conv_transpose3d if transposed else F.conv3d
    return grad(op(quant(x), quant(w), b, **kw))


def group_norm(x, scale, bias):
    """``nn.GroupNorm(C, C)`` on (B, C, D, H, W)."""
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = x.var(dim=(2, 3, 4), correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + GN_EPS)
    return y * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1)


def block(p: Params, x, name: str, k: int, quant: Callable, grad: Callable,
          kind: str = "block"):
    """``MedNeXtBlock`` (``kind`` "block"), ``MedNeXtDownBlock`` ("down")
    or ``MedNeXtUpBlock`` ("up") on (B, C, D, H, W)."""
    c = x.shape[1]
    y = conv(x, p[f"{name}.conv1.weight"], p[f"{name}.conv1.bias"], quant,
             grad, transposed=kind == "up", stride=1 if kind == "block" else 2,
             padding=k // 2, groups=c)
    y = group_norm(y, p[f"{name}.norm.scale"], p[f"{name}.norm.bias"])
    y = F.gelu(conv(y, p[f"{name}.mlp.conv2.weight"],
                    p[f"{name}.mlp.conv2.bias"], quant, grad))
    y = conv(y, p[f"{name}.mlp.conv3.weight"], p[f"{name}.mlp.conv3.bias"],
             quant, grad)
    if kind == "block":
        return x + y
    res = conv(x, p[f"{name}.res_conv.weight"], p[f"{name}.res_conv.bias"],
               quant, grad, transposed=kind == "up", stride=2)
    if kind == "down":
        return y + res
    return F.pad(y + res, UP_PAD)


def run_block(p: Params, x, name: str, k: int, quant: Callable,
              grad: Callable, kind: str = "block"):
    """:func:`block`, recomputed in the backward pass where a gradient is
    taken."""
    if torch.is_grad_enabled():
        return checkpoint(block, p, x, name, k, quant, grad, kind,
                          use_reentrant=False)
    return block(p, x, name, k, quant, grad, kind)


def network(p: Params, x: torch.Tensor, cfg: dict, quant: Callable,
            grad: Callable) -> torch.Tensor:
    """x (B, C, D, H, W) float32, each spatial size a multiple of 16 ->
    logits (B, n_labels, D, H, W)."""
    _, counts, k = tables(cfg)
    run = functools.partial(run_block, p, k=k, quant=quant, grad=grad)
    x = conv(x, p["stem.weight"], p["stem.bias"], quant, grad)
    skips = []
    for i in range(LEVELS):
        for j in range(counts[i]):
            x = run(x, f"enc_block_{i}.{j}")
        skips.append(x)
        x = run(x, f"down_{i}", kind="down")
    for j in range(counts[LEVELS]):
        x = run(x, f"bottleneck.{j}")
    for i in reversed(range(LEVELS)):
        x = skips[i] + run(x, f"up_{i}", kind="up")
        for j in range(counts[8 - i]):
            x = run(x, f"dec_block_{i}.{j}")
    return conv(x, p["out_0.conv_out.weight"], p["out_0.conv_out.bias"],
                quant, grad, transposed=True)


def forward(p: Params, x: torch.Tensor, cfg: dict,
            quant: Optional[Callable] = None,
            dropout_masks=None) -> torch.Tensor:
    """x (B, C, D, H, W) float32, each spatial size a multiple of 16 ->
    logits (B, n_labels, D, H, W). ``quant``: the control's rounding of
    the conv operands, with e5m2 gradients at the conv outputs.
    ``dropout_masks``: unused (no dropout)."""
    if quant is None:
        return network(p, x, cfg, _same, _same)
    return network(p, x, cfg, quant, models._GradFP8.apply)


# ------------------------------------------------- the family's functions


def init(name: str, shape, z):
    """Conv weights He-normal over their fan-in (a depthwise conv's k^3, a
    transposed 1^3 conv's its input channels), the head's a tenth of that;
    biases N(0, 0.05^2); norm scales 1 + N(0, 0.1^2) and biases
    N(0, 0.1^2). A depthwise conv's scale washes out in the norm after
    it."""
    if name.endswith("norm.scale"):
        return 1.0 + 0.1 * z
    if name.endswith("norm.bias"):
        return 0.1 * z
    if len(shape) == 1:
        return 0.05 * z
    transposed = name.startswith("out_0.") or (
        name.startswith("up_") and ".res_conv." in name)
    fan = shape[0] if transposed else math.prod(shape[1:])
    gain = 0.1 if name.startswith("out_0.") else 1.0
    return z * (gain * math.sqrt(2.0 / fan))


def head_key(cfg: dict) -> str:
    return "out_0.conv_out.bias"


def ops(cfg: dict, patch, in_channels: int = 1):
    item = itemsize(cfg)
    fs, nl = int(cfg["n_base_filters"]), int(cfg["n_labels"])
    exp_r, counts, k = tables(cfg)
    out = []

    def dims(level):
        return [s // 2 ** level for s in patch]

    def dwconv(name, c, v_in, v_out, per):
        out.append(Op(f"{name}.conv1", 2.0 * k ** 3 * c * per, float(item * (
            c * (v_in + v_out) + c * k ** 3 + c)), "dwconv"))

    def mlp(name, v, cin, r, cout):
        hidden = r * cin
        out.append(Op(f"{name}.mlp", 2.0 * v * hidden * (cin + cout),
                      float(item * (v * (cin + cout) + hidden * (cin + cout)
                                    + hidden + cout)), "mlp"))

    out.append(conv_op("stem", voxels(patch, 0), fs, [(in_channels, 1)],
                       [voxels(patch, 0)], item, None))
    for i in range(LEVELS):
        c, v = fs * 2 ** i, voxels(patch, i)
        for j in range(counts[i]):
            dwconv(f"enc_block_{i}.{j}", c, v, v, v)
            mlp(f"enc_block_{i}.{j}", v, c, exp_r[i], c)
        half = voxels(patch, i + 1)
        dwconv(f"down_{i}", c, v, half, half)
        mlp(f"down_{i}", half, c, exp_r[i + 1], 2 * c)
        out.append(conv_op(f"down_{i}.res_conv", half, 2 * c, [(c, 1)],
                           [half], item, None))
    c, v = fs * 2 ** LEVELS, voxels(patch, LEVELS)
    for j in range(counts[LEVELS]):
        dwconv(f"bottleneck.{j}", c, v, v, v)
        mlp(f"bottleneck.{j}", v, c, exp_r[LEVELS], c)
    for i in reversed(range(LEVELS)):
        c, r = fs * 2 ** i, exp_r[8 - i]
        v_in = voxels(patch, i + 1)
        odd = math.prod(2 * s - 1 for s in dims(i + 1))
        dwconv(f"up_{i}", 2 * c, v_in, odd, v_in)
        mlp(f"up_{i}", odd, 2 * c, r, c)
        out.append(Op(f"up_{i}.res_conv", 2.0 * v_in * 2 * c * c, float(
            item * (v_in * 2 * c + 2 * c * c + c + odd * c)), None))
        v = voxels(patch, i)
        for j in range(counts[8 - i]):
            dwconv(f"dec_block_{i}.{j}", c, v, v, v)
            mlp(f"dec_block_{i}.{j}", v, c, r, c)
    out.append(conv_op("out_0", voxels(patch, 0), nl, [(fs, 1)],
                       [voxels(patch, 0)], item, None))
    return out


def ranges():
    return {"DepthwiseConv3d": "dwconv", "PointwiseMLP": "mlp",
            "InstanceNorm": "norm"}


def dropout_masks(generator, batch: int, cfg: dict):
    return None


def loss(y, pred, cfg: dict):
    if int(cfg["n_labels"]) > 1:
        return train.weighted_dice_loss(y, pred)
    return train.dice_loss(y, pred)
