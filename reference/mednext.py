"""MedNeXt (Roy et al. 2023, arXiv:2303.09975) as the public code builds
it (github.com/MIC-DKFZ/MedNeXt, ``nnunet_mednext/network_architecture/
mednextv1/blocks.py`` and ``MedNextV1.py``, through ``create_mednext_v1(
model_id, kernel_size)``: ``norm_type='group'``, ``do_res=True``,
``do_res_up_down=True``, ``grn=False``, ``deep_supervision=False``), in
plain float32 PyTorch over a dict of parameters (``param_spec``).

- Block (C -> C, expansion R, kernel k)::

      x1 = Conv3d(C, C, k, padding=k // 2, groups=C)(x)   # depthwise, bias
      x1 = GELU(Conv3d(C, R C, 1)(GroupNorm(C, C)(x1)))   # exact GELU
      out = x + Conv3d(R C, C, 1)(x1)

- Down block (C -> 2C): the block without its own residual, its depthwise
  conv at stride 2 and its last conv writing 2C, plus
  ``Conv3d(C, 2C, 1, stride=2)(x)``.
- Up block (2C -> C): the block without its own residual, its depthwise
  conv ``ConvTranspose3d(2C, 2C, k, stride=2, padding=k // 2,
  groups=2C)`` (an odd extent, 2n - 1), plus
  ``ConvTranspose3d(2C, C, 1, stride=2)(x)``; each of the two padded by one
  zero voxel at the front of every spatial axis, then added.
- Network: stem ``Conv3d(in, F, 1)``; four encoder stages at F, 2F, 4F and
  8F channels, each followed by a down block; a bottleneck at 16F; four
  decoder stages, each ``x = skip + up(x)`` then its blocks; the head
  ``ConvTranspose3d(F, n_labels, 1)``. Level i's blocks and down block
  expand by ``exp_r[i]`` and ``exp_r[i + 1]``, the bottleneck by
  ``exp_r[4]``, up block j and decoder stage j by ``exp_r[5 + j]``; stage
  s holds ``block_counts[s]`` blocks (``SIZES``).
- GroupNorm(C, C) is, per sample and channel, the mean and the biased
  variance over the voxels, eps 1e-5 inside the root, then a learned
  scale and bias per channel: written out here as those operations.

Departures from the public code, each deliberate:

- Parameters are named as the port's ``state_dict`` names them: the norm's
  ``weight`` is ``norm.scale``, and a block's two 1^3 convs sit under
  ``mlp`` (``mlp.conv2``, ``mlp.conv3``). The published model's
  ``dummy_tensor`` (a parameter that only works around a checkpointing
  bug and takes no part in the mathematics) is left out.
- No deep supervision: ``create_mednext_v1`` builds without it by
  default; the paper trains with nnU-Net's deep-supervision loss.
- Each block is recomputed in the backward pass
  (``torch.utils.checkpoint``, non-reentrant) wherever a gradient is
  taken: the same mathematics, recomputed, so that a batch of two 128^3
  patches fits beside what the program leaves allocated on one card. The
  published L model checkpoints outside each block as well.
- Each up block adds its two branches before the padding, which is
  exactly the padded sum: the padding is zeros.
- ``quant``, when given, rounds the operands of every conv and
  ``grad`` rounds the gradient reaching each conv's output (the
  benchmark's float8 control); the public code has no such hooks.

Float32 throughout: on a card the caller turns TF32 off
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False), as the benchmark's
traffic does before it runs the reference.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
            grad: Optional[Callable] = None) -> torch.Tensor:
    """x (B, C, D, H, W) float32 -> logits (B, n_labels, D, H, W).
    ``cfg``: ``n_base_filters``, ``n_labels``, ``mednext_size`` (S, B, M or
    L; L by default) and ``mednext_kernel`` (3 or 5; 5 by default)."""
    return network(p, x, cfg, quant or _same, grad or _same)
