"""The plain float32 reference's model forwards, in NCDHW, written from the
published descriptions and nothing of the program: the operations the
families share (SAME conv, InstanceNorm, nearest up-sampling, the float8
rounding of the control), and lookups of the family that a
configuration's ``model_name`` names (``perfbench/families/``), which
holds each model's parameters and forward.

Parameters are a dict under the names the benchmark gives them
(``param_spec``); the same dict is loaded into the program. ``quant``, when
given, rounds each conv's input and weight before the conv and the
gradient of its output (the control's lower precision, float8); otherwise
everything is float32. SAME padding pads
``(0, 1)`` on an even extent at stride 2, as the Keras/XLA convention does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.families import family

Params = Dict[str, torch.Tensor]


def param_spec(cfg: dict, in_channels: int = 1) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter of the configured model, in order."""
    return family(cfg).param_spec(cfg, in_channels)


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 ``dtype`` with one scale per tensor (its
    largest magnitude onto ``top``, the format's largest), in float32."""
    scale = top / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(dtype).float() / scale


class _GradFP8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def quantize_fp8(x: torch.Tensor) -> torch.Tensor:
    """A conv operand as float8 training computes it: rounded to e4m3
    (``_round``) in the forward, the gradient passing through."""
    q = _round(x.detach(), torch.float8_e4m3fn, 448.0)
    return x + (q - x).detach()


def _same_pads(x: torch.Tensor, k: int, stride: int) -> list:
    pads = []
    for n in reversed(x.shape[2:]):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def conv(x, w, b, stride: int = 1, quant: Optional[Callable] = None):
    """SAME conv; with ``quant`` its operands are rounded by it, and the
    gradient reaching its output by e5m2 (float8 training: e4m3 operands
    forward, e5m2 gradients backward)."""
    if quant is not None:
        x, w = quant(x), quant(w)
    k = w.shape[-1]
    if k > 1:
        x = F.pad(x, _same_pads(x, k, stride))
    y = F.conv3d(x, w, b, stride=stride)
    return _GradFP8.apply(y) if quant is not None else y


def instance_norm(x, scale, bias, eps: float = 1e-3):
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = x.var(dim=(2, 3, 4), correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1)


def up2(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(
        2, 4)


def unet3d(p: Params, x: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """x (B, C, D, H, W) float32 -> logits (B, n_labels, D, H, W)."""
    return family({**cfg, "model_name": "unet"}).forward(p, x, cfg, quant)


def isensee2017(p: Params, x: torch.Tensor, cfg: dict, quant=None,
                dropout_masks: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
    """x (B, C, D, H, W) float32 -> logits (B, n_labels, D, H, W).
    ``dropout_masks``: (B, f_L) keep-masks per level (training)."""
    return family({**cfg, "model_name": "isensee"}).forward(
        p, x, cfg, quant, dropout_masks)


def forward(p: Params, x: torch.Tensor, cfg: dict, quant=None,
            dropout_masks=None) -> torch.Tensor:
    """Logits of the configured family."""
    return family(cfg).forward(p, x, cfg, quant, dropout_masks)
