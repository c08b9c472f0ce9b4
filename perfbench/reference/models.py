"""Plain float32 forwards of the two model families, in NCDHW, written from
the published descriptions and nothing of the program.

- ``unet3d``: Cicek et al. 2016 as ellisdg/3DUnetCNN ``unet_model_3d`` builds
  it: per encoder level two 3^3 conv + ReLU blocks (f, then 2f channels),
  2^3 max pooling; per decoder level nearest x2 up-sampling, concatenation
  [up-sampled, skip], two 3^3 conv + ReLU blocks with the skip's channels;
  a 1^3 head and a sigmoid.
- ``isensee2017``: Isensee et al. 2017 (arXiv:1802.10508) as
  ``isensee2017_model`` builds it: every block a 3^3 conv (stride 2 on the
  encoder's entry below level 0), InstanceNorm (biased variance, eps 1e-3,
  learned scale and bias) and LeakyReLU(0.3); context modules with a
  residual add; up-sampling modules (nearest x2, then a conv block);
  concatenation [encoder output, up-sampled]; localization modules (3^3
  then 1^3 block); deep supervision heads summed coarsest to finest with
  nearest up-sampling between, then a sigmoid. Spatial dropout is applied
  in training only, from masks passed in.

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

Params = Dict[str, torch.Tensor]


def _depth(cfg: dict) -> int:
    if cfg.get("depth") is not None:
        return int(cfg["depth"])
    return 5 if cfg["model_name"] == "isensee" else 4


def param_spec(cfg: dict, in_channels: int = 1) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter of the configured model, in order."""
    nl, nbf = int(cfg["n_labels"]), int(cfg["n_base_filters"])
    depth = _depth(cfg)
    spec = []

    def block(name, cin, cout, k=3, norm=False):
        spec.append((f"{name}.conv.weight", (cout, cin, k, k, k)))
        spec.append((f"{name}.conv.bias", (cout,)))
        if norm:
            spec.append((f"{name}.in.scale", (cout,)))
            spec.append((f"{name}.in.bias", (cout,)))

    if cfg["model_name"] == "unet":
        cin = in_channels
        for level in range(depth):
            f = nbf * 2 ** level
            block(f"enc{level}_conv1", cin, f)
            block(f"enc{level}_conv2", f, 2 * f)
            cin = 2 * f
        for level in range(depth - 2, -1, -1):
            skip = 2 * nbf * 2 ** level
            block(f"dec{level}_conv1", cin + skip, skip)
            block(f"dec{level}_conv2", skip, skip)
            cin = skip
        spec += [("head.weight", (nl, cin, 1, 1, 1)), ("head.bias", (nl,))]
        return spec
    nseg = int(cfg.get("n_segmentation_levels", 3))
    filters = [nbf * 2 ** level for level in range(depth)]
    cin = in_channels
    for level, f in enumerate(filters):
        block(f"enc{level}_in", cin, f, norm=True)
        block(f"enc{level}_ctx1", f, f, norm=True)
        block(f"enc{level}_ctx2", f, f, norm=True)
        cin = f
    for level in range(depth - 2, -1, -1):
        f = filters[level]
        block(f"dec{level}_up", cin, f, norm=True)
        block(f"dec{level}_loc1", 2 * f, f, norm=True)
        block(f"dec{level}_loc2", f, f, k=1, norm=True)
        if level < nseg:
            spec += [(f"seg{level}.weight", (nl, f, 1, 1, 1)),
                     (f"seg{level}.bias", (nl,))]
        cin = f
    return spec


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
    depth = _depth(cfg)

    def block(name, h):
        return F.relu(conv(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"],
                           quant=quant))

    skips = []
    for level in range(depth):
        x = block(f"enc{level}_conv2", block(f"enc{level}_conv1", x))
        if level < depth - 1:
            skips.append(x)
            x = F.max_pool3d(x, 2)
    for level in range(depth - 2, -1, -1):
        x = torch.cat([up2(x), skips[level]], 1)
        x = block(f"dec{level}_conv2", block(f"dec{level}_conv1", x))
    return conv(x, p["head.weight"], p["head.bias"], quant=quant)


def isensee2017(p: Params, x: torch.Tensor, cfg: dict, quant=None,
                dropout_masks: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
    """x (B, C, D, H, W) float32 -> logits (B, n_labels, D, H, W).
    ``dropout_masks``: (B, f_L) keep-masks per level (training)."""
    depth = _depth(cfg)
    nseg = int(cfg.get("n_segmentation_levels", 3))
    rate = float(cfg.get("dropout_rate", 0.3))

    def block(name, h, stride=1):
        h = conv(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], stride,
                 quant=quant)
        h = instance_norm(h, p[f"{name}.in.scale"], p[f"{name}.in.bias"])
        return F.leaky_relu(h, 0.3)

    outs = []
    for level in range(depth):
        entry = block(f"enc{level}_in", x, 1 if level == 0 else 2)
        h = block(f"enc{level}_ctx1", entry)
        if dropout_masks is not None:
            keep = dropout_masks[level].float()[:, :, None, None, None]
            h = h * keep / (1.0 - rate)
        h = block(f"enc{level}_ctx2", h)
        x = entry + h
        outs.append(x)
    segs = {}
    for level in range(depth - 2, -1, -1):
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


def forward(p: Params, x: torch.Tensor, cfg: dict, quant=None,
            dropout_masks=None) -> torch.Tensor:
    """Logits of the configured family."""
    if cfg["model_name"] == "unet":
        return unet3d(p, x, cfg, quant)
    return isensee2017(p, x, cfg, quant, dropout_masks)
