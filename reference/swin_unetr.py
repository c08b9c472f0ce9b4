"""Swin UNETR (Hatamizadeh et al. 2022, arXiv:2201.01266) as MONAI's
``monai/networks/nets/swin_unetr.py::SwinUNETR`` builds it by default, in
plain float32 PyTorch over a dict of parameters named as MONAI's
``state_dict`` names them (``param_spec``).

- Patch embedding: ``Conv3d(in, F, k=2, s=2)`` with bias (F the feature
  size, 48 by default).
- Four stages of ``DEPTHS`` Swin blocks at F, 2F, 4F, 8F channels with
  ``HEADS`` heads of ``dim / heads`` channels, each stage followed by patch
  merging. A block::

      x = x + attn(pad(roll(LN1(x))))     # cropped and rolled back
      x = x + MLP(LN2(x))                 # Linear(C, 4C), exact GELU, Linear(4C, C)

  LayerNorms with eps 1e-5. Zeros are padded after ``LN1`` up to a multiple
  of the window (7); the padded tokens are attended to and not masked. The
  second block of a stage rolls by -3 on each axis before the attention and
  by +3 after it, with the shift mask (-100 between regions of the padded
  grid, MONAI's ``compute_mask``). Where an axis is at most 7 long the window
  is that length on that axis and the block does not shift there.
- Attention in a window: ``softmax(q k^T / sqrt(d) + B + M) v`` then
  ``Linear(C, C)``; q, k, v from ``Linear(C, 3C)`` with bias; B a learned
  table of 13^3 x heads per block, indexed by relative position.
- Patch merging: MONAI's v1 ``PatchMerging`` (``downsample="merging"``,
  the default): eight strided slices concatenated at the offsets
  ``MERGE_OFFSETS``, then ``LayerNorm(8C)`` and ``Linear(8C, 2C)`` without
  bias.
- Encoder outputs: a LayerNorm without affine of the patch embedding and of
  each stage's merged output (F at 1/2, 2F at 1/4, 4F at 1/8, 8F at 1/16 and
  16F at 1/32 of the input).
- UNETR blocks: ``UnetResBlock``s (3^3 convs without bias, InstanceNorm
  with eps 1e-5 and no affine, LeakyReLU 0.01; a 1^3 conv and norm on the
  skip where the channels change) on the input and on hidden states 0, 1,
  2 and 4; up blocks a ``ConvTranspose3d(k=2, s=2)`` without bias, the
  concatenation [up-sampled, skip] and a residual block; the head a 1^3
  conv with bias.

Departures from MONAI's code, each deliberate:

- MONAI's ``WindowAttention`` takes ``relative_position_index[:n, :n]`` of
  the 7^3 window's index where a clipped window has n < 343 tokens (the 6^3
  last stage of a 96^3 patch): the first n positions of the 7^3 grid, not
  the clipped window's own relative positions. This reference does the
  same, so that MONAI's weights mean the same here; it is a quirk of
  MONAI's (and of the original Swin code's), not of the paper.
- The v1 merge order repeats two offsets (the sixth and seventh slices
  equal the third and fourth) and never takes (1, 1, 0) or (0, 1, 1);
  MONAI keeps it for its released weights, and so does this reference.
  ``PatchMergingV2``'s ``itertools.product`` order is not taken.
- No dropout, drop-path or checkpointing: MONAI's defaults are 0.
- InstanceNorm is written out (biased variance): at a 32^3 patch the
  deepest state is 1^3, where ``F.instance_norm`` (and so MONAI) raises,
  and the equation gives 0.
- ``quant``, when given, rounds the operands of every conv, linear and of
  the two attention matmuls (the benchmark's float8 control); MONAI has no
  such hook.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

WINDOW = 7
PATCH = 2
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)
MLP_RATIO = 4
LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01
MERGE_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
                 (0, 1, 0), (0, 0, 1), (1, 1, 1))

Params = Dict[str, torch.Tensor]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def param_spec(cfg: dict, in_channels: int = 1) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in MONAI's ``state_dict`` order."""
    fs, nl = int(cfg["n_base_filters"]), int(cfg["n_labels"])
    table = (2 * WINDOW - 1) ** 3
    spec = [("swinViT.patch_embed.proj.weight", (fs, in_channels) + (PATCH,) * 3),
            ("swinViT.patch_embed.proj.bias", (fs,))]
    for stage, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        dim, pre = fs * 2 ** stage, f"swinViT.layers{stage + 1}.0"
        hidden = dim * MLP_RATIO
        for j in range(depth):
            b = f"{pre}.blocks.{j}"
            spec += [(f"{b}.norm1.weight", (dim,)), (f"{b}.norm1.bias", (dim,)),
                     (f"{b}.attn.relative_position_bias_table", (table, heads)),
                     (f"{b}.attn.qkv.weight", (3 * dim, dim)),
                     (f"{b}.attn.qkv.bias", (3 * dim,)),
                     (f"{b}.attn.proj.weight", (dim, dim)),
                     (f"{b}.attn.proj.bias", (dim,)),
                     (f"{b}.norm2.weight", (dim,)), (f"{b}.norm2.bias", (dim,)),
                     (f"{b}.mlp.linear1.weight", (hidden, dim)),
                     (f"{b}.mlp.linear1.bias", (hidden,)),
                     (f"{b}.mlp.linear2.weight", (dim, hidden)),
                     (f"{b}.mlp.linear2.bias", (dim,))]
        spec += [(f"{pre}.downsample.reduction.weight", (2 * dim, 8 * dim)),
                 (f"{pre}.downsample.norm.weight", (8 * dim,)),
                 (f"{pre}.downsample.norm.bias", (8 * dim,))]

    def res(name, cin, cout):
        spec.append((f"{name}.conv1.conv.weight", (cout, cin, 3, 3, 3)))
        spec.append((f"{name}.conv2.conv.weight", (cout, cout, 3, 3, 3)))
        if cin != cout:
            spec.append((f"{name}.conv3.conv.weight", (cout, cin, 1, 1, 1)))

    for name, c in (("encoder1", None), ("encoder2", fs), ("encoder3", 2 * fs),
                    ("encoder4", 4 * fs), ("encoder10", 16 * fs)):
        res(f"{name}.layer", in_channels if c is None else c,
            fs if c is None else c)
    for name, cin, cout in up_blocks(fs):
        spec.append((f"{name}.transp_conv.conv.weight", (cin, cout, 2, 2, 2)))
        res(f"{name}.conv_block", 2 * cout, cout)
    spec += [("out.conv.conv.weight", (nl, fs, 1, 1, 1)),
             ("out.conv.conv.bias", (nl,))]
    return spec


def up_blocks(fs: int):
    """(name, input channels, output channels) of the up blocks, deepest
    first."""
    return (("decoder5", 16 * fs, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
            ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs),
            ("decoder1", fs, fs))


def window_and_shift(size, shift: int):
    """MONAI's ``get_window_size``: per axis the window (``WINDOW``, or the
    axis's length where it is at most ``WINDOW``) and the shift (0 where the
    window was clipped)."""
    window = tuple(min(s, WINDOW) for s in size)
    return window, tuple(0 if s <= WINDOW else shift for s in size)


def relative_position_index(window=(WINDOW,) * 3) -> torch.Tensor:
    """(n, n) index into the (2w-1)^3 table of each pair of a window's
    tokens, MONAI's ``WindowAttention`` construction."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in window], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in window])
    wd, wh, ww = window
    rel = rel * torch.tensor([(2 * wh - 1) * (2 * ww - 1), 2 * ww - 1, 1])
    return rel.sum(-1)


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, windows, tokens, C), windows in (d, h, w)
    order, tokens row-major in the window."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, wd * wh * ww, c)


def window_reverse(x: torch.Tensor, window, dims) -> torch.Tensor:
    """The inverse of :func:`window_partition` onto the grid ``dims``."""
    b, c = x.shape[0], x.shape[-1]
    d, h, w = dims
    wd, wh, ww = window
    x = x.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def shift_mask(dims, window, shift) -> torch.Tensor:
    """(windows, n, n) float mask of the shifted block on the padded grid
    ``dims``: 0 between tokens of one region, -100 between regions (MONAI's
    ``compute_mask``)."""
    img = torch.zeros((1,) + tuple(dims) + (1,))
    cnt = 0
    axes = [(slice(-w), slice(-w, -s), slice(-s, None))
            for w, s in zip(window, shift)]
    for a in axes[0]:
        for b in axes[1]:
            for c in axes[2]:
                img[:, a, b, c, :] = cnt
                cnt += 1
    ids = window_partition(img, window)[0, :, :, 0]
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def layer_norm(x, weight=None, bias=None):
    return F.layer_norm(x, (x.shape[-1],), weight, bias, LN_EPS)


def linear(x, w, b, quant: Callable):
    return F.linear(quant(x), quant(w), b)


def attention(q, k, v, bias, quant: Callable):
    """q, k, v (B, windows, heads, n, d); ``bias`` broadcast onto the
    (B, windows, heads, n, n) scores."""
    scores = (quant(q) * q.shape[-1] ** -0.5) @ quant(k).transpose(-1, -2)
    return quant(torch.softmax(scores + bias, -1)) @ quant(v)


def swin_block(p: Params, x, name: str, heads: int, shifted: bool,
               quant: Callable):
    """One block on (B, D, H, W, C)."""
    b, d, h, w, c = x.shape
    window, shift = window_and_shift((d, h, w), WINDOW // 2 if shifted else 0)
    y = layer_norm(x, p[f"{name}.norm1.weight"], p[f"{name}.norm1.bias"])
    pads = [(-s) % k for s, k in zip((d, h, w), window)]
    y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dims = tuple(y.shape[1:4])
    n = math.prod(window)
    table = p[f"{name}.attn.relative_position_bias_table"]
    index = relative_position_index()[:n, :n].to(table.device)
    bias = table[index.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
    if any(shift):
        y = torch.roll(y, [-s for s in shift], (1, 2, 3))
        bias = bias + shift_mask(dims, window, shift).to(x.device)[:, None]
    win = window_partition(y, window)
    nw = win.shape[1]
    qkv = linear(win, p[f"{name}.attn.qkv.weight"], p[f"{name}.attn.qkv.bias"],
                 quant)
    qkv = qkv.reshape(b, nw, n, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5)
    out = attention(qkv[0], qkv[1], qkv[2], bias, quant)
    out = out.transpose(2, 3).reshape(b, nw, n, c)
    out = linear(out, p[f"{name}.attn.proj.weight"],
                 p[f"{name}.attn.proj.bias"], quant)
    y = window_reverse(out, window, dims)
    if any(shift):
        y = torch.roll(y, list(shift), (1, 2, 3))
    x = x + y[:, :d, :h, :w]
    y = layer_norm(x, p[f"{name}.norm2.weight"], p[f"{name}.norm2.bias"])
    y = F.gelu(linear(y, p[f"{name}.mlp.linear1.weight"],
                      p[f"{name}.mlp.linear1.bias"], quant))
    return x + linear(y, p[f"{name}.mlp.linear2.weight"],
                      p[f"{name}.mlp.linear2.bias"], quant)


def merge(p: Params, x, name: str, quant: Callable):
    """MONAI's v1 ``PatchMerging`` on (B, D, H, W, C)."""
    d, h, w = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE_OFFSETS], -1)
    x = layer_norm(x, p[f"{name}.norm.weight"], p[f"{name}.norm.bias"])
    return F.linear(quant(x), quant(p[f"{name}.reduction.weight"]))


def encoder(p: Params, x, cfg: dict, quant: Callable) -> list:
    """x (B, C, D, H, W) -> the five hidden states, (B, C_i, D_i, H_i,
    W_i)."""
    h = F.conv3d(quant(x), quant(p["swinViT.patch_embed.proj.weight"]),
                 p["swinViT.patch_embed.proj.bias"], stride=PATCH)
    h = h.permute(0, 2, 3, 4, 1)
    states = [layer_norm(h)]
    for stage, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        pre = f"swinViT.layers{stage + 1}.0"
        for j in range(depth):
            h = swin_block(p, h, f"{pre}.blocks.{j}", heads, j % 2 == 1,
                           quant)
        h = merge(p, h, f"{pre}.downsample", quant)
        states.append(layer_norm(h))
    return [s.permute(0, 4, 1, 2, 3) for s in states]


def res_block(p: Params, x, name: str, quant: Callable):
    """MONAI's ``UnetResBlock`` on (B, C, D, H, W)."""
    def conv(t, key, k):
        return F.conv3d(quant(t), quant(p[key]), padding=k // 2)

    def norm(t):
        mean = t.mean(dim=(2, 3, 4), keepdim=True)
        var = t.var(dim=(2, 3, 4), correction=0, keepdim=True)
        return (t - mean) * torch.rsqrt(var + IN_EPS)

    y = F.leaky_relu(norm(conv(x, f"{name}.conv1.conv.weight", 3)), SLOPE)
    y = norm(conv(y, f"{name}.conv2.conv.weight", 3))
    key = f"{name}.conv3.conv.weight"
    skip = norm(conv(x, key, 1)) if key in p else x
    return F.leaky_relu(y + skip, SLOPE)


def up_block(p: Params, x, skip, name: str, quant: Callable):
    up = F.conv_transpose3d(quant(x), quant(p[f"{name}.transp_conv.conv.weight"]),
                            stride=2)
    return res_block(p, torch.cat([up, skip], 1), f"{name}.conv_block", quant)


def forward(p: Params, x: torch.Tensor, cfg: dict,
            quant: Optional[Callable] = None,
            dropout_masks=None) -> torch.Tensor:
    """x (B, C, D, H, W) float32, each spatial size a multiple of 32 ->
    logits (B, n_labels, D, H, W). ``dropout_masks``: unused (no
    dropout)."""
    quant = quant or _same
    hs = encoder(p, x, cfg, quant)
    enc = [res_block(p, x, "encoder1.layer", quant)]
    for i, name in enumerate(("encoder2", "encoder3", "encoder4")):
        enc.append(res_block(p, hs[i], f"{name}.layer", quant))
    y = res_block(p, hs[4], "encoder10.layer", quant)
    skips = [hs[3]] + enc[::-1]
    for (name, _, _), skip in zip(up_blocks(int(cfg["n_base_filters"])),
                                  skips):
        y = up_block(p, y, skip, name, quant)
    return F.conv3d(quant(y), quant(p["out.conv.conv.weight"]),
                    p["out.conv.conv.bias"])
