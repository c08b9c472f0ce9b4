"""Swin UNETR (Hatamizadeh et al. 2022, arXiv:2201.01266) as MONAI's
``monai/networks/nets/swin_unetr.py::SwinUNETR`` builds it by default, in
the port's NDHWC layout. The JAX package has no such model; the plain
float32 reference it is held to is ``reference/swin_unetr.py`` at the
repository's root, which names each departure from MONAI's code.

- Encoder (``SwinTransformer``): a 2^3 stride-2 patch embedding to F
  channels, four stages of two Swin blocks (``DEPTHS``, ``HEADS`` heads of
  ``dim / heads`` channels, window ``WINDOW``^3, the second block shifted
  by ``WINDOW // 2``, MLP ratio ``MLP_RATIO``, exact GELU), each followed by
  MONAI's v1 patch merging (``MERGE_OFFSETS``); the five hidden states are
  LayerNorms without affine of the embedding and of each merged output.
- Decoder: UNETR residual blocks (``UnetResBlock``: ``ConvBlock``s of
  ``models/layers.py`` without conv bias, InstanceNorm eps 1e-5 without
  affine, LeakyReLU 0.01) on the input and on hidden states 0, 1, 2 and 4;
  up blocks (a 2^3 stride-2 transposed conv without bias, [up-sampled,
  skip], a residual block); an fp32 1^3 head with bias.

Constants are MONAI's ``SwinUNETR`` defaults; ``feature_size`` is the
config's ``n_base_filters`` (48 by default in MONAI, a multiple of 12).
Every spatial size of the input must be a multiple of 32. Module and
parameter names are MONAI's, so a MONAI ``state_dict`` loads once its
``relative_position_index`` buffers (persistent in MONAI, rebuilt here)
are dropped.

Compute runs in ``dtype`` (bf16 by default): LayerNorm and InstanceNorm
statistics in fp32, the attention's softmax in fp32 on the composite route
(``ops/window_attention.py``). The residual blocks' norms run through
``layers.InstanceNorm``, so on a CUDA tensor outside autograd they are the
fused kernel ``ops/instance_norm.py::instance_norm_act`` (LeakyReLU fused
after the first norm of a block). Outside autograd each parameter is
cast to the compute dtype once per version (``ops/cuda_lib.py::cached``),
and so is each block's attention bias (the table gathered, the shift mask
added). The relative-position index and the shift masks are non-persistent
buffers: those of the configured patch at construction, others at first
use.

Spans (``utils/profiling.py``, while a profiler runs): ``swin.encoder``
(the patch embedding through the hidden states' norms) and
``swin.decoder`` (the UNETR blocks and the head), inside the sliding
window's ``window.model``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fetal_mri_segmentation_tpu_torch.models.layers import (
    ConvBlock, head_activation)
from fetal_mri_segmentation_tpu_torch.ops import window_attention as wa
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import conv3d_ndhwc
from fetal_mri_segmentation_tpu_torch.ops.cuda_lib import cached
from fetal_mri_segmentation_tpu_torch.utils.profiling import span

# MONAI SwinUNETR's defaults
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)
WINDOW = wa.WINDOW
PATCH = 2
MLP_RATIO = 4
LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01
# MONAI's v1 PatchMerging (downsample="merging"): the sixth and seventh
# slices repeat the third and fourth
MERGE_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
                 (0, 1, 0), (0, 0, 1), (1, 1, 1))
# the patch embedding and four merges halve each axis five times
MULTIPLE = 2 ** 5


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype):
    """``p`` in ``dtype`` under ``cached``'s rule; None passes through."""
    if p is None:
        return None
    return cached(p, ("dtype", dtype), lambda t: t.to(dtype))


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, _cast(lin.weight, x.dtype), _cast(lin.bias, x.dtype))


def _layer_norm(x: torch.Tensor, norm: Optional[nn.LayerNorm] = None):
    w = b = None
    if norm is not None:
        w, b = _cast(norm.weight, x.dtype), _cast(norm.bias, x.dtype)
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def init_parameters(model: nn.Module, seed: int = 0) -> None:
    """Every parameter of ``model`` drawn afresh from a CPU generator seeded
    with ``seed``, in ``named_parameters`` order, as PyTorch's modules and
    MONAI initialize them: conv and linear weights and biases U(-b, b),
    b = 1 / sqrt(fan_in) (PyTorch's default), LayerNorm scales 1 and
    biases 0, the relative-position tables N(0, 0.02^2) clipped at two
    standard deviations (MONAI's truncated normal). The same seed gives
    the same model on any device."""
    gen = torch.Generator().manual_seed(int(seed))
    modules = dict(model.named_modules())
    fans = {}
    for name, module in modules.items():
        if isinstance(module, (nn.Linear, nn.Conv3d, nn.ConvTranspose3d)):
            w = module.weight
            fan = w.shape[1] * math.prod(w.shape[2:])
            fans[name + ".weight"] = fans[name + ".bias"] = fan
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = modules[name.rsplit(".", 1)[0]]
            if name.endswith("relative_position_bias_table"):
                v = (0.02 * torch.randn(p.shape, generator=gen)).clamp(
                    -0.04, 0.04)
            elif isinstance(owner, nn.LayerNorm):
                v = torch.ones(p.shape) if name.endswith("weight") else (
                    torch.zeros(p.shape))
            else:
                bound = fans[name] ** -0.5
                v = (2 * torch.rand(p.shape, generator=gen) - 1) * bound
            p.copy_(v)


def check_size(shape: Sequence[int]) -> None:
    if any(s % MULTIPLE for s in shape):
        raise ValueError(f"SwinUNETR: spatial sizes {tuple(shape)} must be "
                         f"multiples of {MULTIPLE} (the patch embedding and "
                         "four patch merges each halve them)")


class WindowAttention(nn.Module):
    """The attention in the windows (the benchmark's ``pb.attn``): the
    block's bias and ``ops/window_attention.py::window_attention``. No
    parameters; the relative-position index is a non-persistent buffer."""

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer(
            "relative_position_index",
            wa.relative_position_index().to(device), persistent=False)

    def forward(self, q, k, v, table, mask, mask_key):
        n = q.shape[-2]
        index = self.relative_position_index
        bias = cached(table, ("attention_bias", n, mask_key, q.dtype),
                      lambda t: wa.attention_bias(t, index, n, mask, q.dtype))
        return wa.window_attention(q, k, v, bias)


class SwinAttention(nn.Module):
    """MONAI's ``WindowAttention``'s parameters (``qkv``, ``proj``,
    ``relative_position_bias_table``) around the attention itself
    (``window``)."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 3, heads, device=device))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.window = WindowAttention(device)

    def forward(self, x, mask, mask_key):
        """x (B, windows, n, C) -> (B, windows, n, C)."""
        b, nw, n, c = x.shape
        qkv = _linear(x, self.qkv).view(b, nw, n, 3, self.heads,
                                        c // self.heads)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).contiguous()
        y = self.window(q, k, v, self.relative_position_bias_table, mask,
                        mask_key)
        return _linear(y.transpose(2, 3).reshape(b, nw, n, c), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden, device=device)
        self.linear2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return _linear(F.gelu(_linear(x, self.linear1)), self.linear2)


class SwinTransformerBlock(nn.Module):
    """``x + attn(pad(roll(LN1(x))))`` cropped and rolled back, then
    ``x + MLP(LN2(x))``, on (B, D, H, W, C)."""

    def __init__(self, dim: int, heads: int, shifted: bool, device=None):
        super().__init__()
        self.shift = WINDOW // 2 if shifted else 0
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = SwinAttention(dim, heads, device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, dim * MLP_RATIO, device)

    def forward(self, x, masks):
        b, d, h, w, c = x.shape
        window, shift = wa.window_and_shift((d, h, w), self.shift)
        y = _layer_norm(x, self.norm1)
        pads = [(-s) % k for s, k in zip((d, h, w), window)]
        if any(pads):
            y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dims = tuple(y.shape[1:4])
        mask = key = None
        if any(shift):
            y = torch.roll(y, tuple(-s for s in shift), (1, 2, 3))
            key = dims + window + shift
            mask = masks(key)
        y = self.attn(wa.window_partition(y, window), mask, key)
        y = wa.window_reverse(y, window, dims)
        if any(shift):
            y = torch.roll(y, shift, (1, 2, 3))
        if any(pads):
            y = y[:, :d, :h, :w]
        x = x + y
        return x + self.mlp(_layer_norm(x, self.norm2))


class PatchMerging(nn.Module):
    """MONAI's v1 ``PatchMerging``: (B, D, H, W, C) -> (B, D/2, H/2, W/2,
    2C)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False,
                                   device=device)
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS, device=device)

    def forward(self, x):
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE_OFFSETS],
                      -1)
        return _linear(_layer_norm(x, self.norm), self.reduction)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, device=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, heads, j % 2 == 1, device)
            for j in range(depth)])
        self.downsample = PatchMerging(dim, device)

    def forward(self, x, masks):
        for block in self.blocks:
            x = block(x, masks)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, device=None):
        super().__init__()
        self.proj = nn.Conv3d(in_channels, dim, PATCH, stride=PATCH,
                              device=device)

    def forward(self, x):
        return conv3d_ndhwc(x, _cast(self.proj.weight, x.dtype),
                            _cast(self.proj.bias, x.dtype), stride=PATCH)


class SwinTransformer(nn.Module):
    """MONAI's ``SwinTransformer`` (``swinViT``) with ``normalize=True``:
    x (B, D, H, W, C) -> the five hidden states (NDHWC). The shift masks of
    ``patch_shape``'s stages are made at construction."""

    def __init__(self, in_channels: int, feature_size: int, device=None,
                 patch_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, feature_size, device)
        for stage, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
            self.add_module(f"layers{stage + 1}", nn.ModuleList([BasicLayer(
                feature_size * 2 ** stage, depth, heads, device)]))
        if patch_shape is not None:
            size = [s // PATCH for s in patch_shape]
            for _ in DEPTHS:
                window, shift = wa.window_and_shift(size, WINDOW // 2)
                if any(shift):
                    dims = tuple(-(-s // k) * k for s, k in zip(size, window))
                    self._mask(dims + window + shift, device)
                size = [-(-s // 2) for s in size]

    def _mask(self, key, device=None) -> torch.Tensor:
        """The shift mask of ``key`` (padded dims, window, shift), a
        non-persistent buffer made at its first use."""
        name = "shift_mask_" + "_".join(str(v) for v in key)
        mask = getattr(self, name, None)
        if mask is None:
            mask = wa.shift_mask(key[:3], key[3:6], key[6:], device)
            self.register_buffer(name, mask, persistent=False)
        return mask

    def forward(self, x):
        x = self.patch_embed(x)
        states = [_layer_norm(x)]
        masks = functools.partial(self._mask, device=x.device)
        for stage in range(len(DEPTHS)):
            x = self._modules[f"layers{stage + 1}"][0](x, masks)
            states.append(_layer_norm(x))
        return states


class UnetResBlock(nn.Module):
    """MONAI's ``UnetResBlock``: ``lrelu(IN(conv(lrelu(IN(conv(x))))) +
    skip)``, the skip a 1^3 conv and IN where the channels change, else
    x."""

    def __init__(self, cin: int, cout: int, dtype, device=None):
        super().__init__()
        kw = dict(instance_normalization=True, negative_slope=SLOPE,
                  dtype=dtype, device=device, bias=False, norm_eps=IN_EPS,
                  norm_affine=False)
        self.conv1 = ConvBlock(cin, cout, activation="leaky_relu", **kw)
        self.conv2 = ConvBlock(cout, cout, activation="none", **kw)
        self.conv3 = (ConvBlock(cin, cout, kernel_size=1, activation="none",
                                **kw) if cin != cout else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        skip = x if self.conv3 is None else self.conv3(x)
        return F.leaky_relu(y + skip.to(y.dtype), SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dtype, device=None):
        super().__init__()
        self.layer = UnetResBlock(cin, cout, dtype, device)

    def forward(self, x):
        return self.layer(x)


class TransposedConv(nn.Module):
    """A 2^3 stride-2 transposed conv without bias, NDHWC in and out."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 2, stride=2, bias=False,
                                       device=device)

    def forward(self, x):
        w = cached(self.conv.weight, ("transposed", x.dtype),
                   lambda t: t.to(x.dtype).contiguous(
                       memory_format=torch.channels_last_3d))
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w, stride=2)
        return y.permute(0, 2, 3, 4, 1)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dtype, device=None):
        super().__init__()
        self.transp_conv = TransposedConv(cin, cout, device)
        self.conv_block = UnetResBlock(2 * cout, cout, dtype, device)

    def forward(self, x, skip):
        up = self.transp_conv(x)
        return self.conv_block(torch.cat([up, skip.to(up.dtype)], -1))


class SwinUNETR(nn.Module):
    """x (B, D, H, W, C) -> (B, D, H, W, n_labels) fp32, NDHWC; each of D,
    H, W a multiple of 32."""

    def __init__(self, in_channels: int = 1, n_labels: int = 1,
                 feature_size: int = 48, activation_name: str = "sigmoid",
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 patch_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.dtype = dtype
        self.activation_name = activation_name
        self.spatial_group = None
        fs = feature_size
        self.swinViT = SwinTransformer(in_channels, fs, device, patch_shape)
        for name, cin, cout in (("encoder1", in_channels, fs),
                                ("encoder2", fs, fs),
                                ("encoder3", 2 * fs, 2 * fs),
                                ("encoder4", 4 * fs, 4 * fs),
                                ("encoder10", 16 * fs, 16 * fs)):
            self.add_module(name, UnetrBasicBlock(cin, cout, dtype, device))
        for name, cin, cout in (("decoder5", 16 * fs, 8 * fs),
                                ("decoder4", 8 * fs, 4 * fs),
                                ("decoder3", 4 * fs, 2 * fs),
                                ("decoder2", 2 * fs, fs),
                                ("decoder1", fs, fs)):
            self.add_module(name, UnetrUpBlock(cin, cout, dtype, device))
        # MONAI's UnetOutBlock: out.conv.conv
        self.out = nn.ModuleDict({"conv": nn.ModuleDict({"conv": nn.Conv3d(
            fs, n_labels, 1, device=device)})})

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        check_size(x.shape[1:4])
        x = x.to(self.dtype)
        with span("swin.encoder"):
            hs = self.swinViT(x)
        with span("swin.decoder"):
            enc = [self.encoder1(x), self.encoder2(hs[0]),
                   self.encoder3(hs[1]), self.encoder4(hs[2])]
            y = self.encoder10(hs[4])
            for name, skip in zip(("decoder5", "decoder4", "decoder3",
                                   "decoder2", "decoder1"),
                                  [hs[3]] + enc[::-1]):
                y = self._modules[name](y, skip)
            head = self.out["conv"]["conv"]
            out = conv3d_ndhwc(y.float(), head.weight, head.bias)
        return out if logits else head_activation(out, self.activation_name)
