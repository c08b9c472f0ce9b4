"""MedNeXt (Roy et al. 2023, arXiv:2303.09975) as the public code's
``create_mednext_v1(model_id, kernel_size)`` builds it
(github.com/MIC-DKFZ/MedNeXt, ``nnunet_mednext/network_architecture/
mednextv1/``: ``norm_type='group'``, ``do_res=True``,
``do_res_up_down=True``, ``grn=False``, ``deep_supervision=False``), in the
port's NDHWC layout. The JAX package has no such model; the plain float32
reference it is held to is ``reference/mednext.py`` at the repository's
root, which writes out each equation.

- ``MedNeXtBlock``: a depthwise k^3 conv (``DepthwiseConv3d``), the
  channel-wise GroupNorm (GroupNorm(C, C), which is an affine
  InstanceNorm with eps 1e-5), then ``PointwiseMLP`` (1^3 conv to R C,
  exact GELU, 1^3 conv back), and the residual ``x + ...``. The down block
  runs its depthwise conv at stride 2, writes 2C and adds a 1^3 stride-2
  conv of x; the up block's depthwise conv is a stride-2 transposed conv
  (an odd extent, 2n - 1), it writes C, adds a 1^3 stride-2 transposed
  conv of x, and pads one zero voxel at the front of every axis.
- ``MedNeXt``: stem (1^3 conv to F channels), four encoder stages of
  blocks at F, 2F, 4F, 8F each followed by a down block, a bottleneck at
  16F, four decoder stages ``x = skip + up(x)`` then blocks, and a 1^3
  transposed-conv head in fp32. ``SIZES`` holds the published S, B, M
  and L tables (expansion ratios and block counts); ``kernel`` is 3 or 5.

Departures from the public code, each deliberate:

- Names: the norm's ``weight`` is ``norm.scale`` (``layers.InstanceNorm``'s
  name), and a block's two 1^3 convs sit under ``mlp`` (``mlp.conv2``,
  ``mlp.conv3``). A public ``state_dict`` loads once ``norm.weight`` is
  renamed, ``conv2`` and ``conv3`` are moved under ``mlp``, and
  ``dummy_tensor`` (a checkpointing work-around outside the mathematics)
  is dropped.
- No deep supervision (``create_mednext_v1``'s default) and no
  checkpointing of the blocks: the L model trains at batch 2 of 128^3
  patches without it on an 80 GB card (``config.remat`` still
  recomputes the whole forward).
- An up block adds its two branches before the padding, which is exactly
  the padded sum (the padding is zeros), and its transposed depthwise conv
  runs as the equal stride-1 conv of the spread input (``DepthwiseConv3d``).

Compute runs in ``dtype`` (bf16 by default). The norms run through
``layers.InstanceNorm`` (affine, eps 1e-5, activation "none"), so on a
CUDA tensor they are the fused kernel ``ops/instance_norm.py`` (N1),
forward and hand backward, and on the CPU the fp32 composite. The
depthwise convs are PyTorch's ``F.conv3d`` with ``groups=C`` on
NCDHW-contiguous copies (on the card whatever PyTorch selects for them
there: ATen's depthwise 3D kernels), the up blocks' transposed ones
written as the stride-1 conv of the input spread onto the even voxels,
with the kernel flipped; the 1^3 convs are ``F.linear`` over the channel
axis (GEMMs).
Each parameter's operand (the cast to the compute dtype, the 1^3 convs'
weights as matrices, the flipped kernels, the residual transposed conv's
weight channels-last) follows ``ops/cuda_lib.py::cached``.

Spans (``utils/profiling.py``, while a profiler runs): ``mednext.encoder``
(the stem through the bottleneck) and ``mednext.decoder`` (the up blocks,
the decoder stages and the head), two a forward.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fetal_mri_segmentation_tpu_torch.models.layers import (
    InstanceNorm, head_activation)
from fetal_mri_segmentation_tpu_torch.ops.cuda_lib import cached
from fetal_mri_segmentation_tpu_torch.utils.profiling import span

# create_mednext_v1's sizes: (exp_r, block_counts)
SIZES = {"S": ((2,) * 9, (2,) * 9),
         "B": ((2, 3, 4, 4, 4, 4, 4, 3, 2), (2,) * 9),
         "M": ((2, 3, 4, 4, 4, 4, 4, 3, 2), (3, 4, 4, 4, 4, 4, 4, 4, 3)),
         "L": ((3, 4, 8, 8, 8, 8, 8, 4, 3), (3, 4, 8, 8, 8, 8, 8, 4, 3))}
GN_EPS = 1e-5
LEVELS = 4
# four down blocks halve each axis four times
MULTIPLE = 2 ** LEVELS


def _cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return cached(p, ("dtype", dtype), lambda t: t.to(dtype))


def _pointwise(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """A 1^3 conv (``conv.weight`` (out, in, 1, 1, 1)) on NDHWC x: a GEMM
    over the channel axis."""
    w = cached(conv.weight, ("pointwise", x.dtype),
               lambda t: t.to(x.dtype).reshape(t.shape[0], t.shape[1]))
    return F.linear(x, w, _cast(conv.bias, x.dtype))


def _channels_last(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return cached(w, ("channels_last", dtype), lambda t: t.to(dtype).contiguous(
        memory_format=torch.channels_last_3d))


def init_parameters(model: nn.Module, seed: int = 0) -> None:
    """Every parameter of ``model`` drawn afresh from a CPU generator seeded
    with ``seed``, in ``named_parameters`` order, as PyTorch's modules
    initialize them: conv weights and biases U(-b, b), b = 1 / sqrt(fan_in)
    with PyTorch's fan-in of the weight (dim 1 times the kernel's volume,
    also for a transposed conv), norm scales 1 and biases 0. The same seed
    gives the same model on any device."""
    gen = torch.Generator().manual_seed(int(seed))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            owner, leaf = name.rsplit(".", 1)
            if isinstance(model.get_submodule(owner), InstanceNorm):
                v = torch.full(p.shape, 1.0 if leaf == "scale" else 0.0,
                               device="cpu")
            else:
                w = params[owner + ".weight"]
                bound = (w.shape[1] * math.prod(w.shape[2:])) ** -0.5
                v = (2 * torch.rand(p.shape, generator=gen, device="cpu")
                     - 1) * bound
            p.copy_(v)


def check_size(shape: Sequence[int]) -> None:
    if any(s % MULTIPLE for s in shape):
        raise ValueError(f"MedNeXt: spatial sizes {tuple(shape)} must be "
                         f"multiples of {MULTIPLE} (four down blocks each "
                         "halve them)")


class DepthwiseConv3d(nn.Module):
    """A k^3 conv with one filter per channel and a bias, on NDHWC
    (the benchmark's ``pb.dwconv``): stride 1 or 2, padding k // 2, or
    (``transposed``) a stride-2 transposed conv, (B, n, n, n, C) ->
    (B, 2n - 1, 2n - 1, 2n - 1, C). ``weight`` (C, 1, k, k, k), as
    ``Conv3d(C, C, k, groups=C)`` and ``ConvTranspose3d(C, C, k,
    groups=C)`` hold it."""

    def __init__(self, channels: int, kernel: int, stride: int = 1,
                 transposed: bool = False, device=None):
        super().__init__()
        self.kernel, self.stride, self.transposed = kernel, stride, transposed
        bound = kernel ** -1.5  # PyTorch's conv default: 1 / sqrt(fan_in)
        self.weight = nn.Parameter(torch.empty(
            channels, 1, kernel, kernel, kernel, device=device).uniform_(
                -bound, bound))
        self.bias = nn.Parameter(torch.empty(channels, device=device).uniform_(
            -bound, bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NCDHW-contiguous operands, where PyTorch runs its own depthwise 3D
        # kernels (ATen's): on a channels-last view it picks cuDNN's grouped
        # 3D kernels, whose backward took 5-21x longer at MedNeXt's shapes
        # on an H100
        x = x.permute(0, 4, 1, 2, 3)
        b = _cast(self.bias, x.dtype)
        stride = self.stride
        if self.transposed:
            # the stride-2 transposed conv is the stride-1 conv, padding
            # k // 2, of x spread onto the even voxels of the odd grid, with
            # the kernel flipped: the same products, on ATen's kernels
            # (cuDNN's grouped transposed conv took 2.3x longer)
            x, stride = _spread(x), 1
            w = cached(self.weight, ("flipped", x.dtype),
                       lambda t: t.to(x.dtype).flip(2, 3, 4))
        else:
            w = _cast(self.weight, x.dtype)
        y = F.conv3d(x.contiguous(), w, b, stride=stride,
                     padding=self.kernel // 2, groups=x.shape[1])
        return y.permute(0, 2, 3, 4, 1).contiguous()


def _spread(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, n, n, n) on the even voxels of a (B, C, 2n - 1, ...) grid of
    zeros."""
    b, c, d, h, w = x.shape
    out = x.new_zeros(b, c, 2 * d - 1, 2 * h - 1, 2 * w - 1)
    out[:, :, ::2, ::2, ::2] = x
    return out


class PointwiseMLP(nn.Module):
    """``conv3(GELU(conv2(x)))`` with 1^3 convs (the benchmark's
    ``pb.mlp``): C -> R C -> C_out on NDHWC, exact GELU."""

    def __init__(self, cin: int, hidden: int, cout: int, device=None):
        super().__init__()
        self.conv2 = nn.Conv3d(cin, hidden, 1, device=device)
        self.conv3 = nn.Conv3d(hidden, cout, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pointwise(F.gelu(_pointwise(x, self.conv2)), self.conv3)


class MedNeXtBlock(nn.Module):
    """``kind`` "block" (C -> C with its residual), "down" (C -> 2C at
    half the extent) or "up" (2C -> C at twice the extent)."""

    def __init__(self, cin: int, cout: int, ratio: int, kernel: int,
                 kind: str, dtype, device=None):
        super().__init__()
        self.kind = kind
        self.conv1 = DepthwiseConv3d(cin, kernel, 1 if kind == "block" else 2,
                                     kind == "up", device)
        self.norm = InstanceNorm(cin, dtype=dtype, device=device, eps=GN_EPS)
        self.mlp = PointwiseMLP(cin, ratio * cin, cout, device)
        if kind == "down":
            self.res_conv = nn.Conv3d(cin, cout, 1, stride=2, device=device)
        elif kind == "up":
            self.res_conv = nn.ConvTranspose3d(cin, cout, 1, stride=2,
                                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(self.norm(self.conv1(x)))
        if self.kind == "block":
            return x + y
        if self.kind == "down":
            return y + _pointwise(x[:, ::2, ::2, ::2], self.res_conv)
        w = _channels_last(self.res_conv.weight, x.dtype)
        res = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w,
                                 _cast(self.res_conv.bias, x.dtype), stride=2)
        return F.pad(y + res.permute(0, 2, 3, 4, 1), (0, 0, 1, 0, 1, 0, 1, 0))


class MedNeXt(nn.Module):
    """x (B, D, H, W, C) -> (B, D, H, W, n_labels) fp32, NDHWC; each of D,
    H, W a multiple of 16."""

    def __init__(self, in_channels: int = 1, n_labels: int = 1,
                 n_base_filters: int = 32, size: str = "L", kernel: int = 5,
                 activation_name: str = "sigmoid",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.activation_name = activation_name
        self.spatial_group = None
        exp_r, counts = SIZES[size]
        fs = n_base_filters
        kw = dict(kernel=kernel, dtype=dtype, device=device)

        def stage(c, ratio, n):
            return nn.Sequential(*[MedNeXtBlock(c, c, ratio, kind="block", **kw)
                                   for _ in range(n)])

        self.stem = nn.Conv3d(in_channels, fs, 1, device=device)
        for i in range(LEVELS):
            c = fs * 2 ** i
            self.add_module(f"enc_block_{i}", stage(c, exp_r[i], counts[i]))
            self.add_module(f"down_{i}", MedNeXtBlock(
                c, 2 * c, exp_r[i + 1], kind="down", **kw))
        self.bottleneck = stage(fs * 2 ** LEVELS, exp_r[LEVELS],
                                counts[LEVELS])
        for i in reversed(range(LEVELS)):
            c = fs * 2 ** i
            self.add_module(f"up_{i}", MedNeXtBlock(
                2 * c, c, exp_r[8 - i], kind="up", **kw))
            self.add_module(f"dec_block_{i}", stage(c, exp_r[8 - i],
                                                    counts[8 - i]))
        # the public OutBlock: out_0.conv_out, a 1^3 transposed conv
        self.out_0 = nn.ModuleDict({"conv_out": nn.ConvTranspose3d(
            fs, n_labels, 1, device=device)})

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        check_size(x.shape[1:4])
        x = x.to(self.dtype)
        with span("mednext.encoder"):
            x = _pointwise(x, self.stem)
            skips = []
            for i in range(LEVELS):
                skips.append(self._modules[f"enc_block_{i}"](x))
                x = self._modules[f"down_{i}"](skips[-1])
            x = self.bottleneck(x)
        with span("mednext.decoder"):
            for i in reversed(range(LEVELS)):
                x = skips[i] + self._modules[f"up_{i}"](x)
                x = self._modules[f"dec_block_{i}"](x)
            head = self.out_0["conv_out"]
            out = F.linear(x.float(), head.weight.flatten(1).t(), head.bias)
        return out if logits else head_activation(out, self.activation_name)
