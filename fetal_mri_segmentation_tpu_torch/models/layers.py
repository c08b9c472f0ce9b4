"""Building blocks of the 3D U-Net family (port of
``fetal_mri_segmentation_tpu/models/layers.py``).

Activations are logical NDHWC tensors, contiguous in that order, between
blocks: the Hopper kernels read and write NDHWC directly, and the plain
``F.conv3d`` paths see a channels_last_3d view (``ops.conv3x3.
conv3d_ndhwc``), so no permute-and-copy runs between two kernel calls.
Parameters are fp32 in PyTorch's OIDHW layout; compute runs in the block's
``dtype`` (bf16 by default, as in the JAX package). Norm statistics are
taken in fp32.

Module and parameter names follow the flax tree (``conv``, ``bn``, ``in``,
``deconv``; ``scale``, ``bias``, ``mean``, ``var``), so a converted
checkpoint loads with ``load_state_dict`` (``utils/params.py::from_flax``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import (
    apply_activation, conv3d_ndhwc, conv3x3, conv3x3_available,
    conv3x3_flat)
from fetal_mri_segmentation_tpu_torch.ops.cuda_lib import cached
from fetal_mri_segmentation_tpu_torch.ops.dec0 import (
    dec0_available, up_concat_conv3x3, up_concat_conv3x3_kernel)


class InstanceNorm(nn.Module):
    """Per sample and channel over (D, H, W), in fp32: biased variance, eps
    1e-3 inside the rsqrt, learned ``scale`` / ``bias`` per channel, the
    result in ``dtype`` (the JAX ``InstanceNorm``, keras-contrib's
    semantics)."""

    epsilon = 1e-3

    def __init__(self, features: int, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = xf.var(dim=(1, 2, 3), correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3, dtype=float32)`` over
    the channel axis of NDHWC, the result in ``dtype``.

    In training (``self.training``) the batch's fp32 mean and biased
    variance (flax's E[x^2] - E[x]^2, clipped at 0) normalize, and the
    running buffers move as ``r <- momentum * r + (1 - momentum) * stat``.
    ``nn.BatchNorm3d`` is not this: it keeps the unbiased variance and takes
    momentum as 1 - 0.99. In eval the buffers normalize."""

    momentum, epsilon = 0.99, 1e-3

    def __init__(self, features: int, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=dims)
            var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                for buf, stat in ((self.mean, mean), (self.var, var)):
                    buf.mul_(self.momentum).add_(stat * (1 - self.momentum))
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
        return (y + self.bias).to(self.dtype)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (low, high), the odd voxel high."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """Conv3D(same) -> optional BatchNorm / InstanceNorm -> activation
    (reference: unet3d/model/unet.py::create_convolution_block; the
    Isensee variant uses InstanceNorm + LeakyReLU, optional stride 2).

    ``forward`` takes an NDHWC tensor, or the fused-decoder input
    ``(x_deep, skip)`` (skip may be None): nearest x2 upsample of x_deep,
    concat with skip and this block's conv in one op, with the same
    parameter as the unfused path (``in_features`` counts the concat
    channels).

    ``use_kernel_conv`` routes every 3^3 stride-1 conv that passes
    ``conv3x3_available`` (C_in >= 8, channel counts multiples of 8) to the
    Hopper conv kernel (C_in % 128 == 0 through ``conv3x3``, the port of
    the TPU's halo-slab kernel, the rest through ``conv3x3_flat``, as
    ``_pallas_op`` splits them); ``use_kernel_dec0`` routes the fused
    decoder input with a skip to the fused-decoder kernel. The activation is
    fused into both kernels when the block has no norm; with a norm the
    kernel runs with activation "none" and the norm and activation follow
    in plain ops, as the JAX ``_pallas_path`` does. A 1^3 or stride-2 conv
    stays on ``F.conv3d`` (XLA in the JAX package). On CPU tensors the
    kernel routes run the kernels' plain versions. Both routes are
    differentiable (the kernels' autograd Functions in ``ops/``). Outside
    autograd, both routes take the weight in the compute dtype once per
    version of the parameter, already K-major (the conv kernel's B operand)
    and kept as one tensor, so the fused-decoder kernel's own prepared
    weights are made once too.
    """

    def __init__(self, in_features: int, features: int, *,
                 kernel_size: int = 3, stride: int = 1,
                 batch_normalization: bool = False,
                 instance_normalization: bool = False,
                 activation: str = "relu", negative_slope: float = 0.3,
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernel_conv: bool = False,
                 use_kernel_dec0: bool = False, device=None):
        super().__init__()
        self.features = features
        self.kernel_size = kernel_size
        self.stride = stride
        self.activation = activation
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.use_kernel_conv = use_kernel_conv
        self.use_kernel_dec0 = use_kernel_dec0
        self.conv = nn.Conv3d(in_features, features, kernel_size,
                              stride=stride, device=device)
        # the norm sits under flax's name ("bn" or "in"; "in" is a Python
        # keyword, so it is reached through _modules)
        self.norm_key = None
        if batch_normalization:
            self.norm_key = "bn"
            self.add_module("bn", BatchNorm(features, dtype=dtype,
                                            device=device))
        elif instance_normalization:
            self.norm_key = "in"
            self.add_module("in", InstanceNorm(features, dtype=dtype,
                                               device=device))

    @property
    def kernel_activation(self) -> str:
        """The activation fused into a kernel: none where a norm follows."""
        return "none" if self.norm_key else self.activation

    def _epilogue(self, y: torch.Tensor,
                  activated: bool = False) -> torch.Tensor:
        """The norm and the activation after any conv route; ``activated``:
        the kernel already applied the activation (no norm)."""
        if self.norm_key:
            y = self._modules[self.norm_key](y)
        if activated:
            return y
        return apply_activation(y, self.activation, self.negative_slope)

    def _kernel_dhwio(self) -> torch.Tensor:
        """The weight as DHWIO in the compute dtype: a view of a (C_out,
        3, 3, 3, C_in) tensor, the conv kernel's K-major B operand. Made
        once per version of the parameter; while autograd records, made
        afresh from the parameter on every call, so the gradient reaches
        ``conv.weight`` and no operand prepared from it (the fused
        decoder's, kept on this tensor) outlives an optimizer step."""
        def dhwio(w):
            return w.to(self.dtype).permute(0, 2, 3, 4, 1).contiguous(
                ).permute(1, 2, 3, 4, 0)

        weight = self.conv.weight
        if torch.is_grad_enabled() and weight.requires_grad:
            return dhwio(weight)
        return cached(weight, ("dhwio", self.dtype),
                      lambda w: dhwio(w.detach()))

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            return self._fused_decoder(*x)
        ci = x.shape[-1]
        if (self.use_kernel_conv and self.kernel_size == 3
                and self.stride == 1 and conv3x3_available(ci, self.features)):
            op = conv3x3 if ci % 128 == 0 else conv3x3_flat
            y = op(x.to(self.dtype).contiguous(), self._kernel_dhwio(),
                   self.conv.bias.float(), self.kernel_activation,
                   self.negative_slope)
            return self._epilogue(y, activated=not self.norm_key)
        return self._epilogue(self._plain_conv(x.to(self.dtype)))

    def _plain_conv(self, x: torch.Tensor) -> torch.Tensor:
        """SAME conv + bias in the compute dtype (flax ``nn.Conv``): where
        XLA pads an axis unevenly (stride 2 over an even extent pads 0 low,
        1 high) the input is padded first."""
        pads = [same_padding(n, self.kernel_size, self.stride)
                for n in x.shape[1:4]]
        padding = tuple(lo for lo, _ in pads)
        if any(lo != hi for lo, hi in pads):
            x = F.pad(x, (0, 0) + tuple(v for p in reversed(pads)
                                        for v in p))
            padding = 0
        return conv3d_ndhwc(x, self.conv.weight.to(self.dtype),
                            self.conv.bias.to(self.dtype), padding=padding,
                            stride=self.stride)

    def _fused_decoder(self, x_deep: torch.Tensor,
                       skip: Optional[torch.Tensor]) -> torch.Tensor:
        kernel = self._kernel_dhwio()
        x_deep = x_deep.to(self.dtype)
        if (skip is not None and self.use_kernel_dec0
                and dec0_available(x_deep.shape, skip.shape,
                                   x_deep.shape[-1], skip.shape[-1],
                                   self.features)):
            y = up_concat_conv3x3_kernel(
                x_deep.contiguous(), skip.to(self.dtype).contiguous(),
                kernel, self.conv.bias.float(), self.kernel_activation,
                self.negative_slope)
            return self._epilogue(y, activated=not self.norm_key)
        y = up_concat_conv3x3(
            x_deep, None if skip is None else skip.to(self.dtype), kernel,
            self.conv.bias)
        return self._epilogue(y)


class UpConv(nn.Module):
    """Upsampling: a transposed conv with kernel = stride = ``size``
    (``deconvolution``), or the nearest-neighbour repeat (reference:
    unet3d/model/unet.py::get_up_convolution). The transposed conv is a
    plain product that the JAX package leaves to XLA; here it is
    ``F.conv_transpose3d`` in the compute dtype (flax ``nn.ConvTranspose``
    with ``dtype``), its weight in PyTorch's (C_in, C_out, D, H, W) layout,
    which ``from_flax`` makes from flax's kernel by flipping the three
    spatial axes (flax does not transpose the kernel)."""

    def __init__(self, in_features: int, features: int, *,
                 deconvolution: bool = False,
                 size: Sequence[int] = (2, 2, 2),
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.size = tuple(size)
        self.dtype = dtype
        self.deconv = (nn.ConvTranspose3d(in_features, features, self.size,
                                          stride=self.size, device=device)
                       if deconvolution else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deconv is None:
            return upsample_nearest(x, self.size)
        y = F.conv_transpose3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                               self.deconv.weight.to(self.dtype),
                               self.deconv.bias.to(self.dtype),
                               stride=self.size)
        return y.permute(0, 2, 3, 4, 1)


def draw_dropout_masks(generator: torch.Generator, batch: int,
                       channels: Sequence[int], rate: float,
                       device=None) -> List[torch.Tensor]:
    """One (batch, C) bool keep-mask per entry of ``channels``: each (sample,
    channel) kept with probability 1 - ``rate`` (``jax.random.bernoulli``'s
    uniform < p), drawn from ``generator`` in order."""
    return [torch.rand((batch, c), generator=generator, device=device)
            < 1.0 - rate for c in channels]


def spatial_dropout_3d(x: torch.Tensor, mask: torch.Tensor,
                       rate: float) -> torch.Tensor:
    """SpatialDropout3D given its (B, C) keep-mask: whole channels dropped
    (broadcast over D, H, W), kept values divided by keep = 1 - rate
    rounded to x's dtype, as ``jnp.where(mask, x / keep, 0)`` computes it
    (reference: isensee2017.py::create_context_module)."""
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    kept = mask.reshape(mask.shape[0], 1, 1, 1, mask.shape[1])
    return torch.where(kept, x / keep, 0.0).to(x.dtype)


def upsample_nearest(x: torch.Tensor,
                     size: Tuple[int, int, int]) -> torch.Tensor:
    """UpSampling3D: nearest-neighbour repeat on the spatial axes (NDHWC)."""
    for axis, s in zip((1, 2, 3), size):
        if s != 1:
            x = x.repeat_interleave(s, dim=axis)
    return x


def max_pool_3d(x: torch.Tensor,
                window: Tuple[int, int, int] = (2, 2, 2)) -> torch.Tensor:
    """MaxPooling3D, stride == window, VALID (a trailing remainder is
    dropped), on NDHWC; the result stays contiguous NDHWC."""
    B, D, H, W, C = x.shape
    (wd, wh, ww), (d, h, w) = window, (D // window[0], H // window[1],
                                        W // window[2])
    x = x[:, :d * wd, :h * wh, :w * ww]
    return x.reshape(B, d, wd, h, wh, w, ww, C).amax(dim=(2, 4, 6))


def head_activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """Final activation over the channel axis (NDHWC)."""
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "softmax":
        return torch.softmax(x, dim=-1)
    if name in ("none", "linear", None):
        return x
    raise ValueError(f"unknown activation {name!r}")
