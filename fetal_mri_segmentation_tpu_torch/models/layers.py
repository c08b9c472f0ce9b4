"""Building blocks of the 3D U-Net (port of
``fetal_mri_segmentation_tpu/models/layers.py``).

Activations are logical NDHWC tensors, contiguous in that order, between
blocks: the Hopper kernels read and write NDHWC directly, and the plain
``F.conv3d`` paths see a channels_last_3d view (``ops.conv3x3.
conv3d_ndhwc``), so no permute-and-copy runs between two kernel calls.
Parameters are fp32 in PyTorch's OIDHW layout; compute runs in the block's
``dtype`` (bf16 by default, as in the JAX package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import (
    apply_activation, conv3d_ndhwc, conv3x3, conv3x3_available,
    conv3x3_flat)
from fetal_mri_segmentation_tpu_torch.ops.cuda_lib import cached
from fetal_mri_segmentation_tpu_torch.ops.dec0 import (
    dec0_available, up_concat_conv3x3, up_concat_conv3x3_kernel)


class ConvBlock(nn.Module):
    """Conv3D(3^3, same) -> activation (reference:
    unet3d/model/unet.py::create_convolution_block, norm-free).

    ``forward`` takes an NDHWC tensor, or the fused-decoder input
    ``(x_deep, skip)``: nearest x2 upsample of x_deep, concat with skip and
    this block's conv in one op, with the same parameter as the unfused
    path (``in_features`` counts the concat channels).

    ``use_kernel_conv`` routes every conv that passes ``conv3x3_available``
    (C_in >= 8, channel counts multiples of 8) to the Hopper conv kernel
    (C_in % 128 == 0 through ``conv3x3``, the port of the TPU's
    halo-slab kernel, the rest through ``conv3x3_flat``, as
    ``_pallas_op`` splits them); ``use_kernel_dec0`` routes the fused
    decoder input to the fused-decoder kernel. The activation is fused into
    both kernels. On CPU tensors the same routes run the kernels' plain
    versions. Both routes are differentiable (the kernels' autograd
    Functions in ``ops/``). Outside autograd, both routes take the weight
    in the compute dtype once per version of the parameter, already
    K-major (the conv kernel's B operand) and kept as one tensor, so the
    fused-decoder kernel's own prepared weights are made once too.
    """

    def __init__(self, in_features: int, features: int, *,
                 activation: str = "relu", negative_slope: float = 0.3,
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernel_conv: bool = False,
                 use_kernel_dec0: bool = False, device=None):
        super().__init__()
        self.features = features
        self.activation = activation
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.use_kernel_conv = use_kernel_conv
        self.use_kernel_dec0 = use_kernel_dec0
        self.conv = nn.Conv3d(in_features, features, 3, padding=1,
                              device=device)

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
        if self.use_kernel_conv and conv3x3_available(ci, self.features):
            op = conv3x3 if ci % 128 == 0 else conv3x3_flat
            return op(x.to(self.dtype).contiguous(), self._kernel_dhwio(),
                      self.conv.bias.float(), self.activation,
                      self.negative_slope)
        y = conv3d_ndhwc(x.to(self.dtype), self.conv.weight.to(self.dtype),
                         self.conv.bias.to(self.dtype), padding=1)
        return apply_activation(y, self.activation, self.negative_slope)

    def _fused_decoder(self, x_deep: torch.Tensor,
                       skip: Optional[torch.Tensor]) -> torch.Tensor:
        kernel = self._kernel_dhwio()
        x_deep = x_deep.to(self.dtype)
        if (skip is not None and self.use_kernel_dec0
                and dec0_available(x_deep.shape, skip.shape,
                                   x_deep.shape[-1], skip.shape[-1],
                                   self.features)):
            return up_concat_conv3x3_kernel(
                x_deep.contiguous(), skip.to(self.dtype).contiguous(),
                kernel, self.conv.bias.float(), self.activation,
                self.negative_slope)
        y = up_concat_conv3x3(
            x_deep, None if skip is None else skip.to(self.dtype), kernel,
            self.conv.bias)
        return apply_activation(y, self.activation, self.negative_slope)


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
