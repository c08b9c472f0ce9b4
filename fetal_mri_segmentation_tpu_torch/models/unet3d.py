"""Plain 3D U-Net (port of ``fetal_mri_segmentation_tpu/models/unet3d.py``).

Encoder level L: ConvBlock(n_base * 2^L) -> ConvBlock(n_base * 2^(L+1)),
max-pool 2 between levels. Decoder level L (depth-2 .. 0): upsample (nearest,
or a transposed conv with ``deconvolution``), concat the level-L skip, two
ConvBlocks with the skip's channel count; with ``fuse_decoder`` (and no
deconvolution) the upsample + concat + first conv run as one op (the same
parameters). Every block may carry a BatchNorm or an InstanceNorm. Head:
fp32 1^3 conv -> sigmoid or softmax. Block names match the flax tree
(``enc{L}_conv{1,2}``, ``dec{L}_up``, ``dec{L}_conv{1,2}``, ``head``), so a
converted checkpoint loads with ``load_state_dict``
(``utils/params.py::from_flax``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fetal_mri_segmentation_tpu_torch.models.layers import (
    ConvBlock, UpConv, head_activation, max_pool_3d)
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import conv3d_ndhwc


class UNet3D(nn.Module):
    """x (B, D, H, W, C) -> (B, D, H, W, n_labels) fp32, NDHWC. BatchNorm
    uses the batch's statistics in training (``self.training``) and the
    running ones in eval."""

    def __init__(self, in_channels: int = 1, n_labels: int = 1,
                 depth: int = 4, n_base_filters: int = 32,
                 pool_size: Tuple[int, int, int] = (2, 2, 2),
                 deconvolution: bool = False,
                 batch_normalization: bool = False,
                 instance_normalization: bool = False,
                 activation_name: str = "sigmoid",
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernel_conv: bool = False,
                 use_kernel_dec0: bool = False,
                 fuse_decoder: bool = True, device=None):
        super().__init__()
        self.depth = depth
        self.pool_size = tuple(pool_size)
        self.activation_name = activation_name
        self.dtype = dtype
        self.fuse = (fuse_decoder and not deconvolution
                     and self.pool_size == (2, 2, 2))

        def block(name, cin, cout):
            self.add_module(name, ConvBlock(
                cin, cout, batch_normalization=batch_normalization,
                instance_normalization=instance_normalization, dtype=dtype,
                use_kernel_conv=use_kernel_conv,
                use_kernel_dec0=use_kernel_dec0, device=device))

        cin = in_channels
        for level in range(depth):
            f = n_base_filters * 2 ** level
            block(f"enc{level}_conv1", cin, f)
            block(f"enc{level}_conv2", f, 2 * f)
            cin = 2 * f
        for level in range(depth - 2, -1, -1):
            skip = 2 * n_base_filters * 2 ** level
            if not self.fuse:
                self.add_module(f"dec{level}_up", UpConv(
                    cin, cin, deconvolution=deconvolution,
                    size=self.pool_size, dtype=dtype, device=device))
            block(f"dec{level}_conv1", cin + skip, skip)
            block(f"dec{level}_conv2", skip, skip)
            cin = skip
        self.head = nn.Conv3d(cin, n_labels, 1, device=device)

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        skips = []
        for level in range(self.depth):
            x = getattr(self, f"enc{level}_conv1")(x)
            x = getattr(self, f"enc{level}_conv2")(x)
            if level < self.depth - 1:
                skips.append(x)
                x = max_pool_3d(x, self.pool_size)
        for level in range(self.depth - 2, -1, -1):
            skip = skips[level]
            if self.fuse:
                x = getattr(self, f"dec{level}_conv1")((x, skip))
            else:
                x = torch.cat([getattr(self, f"dec{level}_up")(x), skip], -1)
                x = getattr(self, f"dec{level}_conv1")(x)
            x = getattr(self, f"dec{level}_conv2")(x)
        y = conv3d_ndhwc(x.float(), self.head.weight, self.head.bias)
        return y if logits else head_activation(y, self.activation_name)
