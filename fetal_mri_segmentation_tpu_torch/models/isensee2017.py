"""Isensee 2017 (BRATS) residual U-Net with deep supervision (port of
``fetal_mri_segmentation_tpu/models/isensee2017.py``).

- Encoder, per level L in [0, depth): ConvBlock(f_L) (stride 2 for L > 0:
  strided-conv downsampling, no pooling) -> context module (ConvBlock ->
  SpatialDropout3D(rate) -> ConvBlock) -> residual add with the entry conv.
  f_L = n_base_filters * 2^L. Every conv block is InstanceNorm + LeakyReLU
  (slope 0.3).
- Decoder, per level L in [depth-2, 0]: up-sampling module (nearest x2 ->
  ConvBlock(f_L)), concat with the level-L encoder output, localization
  module (ConvBlock 3^3 -> ConvBlock 1^3).
- Deep supervision: fp32 1^3 conv heads (n_labels) on the last
  ``n_segmentation_levels`` decoder levels, summed coarsest to finest with
  nearest x2 upsampling between, then sigmoid or softmax.

The up-sampling module runs fused (upsample + conv as one op, the parity
form of ``ops/dec0.py::up_concat_conv3x3`` with no skip) in eval and as
upsample-then-conv in training, as the JAX model dispatches on ``train``;
``self.training`` decides here, with one parameter tree for both. Module
names match the flax tree (``enc{L}_in``, ``enc{L}_ctx{1,2}``,
``dec{L}_up``, ``dec{L}_loc{1,2}``, ``seg{L}``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from fetal_mri_segmentation_tpu_torch.models.layers import (
    ConvBlock, draw_dropout_masks, head_activation, spatial_dropout_3d,
    upsample_nearest)
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import conv3d_ndhwc


class Isensee2017(nn.Module):
    """x (B, D, H, W, C) -> (B, D, H, W, n_labels) fp32, NDHWC.

    In training with ``dropout_rate`` > 0 the forward needs the spatial
    dropout's keep-masks: ``dropout_masks`` (one (B, f_L) bool tensor per
    level, :meth:`dropout_masks`) or a ``generator`` to draw them from."""

    def __init__(self, in_channels: int = 1, n_labels: int = 1,
                 depth: int = 5, n_base_filters: int = 16,
                 dropout_rate: float = 0.3, n_segmentation_levels: int = 3,
                 activation_name: str = "sigmoid",
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernel_conv: bool = False,
                 use_kernel_dec0: bool = False, device=None):
        super().__init__()
        if n_segmentation_levels > depth - 1:
            raise ValueError(
                f"n_segmentation_levels={n_segmentation_levels} needs "
                f"depth >= n_segmentation_levels+1 (got depth={depth}); "
                f"deep-supervision heads sit on decoder levels, of which "
                f"there are depth-1")
        self.depth = depth
        self.dropout_rate = dropout_rate
        self.n_segmentation_levels = n_segmentation_levels
        self.activation_name = activation_name
        self.dtype = dtype
        self.filters = [n_base_filters * 2 ** level for level in range(depth)]

        def block(name, cin, cout, **kw):
            self.add_module(name, ConvBlock(
                cin, cout, instance_normalization=True,
                activation="leaky_relu", dtype=dtype,
                use_kernel_conv=use_kernel_conv,
                use_kernel_dec0=use_kernel_dec0, device=device, **kw))

        cin = in_channels
        for level, f in enumerate(self.filters):
            block(f"enc{level}_in", cin, f, stride=1 if level == 0 else 2)
            block(f"enc{level}_ctx1", f, f)
            block(f"enc{level}_ctx2", f, f)
            cin = f
        for level in range(depth - 2, -1, -1):
            f = self.filters[level]
            block(f"dec{level}_up", cin, f)
            block(f"dec{level}_loc1", 2 * f, f)
            block(f"dec{level}_loc2", f, f, kernel_size=1)
            if level < n_segmentation_levels:
                self.add_module(f"seg{level}",
                                nn.Conv3d(f, n_labels, 1, device=device))
            cin = f

    def dropout_masks(self, batch: int, generator: torch.Generator,
                      device=None) -> List[torch.Tensor]:
        """The keep-masks of one training forward, one per level, drawn
        from ``generator`` (on ``device``, by default the model's)."""
        if device is None:
            device = next(self.parameters()).device
        return draw_dropout_masks(generator, batch, self.filters,
                                  self.dropout_rate, device)

    def forward(self, x: torch.Tensor, logits: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        drop = self.training and self.dropout_rate > 0
        if drop and dropout_masks is None:
            if generator is None:
                raise ValueError(
                    f"Isensee2017 in training with dropout_rate="
                    f"{self.dropout_rate} needs a generator or dropout_masks")
            dropout_masks = self.dropout_masks(x.shape[0], generator,
                                               x.device)
        x = x.to(self.dtype)
        level_outputs = []
        for level in range(self.depth):
            in_conv = self._modules[f"enc{level}_in"](x)
            h = self._modules[f"enc{level}_ctx1"](in_conv)
            if drop:
                h = spatial_dropout_3d(h, dropout_masks[level],
                                       self.dropout_rate)
            h = self._modules[f"enc{level}_ctx2"](h)
            x = in_conv + h
            level_outputs.append(x)

        segmentation = []
        for level in range(self.depth - 2, -1, -1):
            up = self._modules[f"dec{level}_up"]
            if self.training:
                x = up(upsample_nearest(x, (2, 2, 2)))
            else:
                x = up((x, None))
            x = torch.cat([level_outputs[level], x], -1)
            x = self._modules[f"dec{level}_loc1"](x)
            x = self._modules[f"dec{level}_loc2"](x)
            if level < self.n_segmentation_levels:
                head = self._modules[f"seg{level}"]
                segmentation.insert(0, conv3d_ndhwc(x.float(), head.weight,
                                                    head.bias))

        out = None
        for level in reversed(range(self.n_segmentation_levels)):
            seg = segmentation[level]
            out = seg if out is None else out + seg
            if level > 0:
                out = upsample_nearest(out, (2, 2, 2))
        return out if logits else head_activation(out, self.activation_name)
