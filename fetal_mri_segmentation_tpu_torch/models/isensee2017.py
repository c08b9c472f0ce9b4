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

``fold_level0`` (``layers.py::resolve_fold``; the U-Net's semantics): level
0 runs space-to-depth folded (``ops/fold.py``). Its blocks, its spatial
dropout (each original channel's mask tiled over the sub-voxels) and its
output stay folded; level 1's stride-2 entry consumes the folded output and
emits the unfolded half-resolution grid; the decoder's level 0 upsamples
(``upsample_nearest_folded``) or runs the fused up-sampling module folded,
concatenates with ``concat_folded``, and its 1^3 localization tail and
segmentation head run per sub-voxel; the summed heads are unfolded at exit.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
from torch import nn

from fetal_mri_segmentation_tpu_torch.models.layers import (
    ConvBlock, LevelSharding, draw_dropout_masks, head_activation,
    resolve_fold, spatial_dropout_3d, upsample_nearest)
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import conv3d_ndhwc
from fetal_mri_segmentation_tpu_torch.ops.fold import (
    concat_folded, conv1_folded, fold, unfold, upsample_nearest_folded)


class Isensee2017(nn.Module):
    """x (B, D, H, W, C) -> (B, D, H, W, n_labels) fp32, NDHWC.

    In training with ``dropout_rate`` > 0 the forward needs the spatial
    dropout's keep-masks: ``dropout_masks`` (one (B, f_L) bool tensor per
    level, :meth:`dropout_masks`) or a ``generator`` to draw them from.
    With a ``spatial_group`` (``layers.py::set_spatial_group``) x is one
    depth slab of the volume (from the first level whose slab is odd,
    ``layers.py::gather_level``, the levels run whole on every rank), and
    the masks must be the same on every rank of the group."""

    def __init__(self, in_channels: int = 1, n_labels: int = 1,
                 depth: int = 5, n_base_filters: int = 16,
                 dropout_rate: float = 0.3, n_segmentation_levels: int = 3,
                 activation_name: str = "sigmoid",
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernel_conv: bool = False,
                 use_kernel_dec0: bool = False, device=None, bn_group=None,
                 fold_level0: Any = "auto", fold_formulation: str = "dense"):
        # bn_group: accepted as the U-Net's is; every block here carries
        # InstanceNorm, whose statistics are per sample and need no group
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
        self.spatial_group = None
        self.filters = [n_base_filters * 2 ** level for level in range(depth)]
        self.fold_level0 = (tuple(fold_level0) if isinstance(
            fold_level0, (list, tuple)) else fold_level0)
        self.fold_formulation = fold_formulation

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
        ff, form = resolve_fold(self.fold_level0, self.fold_formulation, x,
                                extra_gates=self.depth >= 2)
        n = ff[0] * ff[1] * ff[2] if ff else 1
        shard = LevelSharding(self.spatial_group, x.shape[1], self.depth - 1,
                              fold_depth=ff[0] if ff else 1)
        drop = self.training and self.dropout_rate > 0
        if drop and dropout_masks is None:
            if generator is None:
                raise ValueError(
                    f"Isensee2017 in training with dropout_rate="
                    f"{self.dropout_rate} needs a generator or dropout_masks")
            dropout_masks = self.dropout_masks(x.shape[0], generator,
                                               x.device)
        x = shard.gather(x.to(self.dtype), -1)
        if ff is not None:
            x = fold(x, ff)  # level 0 runs folded
        level_outputs = []
        for level in range(self.depth):
            whole = shard.whole(level)
            kw = dict(fold=ff, form=form) if level == 0 and ff else {}
            # level 1's stride-2 entry consumes the folded level-0 output
            # and emits the unfolded half-resolution grid
            entry = dict(fold=ff, form=form) if level <= 1 and ff else {}
            in_conv = self._modules[f"enc{level}_in"](x, whole=whole, **entry)
            h = self._modules[f"enc{level}_ctx1"](in_conv, whole=whole, **kw)
            if drop:
                mask = dropout_masks[level]
                h = spatial_dropout_3d(h, mask.repeat(1, n) if kw else mask,
                                       self.dropout_rate)
            h = self._modules[f"enc{level}_ctx2"](h, whole=whole, **kw)
            x = shard.gather(in_conv + h, level)
            level_outputs.append(x)  # level 0's output stays folded

        segmentation = []
        for level in range(self.depth - 2, -1, -1):
            whole = shard.whole(level, decoder=True)
            kw = dict(fold=ff, form=form) if level == 0 and ff else {}
            up = self._modules[f"dec{level}_up"]
            if not self.training:
                x = up((x, None), whole=whole, **kw)
            elif kw:
                x = up(upsample_nearest_folded(x, ff), whole=whole, **kw)
            else:
                x = up(upsample_nearest(x, (2, 2, 2)), whole=whole)
            x = (concat_folded(level_outputs[level], x, ff) if kw
                 else torch.cat([level_outputs[level], x], -1))
            x = self._modules[f"dec{level}_loc1"](x, whole=whole, **kw)
            x = self._modules[f"dec{level}_loc2"](x, whole=whole, **kw)
            x = shard.cut(x, level)
            if level < self.n_segmentation_levels:
                head = self._modules[f"seg{level}"]
                if kw:  # the same parameter, a matmul per sub-voxel
                    seg = conv1_folded(x.float(),
                                       head.weight.permute(2, 3, 4, 1, 0),
                                       head.bias, ff)
                else:
                    seg = conv3d_ndhwc(x.float(), head.weight, head.bias)
                segmentation.insert(0, seg)

        out = None
        for level in reversed(range(self.n_segmentation_levels)):
            seg = segmentation[level]
            # the sum of the heads above a gathered level is whole there
            if out is not None:
                out = shard.cut(out, level)
            if level == 0 and ff is not None and out is not None:
                # the coarser sum arrives unfolded at half resolution (its
                # level-1 upsample was deferred below) and is upsampled
                # folded to match seg0's layout: the same voxel values
                out = upsample_nearest_folded(out, ff) + seg
            else:
                out = seg if out is None else out + seg
            if level > 0 and not (level == 1 and ff is not None):
                out = upsample_nearest(out, (2, 2, 2))
        if ff is not None:
            out = shard.cut(unfold(out, ff), -1)
        return out if logits else head_activation(out, self.activation_name)
