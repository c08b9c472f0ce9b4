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

``fold_level0`` (``layers.py::resolve_fold``): level 0 runs space-to-depth
folded (``ops/fold.py``): the input folded at entry, the level-0 blocks and
their skip folded, ``pool_folded`` to level 1, the folded fused decoder,
the 1^3 head per sub-voxel, the output unfolded at exit. Same parameters.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn

from fetal_mri_segmentation_tpu_torch.models.layers import (
    ConvBlock, LevelSharding, UpConv, check_unet_fold, head_activation,
    max_pool_3d, resolve_fold)
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import conv3d_ndhwc
from fetal_mri_segmentation_tpu_torch.ops.fold import (
    conv1_folded, fold, pool_folded, unfold)


class UNet3D(nn.Module):
    """x (B, D, H, W, C) -> (B, D, H, W, n_labels) fp32, NDHWC. BatchNorm
    uses the batch's statistics in training (``self.training``) and the
    running ones in eval; ``bn_group`` (a process group) makes them the
    global batch's under data parallelism (``layers.py::BatchNorm``).
    With a ``spatial_group`` (``layers.py::set_spatial_group``) x is one
    depth slab of the volume; from the first level whose slab is odd
    (``layers.py::gather_level``) the levels run whole on every rank.

    ``fold_level0``: "auto" (the default; folds only where
    ``layers.py::_fold_backend_ok`` passes, which it does not in the port),
    None / "off", or explicit per-axis factors, which need the fused
    decoder, depth >= 2 and no BatchNorm (refused here with the JAX
    package's messages). ``fold_formulation``: the folded 3^3 conv's form
    ("parity", "parity_batched", "dense")."""

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
                 fuse_decoder: bool = True, device=None, bn_group=None,
                 fold_level0: Any = "auto", fold_formulation: str = "dense"):
        super().__init__()
        self.depth = depth
        self.pool_size = tuple(pool_size)
        self.activation_name = activation_name
        self.dtype = dtype
        self.spatial_group = None
        self.fuse = (fuse_decoder and not deconvolution
                     and self.pool_size == (2, 2, 2))
        self.has_norm = batch_normalization or instance_normalization
        check_unet_fold(fold_level0, self.fuse, depth, batch_normalization)
        self.fold_level0 = (tuple(fold_level0) if isinstance(
            fold_level0, (list, tuple)) else fold_level0)
        self.fold_formulation = fold_formulation

        def block(name, cin, cout):
            self.add_module(name, ConvBlock(
                cin, cout, batch_normalization=batch_normalization,
                instance_normalization=instance_normalization, dtype=dtype,
                use_kernel_conv=use_kernel_conv,
                use_kernel_dec0=use_kernel_dec0, device=device,
                bn_group=bn_group))

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
        ff, form = resolve_fold(
            self.fold_level0, self.fold_formulation, x,
            extra_gates=self.fuse and self.depth >= 2 and not self.has_norm)
        shard = LevelSharding(self.spatial_group, x.shape[1], self.depth - 1,
                              fold_depth=ff[0] if ff else 1)
        x = shard.gather(x.to(self.dtype), -1)
        if ff is not None:
            x = fold(x, ff)  # level 0 runs folded
        skips = []
        for level in range(self.depth):
            whole = shard.whole(level)
            kw = dict(fold=ff, form=form) if level == 0 and ff else {}
            x = getattr(self, f"enc{level}_conv1")(x, whole=whole, **kw)
            x = getattr(self, f"enc{level}_conv2")(x, whole=whole, **kw)
            if level < self.depth - 1:
                x = shard.gather(x, level)
                skips.append(x)  # level 0's skip stays folded
                x = (pool_folded(x, ff) if kw
                     else max_pool_3d(x, self.pool_size))
        for level in range(self.depth - 2, -1, -1):
            whole = shard.whole(level, decoder=True)
            kw = dict(fold=ff, form=form) if level == 0 and ff else {}
            skip = skips[level]
            if self.fuse:
                x = getattr(self, f"dec{level}_conv1")((x, skip), whole=whole,
                                                       **kw)
            else:
                x = torch.cat([getattr(self, f"dec{level}_up")(x), skip], -1)
                x = getattr(self, f"dec{level}_conv1")(x, whole=whole)
            x = getattr(self, f"dec{level}_conv2")(x, whole=whole, **kw)
            x = shard.cut(x, level)
        if ff is None:
            y = conv3d_ndhwc(x.float(), self.head.weight, self.head.bias)
            return y if logits else head_activation(y, self.activation_name)
        # the folded 1^3 head: a matmul per sub-voxel with the same
        # parameter, the activation per sub-voxel, then unfold
        n = ff[0] * ff[1] * ff[2]
        y = conv1_folded(x.float(), self.head.weight.permute(2, 3, 4, 1, 0),
                         self.head.bias, ff)
        if not logits:
            b, d, h, w, _ = y.shape
            y = head_activation(y.reshape(b, d, h, w, n, -1),
                                self.activation_name).reshape(b, d, h, w, -1)
        return shard.cut(unfold(y, ff), -1)
