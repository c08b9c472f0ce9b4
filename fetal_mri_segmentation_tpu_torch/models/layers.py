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

Depth-axis sharding (``parallel/spatial.py``): :func:`set_spatial_group`
gives every conv block and InstanceNorm of a model the process group of the
ranks that share a volume's depth, one slab each. A block then runs each 3^3
conv on its slab extended by its neighbours' rows (``parallel/
collectives.py::halo_exchange``) and an InstanceNorm takes its moments over
the whole volume. Max pooling, nearest upsampling, the transposed conv and
the 1^3 convs need no halo while a slab stays even. At the first level
whose slab rows are odd (:func:`gather_level`) the models gather that level
whole on every rank, run the coarser levels on it identically, with no halo
and local norm statistics (the blocks' ``whole`` argument), and each rank
keeps its own rows of that level's decoder output: what XLA's resharding
does for the JAX package.

Space-to-depth folding of the full-resolution level (``ops/fold.py``;
``fold_level0`` in the config): :func:`resolve_fold` turns a model's
setting into factors per forward, the conv blocks of level 0 run folded
(``ConvBlock.forward``'s ``fold``), and :func:`fold_override` /
:func:`decoder_form_override` pin the fold and the fused decoder's plain
formulation, as the JAX package's trace-time overrides do. The parameter
tree does not change.
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
    dec0_available, up_concat_conv3x3, up_concat_conv3x3_dilated,
    up_concat_conv3x3_kernel)
from fetal_mri_segmentation_tpu_torch.ops.fold import (
    conv1_folded, conv3_folded, conv3_folded_stride2, up_conv3_folded)
from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
    instance_norm_act, instance_norm_act_train)
from fetal_mri_segmentation_tpu_torch.parallel.collectives import (
    all_gather_cat, all_reduce_sum_grad, halo_exchange, own_rows)


class InstanceNorm(nn.Module):
    """Per sample and channel over (D, H, W), in fp32: biased variance, eps
    1e-3 inside the rsqrt, learned ``scale`` / ``bias`` per channel, the
    result in ``dtype`` (the JAX ``InstanceNorm``, keras-contrib's
    semantics), then the block's ``activation`` (``ConvBlock`` passes its
    own; "none" by default). ``eps`` and ``affine=False`` give other
    models' norms (Swin UNETR's: eps 1e-5, no affine): without affine,
    ``scale`` and ``bias`` are non-persistent buffers of ones and zeros,
    which both routes apply as they apply the learned ones.

    ``group`` (the spatial ranks' process group, :func:`set_spatial_group`):
    x is one depth slab of each sample, and the per-(sample, channel) sums
    of x and x^2 and the count are summed over the ranks with a
    differentiable all-reduce, so the moments are the whole volume's, as
    ``BatchNorm.group`` does for the batch (variance E[x^2] - E[x]^2,
    clipped at 0). ``whole``: x is a level every rank holds whole, and the
    moments are x's own.

    Where x is a CUDA tensor, no trace runs and the moments are x's own
    (:meth:`_takes_kernel`), the norm and the activation run as the fused
    kernel of ``ops/instance_norm.py``, which raises for a shape or type
    it does not take: with autograd recording nothing (serving),
    ``instance_norm_act`` (two launches); while autograd records
    (training), ``instance_norm_act_train``, the same two launches saving
    x and the fp32 moments, with a hand-written backward (three launches).
    Everywhere else (the CPU, depth slabs, ``torch.compile`` and
    ``torch.export``) as the plain fp32 ops of :meth:`_composite`, whose
    backward is autograd's."""

    def __init__(self, features: int, *, dtype: torch.dtype = torch.bfloat16,
                 device=None, group=None, eps: float = 1e-3,
                 affine: bool = True):
        super().__init__()
        self.dtype = dtype
        self.group = group
        self.epsilon = eps
        scale = torch.ones(features, device=device)
        bias = torch.zeros(features, device=device)
        if affine:
            self.scale, self.bias = nn.Parameter(scale), nn.Parameter(bias)
        else:
            self.register_buffer("scale", scale, persistent=False)
            self.register_buffer("bias", bias, persistent=False)

    def _takes_kernel(self, x: torch.Tensor, whole: bool) -> bool:
        return ((self.group is None or whole) and _kernel_device(x)
                and not torch.compiler.is_compiling())

    def forward(self, x: torch.Tensor, whole: bool = False, fold: int = 1,
                activation: str = "none",
                negative_slope: float = 0.01) -> torch.Tensor:
        """``fold`` (F > 1): x is space-to-depth folded, (B, d, h, w, F*C)
        sub-voxel-major (``ops/fold.py``), and the moments of each original
        channel are taken over (d, h, w, sub-voxel): exactly the unfolded
        volume's, since the fold permutes the same voxels. The kernel reads
        any fold as (B, N*F, C) and needs no ``fold``."""
        if self._takes_kernel(x, whole):
            if torch.is_grad_enabled():
                return instance_norm_act_train(
                    x, self.scale, self.bias, activation, negative_slope,
                    self.epsilon, self.dtype)
            return instance_norm_act(x, self.scale, self.bias, activation,
                                     negative_slope, self.epsilon, self.dtype)
        return self._composite(x, whole, fold, activation, negative_slope)

    def _composite(self, x: torch.Tensor, whole: bool, fold: int,
                   activation: str, negative_slope: float) -> torch.Tensor:
        xf = x.float()
        if fold > 1:
            xf = xf.reshape(*x.shape[:4], fold, x.shape[-1] // fold)
        dims = tuple(range(1, xf.dim() - 1))
        if self.group is None or whole:
            mean = xf.mean(dim=dims, keepdim=True)
            var = xf.var(dim=dims, correction=0, keepdim=True)
        else:
            b, c = xf.shape[0], xf.shape[-1]
            count = xf.new_full((1,), xf[0, ..., 0].numel())
            sums = all_reduce_sum_grad(torch.cat(
                [xf.sum(dim=dims).reshape(-1),
                 (xf * xf).sum(dim=dims).reshape(-1), count]), self.group)
            mean, mean_sq = (sums[:-1] / sums[-1]).reshape(
                2, b, *(1,) * len(dims), c)
            var = (mean_sq - mean * mean).clamp(min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = (y * self.scale + self.bias).reshape(x.shape).to(self.dtype)
        return apply_activation(y, activation, negative_slope)


class FoldedInstanceNorm(InstanceNorm):
    """InstanceNorm on a space-to-depth folded tensor (B, d, h, w, F*C),
    exact: per sample, the moments of each ORIGINAL channel over (d, h, w,
    sub-voxel) are the unfolded (D, H, W) moments. Parameters as
    :class:`InstanceNorm` ((C,) ``scale`` / ``bias``), so checkpoints
    interchange with the plain path; on a depth slab (``group``) the sums
    are all-reduced over the ranks as there. ``ConvBlock`` calls its
    InstanceNorm with ``fold=F`` on a folded level, which is this."""

    def __init__(self, features: int, fold: int, **kw):
        super().__init__(features, **kw)
        self.fold = fold

    def forward(self, x: torch.Tensor, whole: bool = False) -> torch.Tensor:
        return super().forward(x, whole=whole, fold=self.fold)


def _kernel_device(x: torch.Tensor) -> bool:
    """Whether x lies where the fused norm kernel runs: a CUDA device.
    Module-level, so a test can monkeypatch it to count the route's choices
    on CPU tensors."""
    return x.is_cuda


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3, dtype=float32)`` over
    the channel axis of NDHWC, the result in ``dtype``.

    In training (``self.training``) the batch's fp32 mean and biased
    variance (flax's E[x^2] - E[x]^2, clipped at 0) normalize, and the
    running buffers move as ``r <- momentum * r + (1 - momentum) * stat``.
    ``nn.BatchNorm3d`` is not this: it keeps the unbiased variance and takes
    momentum as 1 - 0.99. In eval the buffers normalize.

    ``group`` (a ``torch.distributed`` process group; the counterpart of
    flax's ``axis_name``, the JAX blocks' ``bn_axis_name``) makes it sync
    BatchNorm under data parallelism: in training the per-channel sums of x
    and x^2 and the count are summed over the ranks with a differentiable
    all-reduce, so the moments are the GLOBAL batch's, equal to the
    single-device step's on the same global batch, and the running buffers
    agree on every rank with no second reduction. ``nn.SyncBatchNorm`` is
    not this either (unbiased running variance, another momentum).
    ``whole_group``: the group for a level that every rank of a depth-sharded
    mesh holds whole (``whole``), the ranks that hold other samples, so that
    no voxel counts twice (None: this rank's batch alone)."""

    momentum, epsilon = 0.99, 1e-3

    def __init__(self, features: int, *, dtype: torch.dtype = torch.bfloat16,
                 device=None, group=None):
        super().__init__()
        self.dtype = dtype
        self.group = group
        self.whole_group = None
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, whole: bool = False) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            group = self.whole_group if whole else self.group
            if group is None:
                mean = xf.mean(dim=dims)
                mean_sq = (xf * xf).mean(dim=dims)
            else:
                count = torch.full_like(self.mean[:1],
                                        xf.numel() // xf.shape[-1])
                sums = all_reduce_sum_grad(torch.cat(
                    [xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]),
                    group)
                mean, mean_sq = (sums[:-1] / sums[-1]).chunk(2)
            var = (mean_sq - mean * mean).clamp(min=0.0)
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


def _dilated_backend_ok() -> bool:
    """Gate of the input-dilated decoder form when no override is set. The
    JAX package opens it on a TPU only, where that form was measured
    faster; the port has no TPU backend, so its heuristic always picks the
    parity form, as the JAX package does on CPU and GPU. Module-level, so a
    test can monkeypatch it to exercise the dispatch."""
    return False


# trace-time override of the fused decoder's formulation ("parity" |
# "dilated" | None = the heuristic above); see decoder_form_override
_DECODER_FORM_OVERRIDE: Optional[str] = None

# override of space-to-depth folding: "off" runs the plain level 0 even
# where a config asks for a fold (utils/export.py pins it for every
# artifact); see fold_override
_FOLD_OVERRIDE: Optional[str] = None

# the fold that fold_level0="auto" takes where its gates pass: W folded into
# the channels, the dense-embedded kernel (the JAX package's measured
# winner on the TPU it was tuned for)
FOLD_AUTO = ((1, 1, 2), "dense")


def _fold_backend_ok() -> bool:
    """Gate of ``fold_level0="auto"``. The JAX package folds automatically
    on a TPU only (``FETAL_TPU_FOLD=off`` turns even that off); the port
    has no TPU backend, so "auto" never folds, as on the JAX package's CPU
    and GPU backends. An explicit fold tuple still folds. Module-level, so
    a test can monkeypatch it to exercise the auto path."""
    return False


def resolve_fold(fold_level0, formulation: str, x,
                 extra_gates: bool = True):
    """A model's ``fold_level0`` setting resolved for the input ``x``.

    "auto" folds (``FOLD_AUTO``) only for a batch-1 input on a backend that
    passes :func:`_fold_backend_ok`, with the folded axes divisible and the
    model's own conditions (``extra_gates``) met; None / "off" never fold;
    an explicit tuple passes through. ``fold_override("off")`` pins every
    setting off. Returns ``(factors or None, formulation)``."""
    ff, form = fold_level0, formulation
    if ff in (None, "off"):
        ff = None
    elif ff == "auto":
        ff, form = FOLD_AUTO
        if not (extra_gates and x.shape[0] == 1 and _fold_backend_ok()
                and all(s % f == 0 for s, f in zip(x.shape[1:4], ff))):
            ff = None
    if _FOLD_OVERRIDE == "off":
        ff = None
    return ff, form


_BN_FOLD_ERROR = ("fold_factors requires norm-free conv blocks "
                  "(InstanceNorm is supported; BatchNorm is not)")


def check_unet_fold(fold_level0, fuse: bool, depth: int,
                    batch_normalization: bool) -> None:
    """Refuse, with the JAX package's messages, an explicit U-Net fold that
    its model refuses: one without the fused decoder (deconvolution, a pool
    other than 2) or below depth 2, or with BatchNorm, whose running
    statistics have no folded twin. "auto" is not refused: it falls back to
    the plain path where a gate fails."""
    if fold_level0 in (None, "auto", "off"):
        return
    if not fuse or depth < 2:
        raise ValueError("fold_level0 requires the fused decoder path "
                         "(no deconvolution, pool (2,2,2)) and depth>=2")
    if batch_normalization:
        raise ValueError(_BN_FOLD_ERROR)


class _Override:
    """A context manager that sets one of this module's trace-time
    overrides and restores the previous value on exit."""

    name = ""
    modes: Tuple = ()
    what = ""

    def __init__(self, mode: Optional[str]):
        if mode not in self.modes:
            raise ValueError(f"unknown {self.what} {mode!r}")
        self._mode = mode
        self._prev: Optional[str] = None

    def __enter__(self):
        self._prev = globals()[self.name]
        globals()[self.name] = self._mode
        return self

    def __exit__(self, *exc):
        globals()[self.name] = self._prev
        return False


class fold_override(_Override):
    """Pin space-to-depth folding while it is active::

        with fold_override("off"):   # the plain level 0 everywhere
            ...
    """

    name, modes, what = "_FOLD_OVERRIDE", (None, "off"), "fold override"


class decoder_form_override(_Override):
    """Pin the fused decoder's plain formulation while it is active
    ("parity", "dilated" or None for the heuristic)::

        with decoder_form_override("parity"):
            ...
    """

    name, what = "_DECODER_FORM_OVERRIDE", "decoder form"
    modes = (None, "parity", "dilated")


class ConvBlock(nn.Module):
    """Conv3D(same) -> optional BatchNorm / InstanceNorm -> activation
    (reference: unet3d/model/unet.py::create_convolution_block; the
    Isensee variant uses InstanceNorm + LeakyReLU, optional stride 2).
    ``bias=False``, ``norm_eps`` and ``norm_affine``: Swin UNETR's residual
    blocks (convs without bias, InstanceNorm with eps 1e-5 and no affine),
    which run the plain conv route and the same norm module.

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
    kernel runs with activation "none" and the norm and activation follow,
    as the JAX ``_pallas_path`` does (an InstanceNorm takes the activation
    into its own forward, where it may run as one fused kernel). A 1^3 or
    stride-2 conv stays on ``F.conv3d`` (XLA in the JAX package). On CPU tensors the
    kernel routes run the kernels' plain versions. Both routes are
    differentiable (the kernels' autograd Functions in ``ops/``). Outside
    autograd, both routes take the weight in the compute dtype once per
    version of the parameter, already K-major (the conv kernel's B operand)
    and kept as one tensor, so the fused-decoder kernel's own prepared
    weights are made once too.

    ``spatial_group`` (set by :func:`set_spatial_group`): x is this rank's
    depth slab. A stride-1 3^3 conv runs on the slab extended by one row of
    each neighbour and the two extra output rows are cropped (the kernel
    route pads SAME as it always does, so its launches and shapes are the
    unsharded route's but two rows deeper); a stride-2 SAME conv, which
    pads (0, 1) on an even extent, takes one row of the next rank and no
    zero row in D; the fused decoder takes one coarse row of each neighbour
    and two skip rows of each, which keeps the skip exactly twice the coarse
    grid, and crops two fine rows at each end. A rank with no neighbour on a
    side gets zeros there, the whole volume's SAME padding. ``whole`` (the
    ``forward`` argument): x is a level that every rank holds whole, so no
    halo is exchanged and the norm's statistics are x's own.

    ``fold`` (the ``forward`` argument; ``ops/fold.py``): x lives in
    space-to-depth folded layout with these per-axis factors and the conv
    runs folded, in the formulation ``form``, with the unfolded parameter:
    a 3^3 stride-1 conv (:func:`conv3_folded`), the fused decoder input
    (``x_deep`` at cell resolution, the skip folded), a 1^3 conv, or the
    3^3 stride-2 conv, whose output is unfolded (the next level's grid).
    InstanceNorm takes each original channel's moments over the spatial
    axes and the sub-voxels. A folded conv never takes a kernel route (the
    JAX package checks the fold before the Pallas routes), and a block with
    BatchNorm refuses it. On a depth slab the halo is one folded row, which
    is one row on an unfolded depth axis and two on a folded one, and the
    fused decoder's skip takes two rows (one folded row) of each neighbour.
    """

    def __init__(self, in_features: int, features: int, *,
                 kernel_size: int = 3, stride: int = 1,
                 batch_normalization: bool = False,
                 instance_normalization: bool = False,
                 activation: str = "relu", negative_slope: float = 0.3,
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernel_conv: bool = False,
                 use_kernel_dec0: bool = False, device=None, bn_group=None,
                 bias: bool = True, norm_eps: float = 1e-3,
                 norm_affine: bool = True):
        super().__init__()
        self.features = features
        self.kernel_size = kernel_size
        self.stride = stride
        self.activation = activation
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.use_kernel_conv = use_kernel_conv
        self.use_kernel_dec0 = use_kernel_dec0
        self.spatial_group = None
        self.conv = nn.Conv3d(in_features, features, kernel_size,
                              stride=stride, bias=bias, device=device)
        # the norm sits under flax's name ("bn" or "in"; "in" is a Python
        # keyword, so it is reached through _modules)
        self.norm_key = None
        if batch_normalization:
            self.norm_key = "bn"
            self.add_module("bn", BatchNorm(features, dtype=dtype,
                                            device=device, group=bn_group))
        elif instance_normalization:
            self.norm_key = "in"
            self.add_module("in", InstanceNorm(features, dtype=dtype,
                                               device=device, eps=norm_eps,
                                               affine=norm_affine))

    @property
    def kernel_activation(self) -> str:
        """The activation fused into a kernel: none where a norm follows."""
        return "none" if self.norm_key else self.activation

    def _epilogue(self, y: torch.Tensor, activated: bool = False,
                  whole: bool = False) -> torch.Tensor:
        """The norm and the activation after any conv route; ``activated``:
        the kernel already applied the activation (no norm). InstanceNorm
        applies the activation inside its own forward."""
        norm = self._modules[self.norm_key] if self.norm_key else None
        if isinstance(norm, InstanceNorm):
            return norm(y, whole=whole, activation=self.activation,
                        negative_slope=self.negative_slope)
        if norm is not None:
            y = norm(y, whole=whole)
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

        return cached(self.conv.weight, ("dhwio", self.dtype), dhwio)

    def forward(self, x, whole: bool = False, fold=None,
                form: str = "dense") -> torch.Tensor:
        if fold is not None:
            return self._folded(x, tuple(fold), form, whole)
        if isinstance(x, (tuple, list)):
            return self._fused_decoder(*x, whole=whole)
        ci = x.shape[-1]
        group = (self.spatial_group if self.kernel_size == 3 and not whole
                 else None)
        if group is not None:
            x = halo_exchange(x, group, 1 if self.stride == 1 else 0, 1)
        if (self.use_kernel_conv and self.kernel_size == 3
                and self.stride == 1 and conv3x3_available(ci, self.features)):
            op = conv3x3 if ci % 128 == 0 else conv3x3_flat
            y = op(x.to(self.dtype).contiguous(), self._kernel_dhwio(),
                   self.conv.bias.float(), self.kernel_activation,
                   self.negative_slope)
            if group is not None:
                y = y[:, 1:-1]
            return self._epilogue(y, activated=not self.norm_key,
                                  whole=whole)
        return self._epilogue(self._plain_conv(x.to(self.dtype),
                                               halo=group is not None),
                              whole=whole)

    def _plain_conv(self, x: torch.Tensor, halo: bool = False) -> torch.Tensor:
        """SAME conv + bias in the compute dtype (flax ``nn.Conv``): where
        XLA pads an axis unevenly (stride 2 over an even extent pads 0 low,
        1 high) the input is padded first. ``halo``: x's depth carries its
        neighbours' rows already, so D is not padded."""
        pads = [same_padding(n, self.kernel_size, self.stride)
                for n in x.shape[1:4]]
        if halo:
            pads[0] = (0, 0)
        padding = tuple(lo for lo, _ in pads)
        if any(lo != hi for lo, hi in pads):
            x = F.pad(x, (0, 0) + tuple(v for p in reversed(pads)
                                        for v in p))
            padding = 0
        bias = self.conv.bias
        return conv3d_ndhwc(x, self.conv.weight.to(self.dtype),
                            None if bias is None else bias.to(self.dtype),
                            padding=padding, stride=self.stride)

    def _fused_decoder(self, x_deep: torch.Tensor,
                       skip: Optional[torch.Tensor],
                       whole: bool = False) -> torch.Tensor:
        kernel = self._kernel_dhwio()
        x_deep = x_deep.to(self.dtype)
        group = None if whole else self.spatial_group
        if group is not None:
            x_deep = halo_exchange(x_deep, group, 1, 1)
            if skip is not None:
                skip = halo_exchange(skip, group, 2, 2)
        activated = False
        if (skip is not None and self.use_kernel_dec0
                and dec0_available(x_deep.shape, skip.shape,
                                   x_deep.shape[-1], skip.shape[-1],
                                   self.features)):
            y = up_concat_conv3x3_kernel(
                x_deep.contiguous(), skip.to(self.dtype).contiguous(),
                kernel, self.conv.bias.float(), self.kernel_activation,
                self.negative_slope)
            activated = not self.norm_key
        else:
            # two plain formulations of the same op and parameter: the
            # parity form, or the input-dilated conv where the override
            # asks for it (or, with none, where the JAX heuristic would:
            # training or a batch, on a backend that passes the gate)
            form = _DECODER_FORM_OVERRIDE or (
                "dilated" if (self.training or x_deep.shape[0] > 1)
                and _dilated_backend_ok() else "parity")
            impl = (up_concat_conv3x3_dilated if form == "dilated"
                    else up_concat_conv3x3)
            y = impl(x_deep, None if skip is None else skip.to(self.dtype),
                     kernel, self.conv.bias)
        if group is not None:
            y = y[:, 2:-2]
        return self._epilogue(y, activated=activated, whole=whole)

    def _folded(self, x, factors, form: str, whole: bool) -> torch.Tensor:
        """This block's conv on space-to-depth folded activations (the JAX
        ``ConvBlock._folded_path``), then the norm and the activation."""
        if self.norm_key == "bn":
            raise ValueError(_BN_FOLD_ERROR)
        n = factors[0] * factors[1] * factors[2]
        group = None if whole else self.spatial_group
        kernel = self._kernel_dhwio()
        if isinstance(x, (tuple, list)):
            # fused upsample(+concat)+conv: x_deep at cell resolution
            # (unfolded channels), the skip folded
            if self.kernel_size != 3 or self.stride != 1:
                raise ValueError("folded fused-decoder input needs a 3x3x3 "
                                 "stride-1 block")
            x_deep, skip = x
            halo = 2 // factors[0]  # two rows: one folded row if D folds
            if group is not None:
                x_deep = halo_exchange(x_deep, group, 1, 1)
                if skip is not None:
                    skip = halo_exchange(skip, group, halo, halo)
            up_ch = x_deep.shape[-1]
            y = up_conv3_folded(x_deep.to(self.dtype),
                                _part(kernel, 0, up_ch), factors)
            if skip is not None:
                y = y + conv3_folded(skip.to(self.dtype),
                                     _part(kernel, up_ch, kernel.shape[3]),
                                     None, factors, formulation=form)
            y = y + self.conv.bias.repeat(n).to(y.dtype)
            if group is not None:
                y = y[:, halo:-halo]
        elif self.kernel_size == 1 and self.stride == 1:
            y = conv1_folded(x.to(self.dtype), kernel, self.conv.bias,
                             factors)
        elif self.kernel_size == 3 and self.stride == 1:
            if group is not None:
                x = halo_exchange(x, group, 1, 1)
            y = conv3_folded(x.to(self.dtype), kernel, self.conv.bias,
                             factors, formulation=form)
            if group is not None:
                y = y[:, 1:-1]
        elif self.kernel_size == 3 and self.stride == 2:
            rows = x.shape[1] * factors[0] // 2
            if group is not None:
                # one folded row of the next rank (SAME stride 2 pads (0, 1)
                # on an even extent); on an unfolded depth one more zero
                # row keeps the extent even, and the rows past this rank's
                # outputs are cropped
                x = halo_exchange(x, group, 0, 1)
                if factors[0] == 1:
                    x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, 1))
            y = conv3_folded_stride2(x.to(self.dtype), kernel,
                                     self.conv.bias, factors)[:, :rows]
            # the output is UNFOLDED (the stride lands on the cell grid):
            # the norm and activation see plain channels
            return self._epilogue(y.to(self.dtype), whole=whole)
        else:
            k, st = self.kernel_size, self.stride
            raise ValueError(
                f"fold_factors supports 3x3x3 stride-1/2 and 1x1x1 blocks, "
                f"got kernel {(k,) * 3} strides {(st,) * 3}")
        y = y.to(self.dtype)
        if self.norm_key:
            return self._modules[self.norm_key](
                y, whole=whole, fold=n, activation=self.activation,
                negative_slope=self.negative_slope)
        return self._epilogue(y, whole=whole)


def _part(kernel: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Input channels [lo, hi) of a DHWIO kernel, one tensor per version of
    ``kernel`` (outside autograd), so the folded weights made from it are
    kept too."""
    return cached(kernel, ("channels", lo, hi), lambda k: k[:, :, :, lo:hi])


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
    dropped), on NDHWC; the result stays contiguous NDHWC.

    A window's gradient goes to its first maximum in row-major (d, h, w)
    window order, as flax's ``nn.max_pool`` (``reduce_window``) sends it:
    ``F.max_pool3d``'s indices are that first maximum, on the CPU and on
    CUDA. The NCDHW view of contiguous NDHWC is channels-last 3D, which
    the op takes as it lies."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(window), tuple(window))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def head_activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """Final activation over the channel axis (NDHWC)."""
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "softmax":
        return torch.softmax(x, dim=-1)
    if name in ("none", "linear", None):
        return x
    raise ValueError(f"unknown activation {name!r}")


def set_spatial_group(model: nn.Module, group) -> None:
    """Make ``model`` a depth-sharded model over ``group`` (None: whole
    volumes again): every conv block exchanges halos over it and every
    InstanceNorm takes its moments over it. The JAX package lets XLA's SPMD
    partitioner do this from a sharding annotation; a module owns its
    parameters, so the port sets the group in place, as
    ``parallel/data_parallel.py::set_bn_group`` does for BatchNorm."""
    model.spatial_group = group
    for m in model.modules():
        if isinstance(m, ConvBlock):
            m.spatial_group = group
        elif isinstance(m, InstanceNorm):
            m.group = group


def gather_level(rows: int, levels: int) -> Optional[int]:
    """The level a depth-sharded forward gathers whole: the first of the
    model's ``levels`` halvings (0 = full resolution) at which a slab of
    ``rows`` rows has an odd number of rows and so cannot be pooled, or
    None where every slab stays even. The JAX package asks only that the
    volume's dims survive the halvings and its depth split over the ranks
    (``parallel/spatial.py::SpatialPredictor._check_shape``); a level past
    this one is halved whole, as XLA reshards it."""
    for level in range(levels):
        if rows % 2:
            return level
        rows //= 2
    return None


class LevelSharding:
    """How one depth-sharded forward runs its levels: sharded over
    ``group`` up to the encoder output of level ``level``, which is
    gathered whole (:func:`gather`), every coarser level whole on every
    rank, and this rank's rows taken back (:func:`cut`) from the decoder
    output of ``level``. ``level`` None (or no group): nothing is gathered.
    A level 0 folded on the depth axis (``fold_depth`` 2) cannot fold an
    odd slab: there ``level`` is -1, the input is gathered whole
    (``gather(x, -1)``) and the output cut (``cut(y, -1)``).
    """

    def __init__(self, group, rows: int, levels: int, fold_depth: int = 1):
        self.group = group
        self.level = (None if group is None
                      else gather_level(rows, levels))
        if self.level == 0 and fold_depth == 2:
            self.level = -1

    def whole(self, level: int, decoder: bool = False) -> bool:
        """Whether ``level``'s encoder (or ``decoder``) blocks see whole
        tensors: the gathered level runs its encoder blocks sharded and its
        decoder blocks whole."""
        g = self.level
        return g is not None and (level > g or (decoder and level == g))

    def gather(self, x: torch.Tensor, level: int) -> torch.Tensor:
        if level != self.level:
            return x
        return all_gather_cat(x, self.group)

    def cut(self, x: torch.Tensor, level: int) -> torch.Tensor:
        if level != self.level:
            return x
        return own_rows(x, self.group)
