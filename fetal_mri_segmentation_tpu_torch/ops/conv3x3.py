"""Fused 3x3x3 conv + bias + activation: the Hopper kernel and its plain twin.

Port of the two TPU conv kernels, which share one contract
(``fetal_mri_segmentation_tpu/ops/pallas_conv.py::conv3x3``, the halo-slab
kernel K1, and ``ops/pallas_conv_flat.py::conv3x3_flat`` /
``conv3x3_chain``, the flat-plane kernel K2)::

    y[b, d, h, w, co] = act(sum_{kd,kh,kw,ci} x[b, d+kd-1, h+kh-1, w+kw-1, ci]
                            * W[kd, kh, kw, ci, co] + bias[co])

NDHWC activations, DHWIO weights, fp32 bias, SAME padding, stride 1,
activation in relu / leaky_relu / none. One CUDA kernel
(``csrc/conv3x3.cu``) serves all three entry points: the TPU's flat layout
was a lane-rotation device and is not carried over, so ``conv3x3_chain`` is
successive NDHWC launches with no relayout between them.

The kernel reads the weight K-major, as (C_out, 27, C_in). A DHWIO ``w``
that is a view of such a tensor (``kmajor_weight(w).permute(1, 2, 3, 4, 0)``
has that form; ``models/layers.py::ConvBlock`` passes one) is read in place;
any other ``w`` is transposed once per version of the tensor and the copy
kept with it (``cuda_lib.cached``). :func:`tile_plan` gives the kernel's
tile box, K step, N tile, tile counts and TMA maps.

On a CPU tensor each entry point runs :func:`conv3x3_reference` (``F.conv3d``
plus bias and activation). On a CUDA tensor it launches the kernel (bf16
operands, fp32 bias) or raises. Each entry point counts its launches in its
``launches`` attribute; ``conv3x3_chain`` launches through ``conv3x3_flat``.

Both entry points are differentiable on either device: the forward runs in
a ``torch.autograd.Function`` (:class:`_FusedConv`) whose backward is
:func:`conv3x3_vjp`, the port of the JAX custom VJP
(``pallas_conv.py::_bwd``, shared by ``conv3x3_flat``): plain fp32 ops that
recompute the pre-activation and never launch the kernel.

On a CUDA tensor the forward reaches the kernel through the custom op
``torch.ops.fetal.conv3x3`` (:func:`conv3x3_op`), registered for CUDA
only: its implementation is the ctypes launch with its host planning
(weight repack, tile plan, tensor maps, the launch count), and its fake
implementation gives the output's shape, dtype and strides, so that
``torch.export`` can trace a model through the kernel and keep the op in
the exported program (``utils/export.py``). The op reached with a CPU
tensor raises; the entry points never send it one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from fetal_mri_segmentation_tpu_torch.ops import cuda_lib, tiling


def conv3x3_available(ci: int, co: int) -> bool:
    """The one eligibility gate, decided before any launch: C_in >= 8 (the
    1-channel stem keeps ``F.conv3d``, as it kept XLA on the TPU) and both
    channel counts multiples of 8 (the kernel moves 16-byte vectors)."""
    return ci >= 8 and ci % 8 == 0 and co % 8 == 0


def conv3d_ndhwc(x: torch.Tensor, weight_oidhw: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 padding=0, stride: int = 1) -> torch.Tensor:
    """``F.conv3d`` on NDHWC activations with a PyTorch OIDHW weight.

    The permuted input is a channels_last_3d view, and the weight is passed
    in the same memory format, so the convolution reads and writes
    channels-last and the result is NDHWC without a relayout."""
    w = weight_oidhw.contiguous(memory_format=torch.channels_last_3d)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 4, 1)


def apply_activation(y: torch.Tensor, activation: str,
                     negative_slope: float) -> torch.Tensor:
    if activation == "relu":
        return F.relu(y)
    if activation == "leaky_relu":
        return F.leaky_relu(y, negative_slope)
    if activation == "none":
        return y
    raise ValueError(f"unknown activation {activation!r}")


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      activation: str = "relu",
                      negative_slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch version: conv in x's dtype, bias and activation in
    fp32, result in x's dtype (the kernel's fp32-accumulate, bf16-store
    contract)."""
    y = conv3d_ndhwc(x, w.to(x.dtype).permute(4, 3, 0, 1, 2), padding=1)
    y = apply_activation(y.float() + bias.float(), activation, negative_slope)
    return y.to(x.dtype)


def _check(name: str, x: torch.Tensor, w: torch.Tensor,
           bias: torch.Tensor) -> None:
    if x.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.shape[3] != x.shape[-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not NDHWC / (3, 3, 3, C_in, C_out)")
    if bias.shape != (w.shape[4],):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != (C_out,)")
    if not conv3x3_available(w.shape[3], w.shape[4]):
        raise ValueError(f"{name}: C_in={w.shape[3]}, C_out={w.shape[4]} "
                         "fails conv3x3_available (C_in >= 8, channels % 8)")


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``conv3x3_kernel`` covers one call (``csrc/conv3x3.cu``)."""

    shape: tuple[int, int, int, int]      # B, D, H, W
    co: int
    kb: int                               # channels per K step (64 or 32)
    chunks: int                           # K chunks per tap
    box: tuple[int, int, int]             # TD, TH, TW: the M tile's voxels
    tiles: tuple[int, int, int]           # boxes along D, H, W
    m_tiles: int                          # B * boxes
    n_tiles: int
    bn: int                               # N tile
    maps: tuple[tiling.TensorMap, ...]    # x, then the K-major weight "w"

    @property
    def geom(self) -> tuple[int, ...]:
        """The kernel's ConvGeom, field for field."""
        return (*self.shape, self.co, self.chunks, *self.box, *self.tiles,
                self.m_tiles, self.n_tiles)

    @property
    def bm(self) -> int:
        return self.box[0] * self.box[1] * self.box[2]

    @property
    def total_tiles(self) -> int:
        return self.m_tiles * self.n_tiles


@functools.cache
def tile_plan(B: int, D: int, H: int, W: int, ci: int, co: int) -> ConvPlan:
    bn, kb = tiling.choose_bn(co), tiling.choose_kb(ci)
    box = tiling.tile_box(D, H, W, tiling.tile_voxels(bn))
    tiles = tiling.tile_counts((D, H, W), box)
    maps = (tiling.ndhwc_map("x", (B, D, H, W, ci), box, kb=kb),
            tiling.weight_map("w", (co, 27, ci), bn, kb))
    return ConvPlan((B, D, H, W), co, kb, tiling.ceil_div(ci, kb), box,
                    tiles, B * tiles[0] * tiles[1] * tiles[2],
                    tiling.ceil_div(co, bn), bn, maps)


def load_coords(plan: ConvPlan, it: int, b: int, d0: int, h0: int, w0: int,
                n0: int):
    """The TMA coordinates of K step ``it`` of the block at (b, d0, h0, w0),
    N offset n0: ((x map coords), (w map coords)), innermost first. Mirror
    of ``conv3x3_kernel``'s ``issue``."""
    tap, chunk = divmod(it, plan.chunks)
    c0 = chunk * plan.kb
    kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
    return ((c0, w0 + kw - 1, h0 + kh - 1, d0 + kd - 1, b),
            (c0, tap, n0))


def kmajor_weight(w: torch.Tensor) -> torch.Tensor:
    """DHWIO (3, 3, 3, C_in, C_out) -> the kernel's B operand
    (C_out, 3, 3, 3, C_in), contiguous; a view of one is returned as is."""
    wk = w.permute(4, 0, 1, 2, 3)
    if wk.is_contiguous():
        return wk
    return cuda_lib.cached(w, "kmajor", lambda t: t.permute(
        4, 0, 1, 2, 3).contiguous())


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            activation: str, negative_slope: float) -> torch.Tensor:
    cuda_lib.require_cuda_bf16(name, x=x, bias=bias)
    wk = kmajor_weight(w)
    cuda_lib.require_cuda_bf16(name, x=x, w=wk, bias=bias)
    B, D, H, W, ci = x.shape
    co = wk.shape[0]
    plan = tile_plan(B, D, H, W, ci, co)
    y = torch.empty((B, D, H, W, co), dtype=torch.bfloat16, device=x.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        err = lib.fetal_conv3x3_bf16(
            tiling.pack_specs(plan.maps, {"x": x, "w": wk}),
            tiling.pack_ints(plan.geom), bias.data_ptr(), y.data_ptr(),
            plan.bn, plan.kb,
            tiling.grid_blocks(plan.total_tiles, x.device),
            cuda_lib.ACTIVATIONS[activation],
            float(negative_slope), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check_launch(name, err)
    return y


def conv3x3_vjp(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                g: torch.Tensor, activation: str, negative_slope: float,
                needs=(True, True, True)):
    """(dx, dw, db) of the fused conv for the output cotangent ``g``.

    Port of ``pallas_conv.py::_bwd``: autograd of :func:`conv3x3_reference`
    on fp32 copies of x, w and bias, so the pre-activation is recomputed in
    fp32 (one extra fp32 conv per layer) and the activation's derivative is
    taken at it (relu: ``pre > 0``; leaky_relu: 1 or the slope); the
    gradients come back in their inputs' dtypes. The fp32 convolutions run
    through cuDNN under PyTorch's own ``torch.backends.cudnn.allow_tf32``
    (true by default). ``needs`` skips the gradients nobody asked for; a
    skipped one is None."""
    inputs = (x, w, bias)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(n)
                  for t, n in zip(inputs, needs)]
        y = conv3x3_reference(*leaves, activation, negative_slope)
    wanted = [t for t in leaves if t.requires_grad]
    grads = list(torch.autograd.grad(y, wanted, g.float())
                 if wanted else [])
    return tuple(grads.pop(0).to(t.dtype) if n else None
                 for t, n in zip(inputs, needs))


@torch.library.custom_op("fetal::conv3x3", mutates_args=(),
                         device_types="cuda")
def conv3x3_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               activation: str, negative_slope: float,
               entry: str) -> torch.Tensor:
    """One launch of ``conv3x3_kernel`` on CUDA tensors: x (B, D, H, W,
    C_in) bf16, w DHWIO (3, 3, 3, C_in, C_out) bf16, bias (C_out,) fp32 ->
    y (B, D, H, W, C_out) bf16, contiguous. ``entry`` names the public
    entry point (``conv3x3`` or ``conv3x3_flat``) whose ``launches`` counts
    it."""
    y = _launch(entry, x, w, bias, activation, negative_slope)
    _ENTRIES[entry].launches += 1
    return y


@conv3x3_op.register_fake
def _conv3x3_fake(x, w, bias, activation, negative_slope, entry):
    return x.new_empty((*x.shape[:4], w.shape[4]), dtype=torch.bfloat16)


class _FusedConv(torch.autograd.Function):
    """One fused conv with its gradient: the kernel (or, on a CPU tensor,
    its plain version) forward, :func:`conv3x3_vjp` backward. ``entry`` is
    the public function whose ``launches`` counts the kernel."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, negative_slope, entry):
        ctx.save_for_backward(x, w, bias)
        ctx.act = (activation, negative_slope)
        if x.device.type == "cpu":
            return conv3x3_reference(x, w, bias, activation, negative_slope)
        if x.device.type != "cuda" and not torch.compiler.is_compiling():
            # a meta tensor reaches the op's fake implementation only in a
            # trace; anywhere else the kernel refuses it
            cuda_lib.require_cuda_bf16(entry.__name__, x=x)
        return conv3x3_op(x, w, bias, activation, float(negative_slope),
                          entry.__name__)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        grads = conv3x3_vjp(x, w, bias, g, *ctx.act,
                            needs=ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def conv3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            activation: str = "relu",
            negative_slope: float = 0.01) -> torch.Tensor:
    """Port of K1 (``pallas_conv.py::conv3x3``): fused conv on NDHWC."""
    _check("conv3x3", x, w, bias)
    return _FusedConv.apply(x, w, bias, activation, negative_slope, conv3x3)


def conv3x3_flat(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 activation: str = "relu",
                 negative_slope: float = 0.3) -> torch.Tensor:
    """Port of K2 (``pallas_conv_flat.py::conv3x3_flat``): the same
    contract for any C_in >= 8; the same kernel as :func:`conv3x3`."""
    _check("conv3x3_flat", x, w, bias)
    return _FusedConv.apply(x, w, bias, activation, negative_slope,
                            conv3x3_flat)


conv3x3.launches = 0
conv3x3_flat.launches = 0
_ENTRIES = {f.__name__: f for f in (conv3x3, conv3x3_flat)}


def conv3x3_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  activations: Sequence[str] = ("relu",),
                  negative_slope: float = 0.01) -> torch.Tensor:
    """A chain of fused convs (a U-Net level's conv pair): successive NDHWC
    launches, each output feeding the next with no relayout."""
    if not len(weights) == len(biases) == len(activations):
        raise ValueError("conv3x3_chain: weights, biases and activations "
                         "differ in length")
    for w, b, act in zip(weights, biases, activations):
        x = conv3x3_flat(x, w.to(x.dtype), b, act, negative_slope)
    return x
