"""Fused InstanceNorm + activation: the Hopper kernel and its plain twin.

No TPU kernel is ported here: the JAX package normalizes in plain XLA ops.
This replaces the port's eager composite on the serving path
(``models/layers.py::InstanceNorm`` followed by ``apply_activation``)::

    y[b, n, c] = act(T((x[b, n, c] - mean[b, c]) * rsqrt(var[b, c] + eps)
                       * scale[c] + bias[c]))

over x seen as (B, N, C), with C the length of ``scale``: an NDHWC tensor
(N voxels a sample) or a space-to-depth folded one (B, d, h, w, F*C), whose
channels are sub-voxel-major, read as (B, N*F, C), which gives each
original channel's moments over the voxels and the sub-voxels exactly as
``FoldedInstanceNorm`` takes them. Moments in fp32 (biased variance); the
value is rounded to x's type T before the activation, as the composite
rounds before its activation.

:func:`instance_norm_act` on a CPU tensor runs
:func:`instance_norm_act_reference`; on a CUDA tensor it makes two
launches of ``csrc/instance_norm.cu`` (moments per chunk of rows, then the
merge and the normalized output) on the current stream, or raises. Host
cost is the point as much as the bytes: one Python call, two
``torch.empty`` (the output and the moments' scratch) and one ctypes call
a norm, the launch's checks and plan kept per shape, no synchronize and no
copy of a contiguous x; while a profiler runs, the launches sit in a host
op named ``PROFILER_NAME``, so that the profiler links the kernels to it
and to the ranges around it. The function counts its kernel launches in its ``launches``
attribute. There is no backward: the layers route here only where autograd
records nothing (``InstanceNorm._takes_kernel``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

from fetal_mri_segmentation_tpu_torch.ops import cuda_lib
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import apply_activation

THREADS = 256    # csrc/instance_norm.cu::kNormThreads
UNROLL = 4       # csrc/instance_norm.cu::kUnroll
MAX_CHANNELS = 1024
BLOCKS_PER_SM = 4
# the host op the two launches sit in while a profiler runs
PROFILER_NAME = "fetal::instance_norm_act"


@functools.cache
def _available(shape, dtype, scale_shape, scale_dtype) -> bool:
    """Whether the kernel takes x of this shape and type with per-channel
    parameters of these: bf16 or fp32 x whose last axis is a multiple of
    C, C a multiple of 8 (16-byte vectors) up to ``MAX_CHANNELS``, fp32
    parameters, no empty sample."""
    c = scale_shape[0]
    return (dtype in (torch.bfloat16, torch.float32)
            and scale_dtype == torch.float32 and len(scale_shape) == 1
            and c % 8 == 0 and c <= MAX_CHANNELS and len(shape) >= 2
            and shape[-1] % c == 0 and math.prod(shape) > 0)


def instance_norm_act_reference(x: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, activation: str = "none",
                                negative_slope: float = 0.01,
                                eps: float = 1e-3,
                                dtype: torch.dtype | None = None
                                ) -> torch.Tensor:
    """Plain version over the (B, N, C) view: two-pass fp32 moments over N,
    the normalized fp32 value in ``dtype`` (x's by default), then the
    activation."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = xf.var(dim=1, correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return apply_activation(y.to(dtype or x.dtype), activation,
                            negative_slope)


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """How the two launches cover (B, rows, C)."""

    chunks: int       # stats blocks a sample, each ``chunk_rows`` rows
    chunk_rows: int
    blocks: int       # apply blocks a sample


@functools.cache
def norm_plan(batch: int, rows: int, channels: int, vec: int,
              sms: int) -> NormPlan:
    """About ``BLOCKS_PER_SM`` blocks an SM for each launch, in all samples
    together (Isensee's level 0 has B x C = 128 (sample, channel) pairs, far
    fewer than the card's SMs), with at least ``UNROLL`` rows a stats thread
    and ``UNROLL`` vectors an apply thread. ``vec``: elements in 16 bytes."""
    per_pass = THREADS // (channels // vec)  # rows one stats block reads at once
    want = -(-BLOCKS_PER_SM * sms // batch)
    chunk_rows = max(-(-rows // want), UNROLL * per_pass)
    nvec = rows * channels // vec
    return NormPlan(-(-rows // chunk_rows), chunk_rows,
                    max(1, min(want, -(-nvec // (THREADS * UNROLL)))))


@functools.cache
def _geometry(shape, dtype, device: int, scale_shape, scale_dtype,
              scale_device: int, bias_shape, bias_dtype, bias_device: int,
              activation: str, out_dtype):
    """A launch's operands checked and planned once per their shapes, types
    and devices (``device`` -1: not a CUDA tensor): the C entry's geometry
    and the scratch's length in floats."""
    if not (device >= 0 and _available(shape, dtype, scale_shape, scale_dtype)
            and out_dtype == dtype
            and bias_dtype == torch.float32 and bias_shape == scale_shape
            and scale_device == device == bias_device
            and activation in cuda_lib.ACTIVATIONS):
        raise ValueError(
            f"instance_norm_act: x {tuple(shape)} {dtype} on device {device}, "
            f"scale {tuple(scale_shape)} {scale_dtype} on {scale_device}, "
            f"bias {tuple(bias_shape)} {bias_dtype} on {bias_device}, "
            f"{activation!r}, result {out_dtype}: the kernel takes bf16 or "
            "fp32 x on a CUDA device and writes x's type, fp32 (C,) "
            f"parameters on the same device, C % 8 == 0, C <= {MAX_CHANNELS} "
            "dividing x's last axis, an activation of "
            f"{sorted(cuda_lib.ACTIVATIONS)}")
    batch, channels = shape[0], scale_shape[0]
    rows = math.prod(shape) // (batch * channels)
    bf16 = dtype == torch.bfloat16
    plan = norm_plan(batch, rows, channels, 8 if bf16 else 4,
                     torch.cuda.get_device_properties(
                         device).multi_processor_count)
    geom = (ctypes.c_longlong * 8)(
        batch, rows, channels, plan.chunks, plan.chunk_rows, plan.blocks,
        int(bf16), cuda_lib.ACTIVATIONS[activation])
    return geom, batch * plan.chunks * channels * 2


def _enqueue(xp: int, yp: int, part: int, scale: int, bias: int, geom,
             eps: float, negative_slope: float, device: int) -> int:
    """Both launches on the current stream of ``device``, the current
    device."""
    args = (xp, yp, part, scale, bias, geom, eps, negative_slope,
            torch._C._cuda_getCurrentRawStream(device))
    if _profiler._is_profiler_enabled:
        # the profiler links a kernel to the host op open at its launch; a
        # launch from C outside any op would be linked to none, and no
        # range around the call would count its device time
        with _RecordFunctionFast(PROFILER_NAME):
            return cuda_lib.library().fetal_instance_norm_act(*args)
    return cuda_lib.library().fetal_instance_norm_act(*args)


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            activation: str, negative_slope: float, eps: float,
            dtype: torch.dtype) -> torch.Tensor:
    device = x.get_device() if x.is_cuda else -1
    geom, part_numel = _geometry(
        x.shape, x.dtype, device, scale.shape, scale.dtype,
        scale.get_device(), bias.shape, bias.dtype, bias.get_device(),
        activation, dtype)
    if not x.is_contiguous():
        x = x.contiguous()
    xp = x.data_ptr()
    if xp % 16:  # a view whose offset breaks the 16-byte loads
        x = x.clone()
        xp = x.data_ptr()
    y = torch.empty_like(x)
    # launches on one stream run in order, so the scratch may go back to
    # the caching allocator as soon as both are enqueued
    part = torch.empty(part_numel, dtype=torch.float32, device=x.device)
    args = (xp, y.data_ptr(), part.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), geom, eps, negative_slope, device)
    if device == torch.cuda.current_device():
        err = _enqueue(*args)
    else:
        with torch.cuda.device(device):
            err = _enqueue(*args)
    cuda_lib.check_launch("instance_norm_act", err)
    return y


def instance_norm_act(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, activation: str = "none",
                      negative_slope: float = 0.01,
                      eps: float = 1e-3,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """InstanceNorm with ``scale`` / ``bias`` (C,) over x (B, ..., k*C)
    seen as (B, N, C), then ``activation``; the result in x's shape and in
    ``dtype`` (x's by default). A CPU tensor takes the plain version, a
    CUDA tensor the kernel (two launches, writing x's type) or an error."""
    if x.is_cpu:
        view = x.reshape(x.shape[0], -1, scale.shape[0])
        return instance_norm_act_reference(
            view, scale, bias, activation, negative_slope, eps,
            dtype).reshape(x.shape)
    y = _launch(x, scale, bias, activation, negative_slope, eps,
                dtype or x.dtype)
    instance_norm_act.launches += 2
    return y


instance_norm_act.launches = 0
