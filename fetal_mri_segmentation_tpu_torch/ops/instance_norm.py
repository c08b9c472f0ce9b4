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
attribute. It has no backward: the layers route here where autograd
records nothing (serving).

Where autograd records (training), the layers route to
:func:`instance_norm_act_train` (``InstanceNorm._takes_kernel``), an
autograd Function over the same kernels. Its forward makes the same two
launches through the same C entry, given a moments pointer where serving
passes null: the apply launch (instantiated apart, so that serving writes
no moments) then also writes the per-(sample, channel) fp32 mean and rstd.
It saves x and those (2, B, C) moments and counts its launches in
``instance_norm_act.launches``. Its
backward, :func:`instance_norm_act_backward`, makes three launches (the
partial sums of dz and dz * x^ per chunk of rows, then dx, then dscale and
dbias summed in a fixed order; two where neither ``scale`` nor ``bias``
wants a gradient) with the forward's host cost, counts them in
``instance_norm_act_backward.launches``, and runs inside a
``norm.backward`` span (``utils/profiling.py``) under the request of the
step that ran the forward. On a CPU tensor both run their plain twins
(:func:`instance_norm_moments_reference`,
:func:`instance_norm_act_backward_reference`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler
from torch.autograd.function import once_differentiable

from fetal_mri_segmentation_tpu_torch.ops import cuda_lib
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import apply_activation
from fetal_mri_segmentation_tpu_torch.utils.profiling import (
    request_of, span, tag)

THREADS = 256    # csrc/instance_norm.cu::kNormThreads
UNROLL = 4       # csrc/instance_norm.cu::kUnroll
MAX_CHANNELS = 1024
BLOCKS_PER_SM = 4
# the host ops the launches sit in while a profiler runs: the forward's
# two (serving and training), the backward's
PROFILER_NAME = "fetal::instance_norm_act"
BACKWARD_PROFILER_NAME = "fetal::instance_norm_act_backward"


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


def instance_norm_moments_reference(x: torch.Tensor,
                                    eps: float = 1e-3) -> torch.Tensor:
    """The moments the training forward saves, over the (B, N, C) view:
    (2, B, C) fp32, the mean over N, then rsqrt(biased variance + eps)."""
    xf = x.float()
    var = xf.var(dim=1, correction=0)
    return torch.stack([xf.mean(dim=1), torch.rsqrt(var + eps)])


def instance_norm_act_backward_reference(
        dy: torch.Tensor, x: torch.Tensor, moments: torch.Tensor,
        scale: torch.Tensor, bias: torch.Tensor, activation: str = "none",
        negative_slope: float = 0.01):
    """Plain backward over the (B, N, C) view, in fp32: z, the forward's
    value in its type (dy's), recomputed from x and ``moments``; dz = dy *
    act'(z); with x^ = (x - mean) * rstd and the sums S1 = sum_N dz, S2 =
    sum_N dz * x^, dx = rstd * scale * (dz - S1 / N - x^ * S2 / N) in x's
    type, and the (2, C) fp32 parameter gradients (dscale = sum_B S2, dbias
    = sum_B S1)."""
    if activation not in cuda_lib.ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    xf = x.float()
    mean, rstd = moments[0].unsqueeze(1), moments[1].unsqueeze(1)
    a = rstd * scale.float()
    dz = dy.float()
    if activation != "none":
        z = ((xf - mean) * a + bias.float()).to(dy.dtype)
        slope = negative_slope if activation == "leaky_relu" else 0.0
        dz = torch.where(z > 0, dz, dz * slope)
    xhat = (xf - mean) * rstd
    n = x.shape[1]
    s1 = dz.sum(dim=1, keepdim=True)
    s2 = (dz * xhat).sum(dim=1, keepdim=True)
    dx = a * (dz - s1 / n - xhat * (s2 / n))
    return dx.to(x.dtype), torch.stack([s2.sum(dim=(0, 1)),
                                        s1.sum(dim=(0, 1))])


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


def _enqueue(entry: str, op: str, args, device: int) -> int:
    """The C ``entry`` on the current stream of ``device``, the current
    device."""
    fn = getattr(cuda_lib.library(), entry)
    args = (*args, torch._C._cuda_getCurrentRawStream(device))
    if _profiler._is_profiler_enabled:
        # the profiler links a kernel to the host op open at its launch; a
        # launch from C outside any op would be linked to none, and no
        # range around the call would count its device time
        with _RecordFunctionFast(op):
            return fn(*args)
    return fn(*args)


def _run(entry: str, op: str, args, device: int) -> None:
    if device == torch.cuda.current_device():
        err = _enqueue(entry, op, args, device)
    else:
        with torch.cuda.device(device):
            err = _enqueue(entry, op, args, device)
    cuda_lib.check_launch(entry[len("fetal_"):], err)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, copied only where it is not
    (a view whose offset breaks the 16-byte loads)."""
    if not t.is_contiguous():
        t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            activation: str, negative_slope: float, eps: float,
            dtype: torch.dtype, train: bool = False):
    """y; with ``train``, (y, x as the kernel read it, the moments)."""
    device = x.get_device() if x.is_cuda else -1
    geom, part_numel = _geometry(
        x.shape, x.dtype, device, scale.shape, scale.dtype,
        scale.get_device(), bias.shape, bias.dtype, bias.get_device(),
        activation, dtype)
    x = _operand(x)
    y = torch.empty_like(x)
    # launches on one stream run in order, so the scratch may go back to
    # the caching allocator as soon as both are enqueued
    part = torch.empty(part_numel, dtype=torch.float32, device=x.device)
    moments = (torch.empty(2, geom[0], scale.shape[0], dtype=torch.float32,
                           device=x.device) if train else None)
    _run("fetal_instance_norm_act", PROFILER_NAME,
         (x.data_ptr(), y.data_ptr(), part.data_ptr(), scale.data_ptr(),
          bias.data_ptr(), moments.data_ptr() if train else None, geom, eps,
          negative_slope), device)
    return (y, x, moments) if train else y


def _launch_backward(dy: torch.Tensor, x: torch.Tensor,
                     moments: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, activation: str,
                     negative_slope: float, params: bool):
    device = x.get_device()
    geom, part_numel = _geometry(
        x.shape, x.dtype, device, scale.shape, scale.dtype,
        scale.get_device(), bias.shape, bias.dtype, bias.get_device(),
        activation, x.dtype)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"instance_norm_act_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} for x {tuple(x.shape)} {x.dtype}")
    dy = _operand(dy)
    dx = torch.empty_like(x)
    part = torch.empty(part_numel, dtype=torch.float32, device=x.device)
    dparams = (torch.empty(2, scale.shape[0], dtype=torch.float32,
                           device=x.device) if params else None)
    _run("fetal_instance_norm_act_backward", BACKWARD_PROFILER_NAME,
         (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), moments.data_ptr(),
          part.data_ptr(), scale.data_ptr(), bias.data_ptr(),
          dparams.data_ptr() if params else None, geom, negative_slope),
         device)
    return dx, dparams


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


def instance_norm_act_backward(dy: torch.Tensor, x: torch.Tensor,
                               moments: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, activation: str = "none",
                               negative_slope: float = 0.01,
                               params: bool = True):
    """(dx in x's shape and type, the (2, C) fp32 dscale and dbias or None
    without ``params``) of :func:`instance_norm_act_train` at x, from the
    moments its forward saved. A CPU tensor takes the plain version, a CUDA
    tensor the kernel (three launches, two without ``params``) or an
    error."""
    if x.is_cpu:
        c = scale.shape[0]
        dx, dparams = instance_norm_act_backward_reference(
            dy.reshape(x.shape[0], -1, c), x.reshape(x.shape[0], -1, c),
            moments, scale, bias, activation, negative_slope)
        return dx.reshape(x.shape), dparams if params else None
    dx, dparams = _launch_backward(dy, x, moments, scale, bias, activation,
                                   negative_slope, params)
    instance_norm_act_backward.launches += 3 if params else 2
    return dx, dparams


instance_norm_act_backward.launches = 0


class _InstanceNormAct(torch.autograd.Function):
    """The fused norm and activation while autograd records: x, scale and
    bias in, y in ``dtype`` (x's by default) out; x and the fp32 moments
    saved."""

    @staticmethod
    def forward(ctx, x, scale, bias, activation, negative_slope, eps,
                dtype):
        if x.is_cpu:
            view = x.reshape(x.shape[0], -1, scale.shape[0])
            moments = instance_norm_moments_reference(view, eps)
            y = instance_norm_act_reference(
                view, scale, bias, activation, negative_slope, eps,
                dtype).reshape(x.shape)
        else:
            y, x, moments = _launch(x, scale, bias, activation,
                                    negative_slope, eps, dtype or x.dtype,
                                    train=True)
            instance_norm_act.launches += 2
        ctx.save_for_backward(x, scale, bias, moments)
        ctx.activation, ctx.negative_slope = activation, negative_slope
        # autograd runs a CUDA backward on its own thread: the span there
        # joins the request of the step that ran the forward
        tag(ctx)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, moments = ctx.saved_tensors
        wants = ctx.needs_input_grad
        with span("norm.backward", request=request_of(ctx)):
            dx, dparams = instance_norm_act_backward(
                dy, x, moments, scale, bias, ctx.activation,
                ctx.negative_slope, params=wants[1] or wants[2])
        return (dx, dparams[0] if wants[1] else None,
                dparams[1] if wants[2] else None, None, None, None, None)


def instance_norm_act_train(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, activation: str = "none",
                            negative_slope: float = 0.01,
                            eps: float = 1e-3,
                            dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
    """:func:`instance_norm_act` for autograd: the result in ``dtype``
    (x's by default), differentiable in x, ``scale`` and ``bias`` through
    :func:`instance_norm_act_backward`. The same two forward launches on a
    CUDA tensor (writing x's type) or an error, the plain twins on a CPU
    tensor."""
    return _InstanceNormAct.apply(x, scale, bias, activation, negative_slope,
                                  eps, dtype)
