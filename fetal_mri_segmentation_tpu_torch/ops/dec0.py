"""Fused decoder level (upsample + concat + conv): Hopper kernel, plain twin.

Port of ``fetal_mri_segmentation_tpu/ops/pallas_dec0.py`` (K3)::

    y = act(conv3^3(concat([up_nearest2(x_deep), skip])) + bias)

x_deep (B, dc, hc, wc, C_up) and skip (B, 2dc, 2hc, 2wc, C_skip) in NDHWC,
the kernel in DHWIO over the concat channel order ``[upsampled, skip]`` (the
same parameter as an unfused conv block), fp32 bias.

The plain version is the parity form :func:`up_concat_conv3x3` (the torch
twin of ``models/layers.py::up_concat_conv3x3``): eight 2x2x2 convs of
x_deep with pre-summed weights, interleaved, plus a SAME conv of the skip.
The CUDA kernel (``csrc/dec0.cu``) computes the same sums as eight parity
GEMMs with K = 8*C_up + 27*C_skip, reading x_deep and skip in place and
writing the fine NDHWC output; :func:`build_dec0_weights` is the twin of
``pallas_dec0.py::_build_weights`` in the kernel's row-major layout.
"""

from __future__ import annotations

import functools

import torch

from fetal_mri_segmentation_tpu_torch.ops import cuda_lib
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import (
    apply_activation, conv3d_ndhwc)


# S[r][j, k] = 1 iff kernel tap k lands on coarse source offset j for output
# parity r, per axis: nearest x2 upsampling leaves taps {0},{1,2} for parity 0
# and {0,1},{2} for parity 1 (the S matrices of the JAX parity form).
_S = (((1, 0, 0), (0, 1, 1)), ((1, 1, 0), (0, 0, 1)))


@functools.cache
def _tap_merge(device: torch.device) -> torch.Tensor:
    # one copy per device: a fresh host-to-device copy on every call would
    # stall the host until the stream drains
    return torch.tensor(_S, dtype=torch.float32, device=device)


def parity_up_weights(w_up: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C_up, C_out) -> Weff (r1, r2, r3, j1, j2, j3, C_up, C_out):
    the up-half kernel summed (in fp32) over the taps that land on each
    coarse offset j for output parity r."""
    S = _tap_merge(w_up.device)
    return torch.einsum("pak,qbl,rcm,klmio->pqrabcio", S, S, S, w_up.float())


def _up_concat_conv(x_deep, skip, kernel) -> torch.Tensor:
    up_ch = x_deep.shape[-1]
    B, d, h, w = x_deep.shape[:4]
    co = kernel.shape[-1]
    xpad = torch.nn.functional.pad(x_deep, (0, 0, 1, 1, 1, 1, 1, 1))
    weff_all = parity_up_weights(kernel[:, :, :, :up_ch, :])
    outs = []
    for r1 in range(2):
        for r2 in range(2):
            for r3 in range(2):
                weff = weff_all[r1, r2, r3]
                xs = xpad[:, r1:r1 + d + 1, r2:r2 + h + 1, r3:r3 + w + 1]
                outs.append(conv3d_ndhwc(
                    xs, weff.to(x_deep.dtype).permute(4, 3, 0, 1, 2)))
    y = torch.stack(outs, 1).reshape(B, 2, 2, 2, d, h, w, co)
    y = y.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(B, 2 * d, 2 * h, 2 * w, co)
    if skip is not None:
        w_skip = kernel[:, :, :, up_ch:, :].to(skip.dtype)
        y = y + conv3d_ndhwc(skip, w_skip.permute(4, 3, 0, 1, 2), padding=1)
    return y


def up_concat_conv3x3(x_deep: torch.Tensor, skip: torch.Tensor | None,
                      kernel: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """conv3^3(concat([up_nearest2(x_deep), skip])) + bias, parity form.

    Same math and parameter as the unfused upsample + concat + conv; the
    up half costs 8 taps instead of 27. ``skip=None`` is the no-concat
    form. Computes in x_deep's dtype."""
    y = _up_concat_conv(x_deep, skip, kernel)
    return y + bias.to(y.dtype)


def up_concat_conv3x3_reference(x_deep, skip, kernel, bias,
                                activation: str = "none",
                                negative_slope: float = 0.3) -> torch.Tensor:
    """Plain version of the kernel: the parity form, bias and activation in
    fp32, result in x_deep's dtype."""
    y = _up_concat_conv(x_deep, skip, kernel)
    y = apply_activation(y.float() + bias.float(), activation, negative_slope)
    return y.to(x_deep.dtype)


def build_dec0_weights(kernel: torch.Tensor, up_ch: int, dtype: torch.dtype):
    """(3, 3, 3, C_up + C_skip, C_out) -> the kernel's B matrices.

    ``w_up`` (8, 8*C_up, C_out): per output parity r (index r1*4 + r2*2 +
    r3), rows (j1, j2, j3, ci) of Weff_r. ``w_skip`` (27*C_skip, C_out):
    rows (k1, k2, k3, ci) of the skip half, shared by all parities. The
    same numbers as ``pallas_dec0.py::_build_weights``, laid out row-major
    for the GEMM's B operand instead of transposed."""
    co = kernel.shape[-1]
    skip_ch = kernel.shape[3] - up_ch
    w_up = parity_up_weights(kernel[:, :, :, :up_ch, :]).reshape(
        8, 8 * up_ch, co)
    w_skip = kernel[:, :, :, up_ch:, :].reshape(27 * skip_ch, co)
    return w_up.to(dtype).contiguous(), w_skip.to(dtype).contiguous()


def dec0_available(x_shape, skip_shape, up_ch: int, skip_ch: int,
                   co: int) -> bool:
    """The eligibility gate, decided before any launch: a skip exactly twice
    the coarse grid and channel counts that are multiples of 8. There is no
    VMEM-style size limit on the card (the TPU gate refused dec2)."""
    if up_ch % 8 or skip_ch % 8 or co % 8:
        return False
    return tuple(skip_shape[1:4]) == tuple(2 * int(s) for s in x_shape[1:4])


def up_concat_conv3x3_kernel(x_deep: torch.Tensor, skip: torch.Tensor,
                             kernel: torch.Tensor, bias: torch.Tensor,
                             activation: str = "none",
                             negative_slope: float = 0.3) -> torch.Tensor:
    """Port of ``up_concat_conv3x3_pallas``: one fused decoder level.

    CPU tensors take :func:`up_concat_conv3x3_reference`; CUDA tensors
    launch ``csrc/dec0.cu`` (bf16 operands, fp32 bias) or raise."""
    up_ch, skip_ch, co = x_deep.shape[-1], skip.shape[-1], kernel.shape[-1]
    if kernel.shape != (3, 3, 3, up_ch + skip_ch, co) or bias.shape != (co,):
        raise ValueError(f"up_concat_conv3x3_kernel: kernel "
                         f"{tuple(kernel.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit C_up={up_ch}, C_skip={skip_ch}")
    if not dec0_available(x_deep.shape, skip.shape, up_ch, skip_ch, co):
        raise ValueError(f"up_concat_conv3x3_kernel: x_deep "
                         f"{tuple(x_deep.shape)}, skip {tuple(skip.shape)} "
                         "fail dec0_available")
    if x_deep.device.type == "cpu":
        return up_concat_conv3x3_reference(x_deep, skip, kernel, bias,
                                           activation, negative_slope)
    w_up, w_skip = build_dec0_weights(kernel, up_ch, torch.bfloat16)
    cuda_lib.require_cuda_bf16("up_concat_conv3x3_kernel", x_deep=x_deep,
                               skip=skip, w_up=w_up, w_skip=w_skip, bias=bias)
    B, dc, hc, wc = x_deep.shape[:4]
    y = torch.empty((B, 2 * dc, 2 * hc, 2 * wc, co), dtype=torch.bfloat16,
                    device=x_deep.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x_deep.device):
        err = lib.fetal_dec0_bf16(
            x_deep.data_ptr(), skip.data_ptr(), w_up.data_ptr(),
            w_skip.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, dc, hc, wc, up_ch, skip_ch, co,
            cuda_lib.ACTIVATIONS[activation], float(negative_slope),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check_launch("up_concat_conv3x3_kernel", err)
    up_concat_conv3x3_kernel.launches += 1
    return y


up_concat_conv3x3_kernel.launches = 0
