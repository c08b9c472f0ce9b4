"""Fused decoder level (upsample + concat + conv): Hopper kernel, plain twin.

Port of ``fetal_mri_segmentation_tpu/ops/pallas_dec0.py`` (K3)::

    y = act(conv3^3(concat([up_nearest2(x_deep), skip])) + bias)

x_deep (B, dc, hc, wc, C_up) and skip (B, 2dc, 2hc, 2wc, C_skip) in NDHWC,
the kernel in DHWIO over the concat channel order ``[upsampled, skip]`` (the
same parameter as an unfused conv block), fp32 bias.

The plain version is the parity form :func:`up_concat_conv3x3` (the torch
twin of ``models/layers.py::up_concat_conv3x3``): eight 2x2x2 convs of
x_deep with pre-summed weights, interleaved, plus a SAME conv of the skip.
:func:`up_concat_conv3x3_dilated` is the JAX package's second plain
formulation of the same op, one input-dilated conv (a transposed conv
here), which ``models/layers.py::ConvBlock`` takes under
``decoder_form_override("dilated")``.
The CUDA kernel (``csrc/dec0.cu``) computes the same sums as eight parity
GEMMs with K = 8*C_up + 27*C_skip, reading x_deep and skip in place and
writing the fine NDHWC output; :func:`build_dec0_weights` is the twin of
``pallas_dec0.py::_build_weights`` in row-major GEMM layout, and
:func:`kernel_weights` turns it into the kernel's K-major B operands, once
per version of the ``kernel`` tensor (``cuda_lib.cached``). :func:`tile_plan`
gives the tile box, N tile, tile counts and the 11 TMA maps (x_deep, the
two weights and the skip's 8 sub-parity views).

:func:`up_concat_conv3x3_kernel` is differentiable on either device: its
backward (:func:`up_concat_conv3x3_vjp`) is the port of the JAX custom VJP
``pallas_dec0.py::_vjp_bwd``, autograd through the parity form plus the
activation in the inputs' dtype; it never launches the kernel. On a CUDA
tensor the forward reaches the kernel through the CUDA-only custom op
``torch.ops.fetal.up_concat_conv3x3`` (:func:`up_concat_conv3x3_op`: the
ctypes launch with its host planning, and a fake implementation for
``torch.export``), as ``ops/conv3x3.py`` does for the conv.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from fetal_mri_segmentation_tpu_torch.ops import cuda_lib, tiling
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import (
    apply_activation, conv3d_ndhwc)
from fetal_mri_segmentation_tpu_torch.utils.device import device_table


# S[r][j, k] = 1 iff kernel tap k lands on coarse source offset j for output
# parity r, per axis: nearest x2 upsampling leaves taps {0},{1,2} for parity 0
# and {0,1},{2} for parity 1 (the S matrices of the JAX parity form).
_S = (((1, 0, 0), (0, 1, 1)), ((1, 1, 0), (0, 0, 1)))


@device_table
def _tap_merge(device: torch.device) -> torch.Tensor:
    # one copy per device: a fresh host-to-device copy on every call would
    # stall the host until the stream drains. Made outside inference mode,
    # so autograd may save it when training follows serving.
    with torch.inference_mode(False):
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


# Per-axis tap-spread matrix of the input-dilated form: M[a, j] = 1 iff
# 3^3-kernel tap j contributes to 4^3-kernel tap a when the nearest x2
# upsample is absorbed into the kernel. Row a covers output offset a - 1
# relative to 2 * (source index); taps {0}, {0,1}, {1,2}, {2}: the
# transposed expansion of the parity form's S matrices (S[0] = rows {0, 2}
# of M, S[1] = rows {1, 3}).
_DILATE_M = ((1, 0, 0), (1, 1, 0), (0, 1, 1), (0, 0, 1))


@device_table
def _dilate_spread(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(_DILATE_M, dtype=torch.float32, device=device)


def _dilated_up_weight(w_up: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, 3, C_up, C_out) -> the ``F.conv_transpose3d`` weight (C_up,
    C_out, 4, 4, 4) in ``dtype``: the 4^3 kernel M (x) M (x) M . W of the
    input-dilated conv (summed in fp32), flipped in space, since a
    transposed conv correlates the dilated input with the flipped kernel."""
    M = _dilate_spread(w_up.device)
    k4 = torch.einsum("aj,bk,cl,jklio->abcio", M, M, M, w_up.float())
    return k4.flip(0, 1, 2).permute(3, 4, 0, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)


def up_concat_conv3x3_dilated(x_deep: torch.Tensor,
                              skip: torch.Tensor | None,
                              kernel: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Same op as :func:`up_concat_conv3x3`, as ONE input-dilated conv
    (the twin of ``models/layers.py::up_concat_conv3x3_dilated``).

    conv3^3(up_nearest2(x)) == conv4^3(x, M(x)M(x)M . W, lhs_dilation 2, pad
    2): the upsample is absorbed into a 4^3 kernel over the x2-dilated
    input. In PyTorch that conv is ``F.conv_transpose3d`` with stride 2,
    the flipped and transposed 4^3 kernel and padding 4 - 1 - 2 = 1, which
    skips the dilation's zeros. Same parameter (concat order ``[upsampled,
    skip]``) and same math, up to reassociation. Computes in x_deep's
    dtype."""
    up_ch = x_deep.shape[-1]
    w = _dilated_up_weight(kernel[:, :, :, :up_ch, :], x_deep.dtype)
    y = torch.nn.functional.conv_transpose3d(
        x_deep.permute(0, 4, 1, 2, 3), w, stride=2, padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if skip is not None:  # Isensee's up-sampling module has no concat
        w_skip = kernel[:, :, :, up_ch:, :].to(skip.dtype)
        y = y + conv3d_ndhwc(skip, w_skip.permute(4, 3, 0, 1, 2), padding=1)
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


def kernel_weights(kernel: torch.Tensor, up_ch: int):
    """The kernel's B operands, K-major bf16: ``w_up`` (8 parities, C_out,
    8 taps, C_up) and ``w_skip`` (C_out, 27 taps, C_skip), from
    :func:`build_dec0_weights`."""
    w_up, w_skip = build_dec0_weights(kernel, up_ch, torch.bfloat16)
    co = w_up.shape[-1]
    return (w_up.reshape(8, 8, up_ch, co).permute(0, 3, 1, 2).contiguous(),
            w_skip.reshape(27, -1, co).permute(2, 0, 1).contiguous())


@dataclasses.dataclass(frozen=True)
class Dec0Plan:
    """How ``dec0_kernel`` covers one call (``csrc/dec0.cu``): every
    (M tile, N tile) once per output parity."""

    shape: tuple[int, int, int, int]      # B, dc, hc, wc (coarse)
    co: int
    cu_chunks: int
    cs_chunks: int
    box: tuple[int, int, int]             # TD, TH, TW over the coarse grid
    tiles: tuple[int, int, int]
    m_tiles: int
    n_tiles: int
    bn: int
    maps: tuple[tiling.TensorMap, ...]    # xd, w_up, w_skip, skip p=0..7

    @property
    def geom(self) -> tuple[int, ...]:
        """The kernel's Dec0Geom, field for field."""
        return (*self.shape, self.co, self.cu_chunks, self.cs_chunks,
                *self.box, *self.tiles, self.m_tiles, self.n_tiles)

    @property
    def bm(self) -> int:
        return self.box[0] * self.box[1] * self.box[2]

    @property
    def total_tiles(self) -> int:
        return 8 * self.m_tiles * self.n_tiles

    @property
    def n_iters(self) -> int:
        return 8 * self.cu_chunks + 27 * self.cs_chunks


@functools.cache
def tile_plan(B: int, dc: int, hc: int, wc: int, cu: int, cs: int,
              co: int) -> Dec0Plan:
    bn = tiling.choose_bn(co)
    box = tiling.tile_box(dc, hc, wc, tiling.tile_voxels(bn))
    tiles = tiling.tile_counts((dc, hc, wc), box)
    fine = (B, 2 * dc, 2 * hc, 2 * wc, cs)
    skip_maps = tuple(
        tiling.ndhwc_map("skip", fine, box, step=2, origin=(p1, p2, p3),
                         extent=(dc, hc, wc))
        for p1 in (0, 1) for p2 in (0, 1) for p3 in (0, 1))
    maps = (tiling.ndhwc_map("xd", (B, dc, hc, wc, cu), box),
            tiling.weight_map("w_up", (8, co, 8, cu), bn),
            tiling.weight_map("w_skip", (co, 27, cs), bn)) + skip_maps
    return Dec0Plan((B, dc, hc, wc), co, tiling.ceil_div(cu, tiling.BK),
                    tiling.ceil_div(cs, tiling.BK), box, tiles,
                    B * tiles[0] * tiles[1] * tiles[2],
                    tiling.ceil_div(co, bn), bn, maps)


def load_coords(plan: Dec0Plan, it: int, parity: int, b: int, d0: int,
                h0: int, w0: int, n0: int):
    """K step ``it`` of the block at coarse (b, d0, h0, w0), output parity
    ``parity`` (r1*4 + r2*2 + r3), N offset n0: ((A map index, coords),
    (B map index, coords)), indices into ``plan.maps``, coordinates
    innermost first. Mirror of ``dec0_kernel``'s ``issue``."""
    r1, r2, r3 = parity >> 2 & 1, parity >> 1 & 1, parity & 1
    n_up = 8 * plan.cu_chunks
    if it < n_up:
        j, chunk = divmod(it, plan.cu_chunks)
        j1, j2, j3 = j >> 2 & 1, j >> 1 & 1, j & 1
        c0 = chunk * tiling.BK
        return ((0, (c0, w0 + r3 + j3 - 1, h0 + r2 + j2 - 1,
                     d0 + r1 + j1 - 1, b)),
                (1, (c0, j, n0, parity)))
    k, chunk = divmod(it - n_up, plan.cs_chunks)
    c0 = chunk * tiling.BK
    t = (r1 + k // 9 - 1, r2 + k // 3 % 3 - 1, r3 + k % 3 - 1)
    s = tuple((ti + 2) // 2 - 1 for ti in t)
    p = [ti - 2 * si for ti, si in zip(t, s)]
    return ((3 + p[0] * 4 + p[1] * 2 + p[2],
             (c0, w0 + s[2], h0 + s[1], d0 + s[0], b)),
            (2, (c0, k, n0)))


def up_concat_conv3x3_vjp(x_deep, skip, kernel, bias, g,
                          activation: str, negative_slope: float,
                          needs=(True, True, True, True)):
    """(d x_deep, d skip, d kernel, d bias) of the fused decoder level for
    the output cotangent ``g``: the VJP of :func:`up_concat_conv3x3` plus
    the activation, recomputed in the inputs' dtypes (the JAX package's
    ``_ref_fwd``). ``needs`` skips the gradients nobody asked for."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in
                  zip((x_deep, skip, kernel, bias), needs)]
        y = apply_activation(up_concat_conv3x3(*leaves), activation,
                             negative_slope)
    wanted = [t for t in leaves if t.requires_grad]
    grads = list(torch.autograd.grad(y, wanted, g.to(y.dtype))
                 if wanted else [])
    return tuple(grads.pop(0) if t.requires_grad else None for t in leaves)


@torch.library.custom_op("fetal::up_concat_conv3x3", mutates_args=(),
                         device_types="cuda")
def up_concat_conv3x3_op(x_deep: torch.Tensor, skip: torch.Tensor,
                         kernel: torch.Tensor, bias: torch.Tensor,
                         activation: str,
                         negative_slope: float) -> torch.Tensor:
    """One launch of ``dec0_kernel`` on CUDA tensors: x_deep (B, dc, hc,
    wc, C_up) and skip (B, 2dc, 2hc, 2wc, C_skip) bf16, kernel (3, 3, 3,
    C_up + C_skip, C_out) bf16, bias fp32 -> y (B, 2dc, 2hc, 2wc, C_out)
    bf16, contiguous; counted in ``up_concat_conv3x3_kernel.launches``."""
    y = _launch(x_deep, skip, kernel, bias, activation, negative_slope)
    up_concat_conv3x3_kernel.launches += 1
    return y


@up_concat_conv3x3_op.register_fake
def _up_concat_conv3x3_fake(x_deep, skip, kernel, bias, activation,
                            negative_slope):
    B, dc, hc, wc = x_deep.shape[:4]
    return x_deep.new_empty((B, 2 * dc, 2 * hc, 2 * wc, kernel.shape[-1]),
                            dtype=torch.bfloat16)


class _FusedDecoder(torch.autograd.Function):
    """The fused decoder level with its gradient: the kernel (or, on a CPU
    tensor, its plain version) forward, :func:`up_concat_conv3x3_vjp`
    backward."""

    @staticmethod
    def forward(ctx, x_deep, skip, kernel, bias, activation, negative_slope):
        ctx.save_for_backward(x_deep, skip, kernel, bias)
        ctx.act = (activation, negative_slope)
        if x_deep.device.type == "cpu":
            return up_concat_conv3x3_reference(x_deep, skip, kernel, bias,
                                               activation, negative_slope)
        if (x_deep.device.type != "cuda"
                and not torch.compiler.is_compiling()):
            # the op's fake implementation answers only in a trace
            cuda_lib.require_cuda_bf16("up_concat_conv3x3_kernel",
                                       x_deep=x_deep)
        return up_concat_conv3x3_op(x_deep, skip, kernel, bias, activation,
                                    float(negative_slope))

    @staticmethod
    def backward(ctx, g):
        grads = up_concat_conv3x3_vjp(*ctx.saved_tensors, g, *ctx.act,
                                      needs=ctx.needs_input_grad[:4])
        return (*grads, None, None)


def _launch(x_deep, skip, kernel, bias, activation, negative_slope):
    name = "up_concat_conv3x3_kernel"
    up_ch, skip_ch, co = x_deep.shape[-1], skip.shape[-1], kernel.shape[-1]
    cuda_lib.require_cuda_bf16(name, x_deep=x_deep, skip=skip, bias=bias)
    w_up, w_skip = cuda_lib.cached(
        kernel, ("dec0", up_ch), lambda k: kernel_weights(k, up_ch))
    cuda_lib.require_cuda_bf16(name, x_deep=x_deep, skip=skip, w_up=w_up,
                               w_skip=w_skip, bias=bias)
    B, dc, hc, wc = x_deep.shape[:4]
    plan = tile_plan(B, dc, hc, wc, up_ch, skip_ch, co)
    y = torch.empty((B, 2 * dc, 2 * hc, 2 * wc, co), dtype=torch.bfloat16,
                    device=x_deep.device)
    operands = {"xd": x_deep, "skip": skip, "w_up": w_up, "w_skip": w_skip}
    lib = cuda_lib.library()
    with torch.cuda.device(x_deep.device):
        err = lib.fetal_dec0_bf16(
            tiling.pack_specs(plan.maps, operands),
            tiling.pack_ints(plan.geom), bias.data_ptr(), y.data_ptr(),
            plan.bn, tiling.grid_blocks(plan.total_tiles, x_deep.device),
            cuda_lib.ACTIVATIONS[activation],
            float(negative_slope), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check_launch(name, err)
    return y


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
    return _FusedDecoder.apply(x_deep, skip, kernel, bias, activation,
                               negative_slope)


up_concat_conv3x3_kernel.launches = 0
