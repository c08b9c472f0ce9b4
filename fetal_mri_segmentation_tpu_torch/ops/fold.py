"""Space-to-depth ("channel folding") conv algebra, exact reformulations
(port of ``fetal_mri_segmentation_tpu/ops/fold.py``).

The full-resolution level of both model families runs its 3^3 convs on
1-64 channels. Folding 2x spatial blocks into the channel axis runs the
same multiply-accumulates, reassociated, with 2-8x the channels on a 2-8x
smaller grid:

- :func:`fold` / :func:`unfold`: layout transforms, per-axis factors in
  {1, 2};
- :func:`conv3_folded`: the SAME 3^3 stride-1 conv computed in folded
  space, in three formulations (below);
- :func:`conv3_folded_stride2`: the stride-2 entry conv (Isensee's
  down-sampling context path), which folds with no parity split;
- :func:`pool_folded`: max pooling 2 along folded axes is a per-cell
  reduction (the pool windows are the fold cells);
- :func:`up_conv3_folded`, :func:`upsample_nearest_folded`,
  :func:`concat_folded`: the decoder ops emitted directly in folded layout
  (the parity sub-grids are the channel blocks, so no interleave);
- :func:`conv1_folded`: the 1^3 conv, a matmul per sub-voxel.

Formulations of the stride-1 folded conv (all exact; FLOPs against the
unfolded conv for n_folded axes of factor 2):

- ``parity``: one small conv per output sub-voxel parity (a window of 2
  cells per folded axis), outputs concatenated as folded channels:
  (4/3)^n_folded;
- ``parity_batched``: the same parity convs as ONE grouped conv, the
  shifted windows stacked on the channel axis, one group per parity:
  identical FLOPs, one op;
- ``dense``: one conv over 3^3 folded cells with the parity kernels
  embedded at their cell offsets (zeros elsewhere): 2^n_folded.

Conventions: NDHWC activations; kernels in the JAX package's DHWIO layout
``(k, k, k, C_in, C_out)`` (the port's ``ConvBlock._kernel_dhwio``), the
unfolded parameter, so checkpoints are unchanged; the fold order is
sub-voxel-major (folded channel = ((b1*f2 + b2)*f3 + b3)*C + c), and the
parity outputs are concatenated in the same order, so
``unfold(conv3_folded(fold(x), W)) == conv3_same(x, W)`` up to
reassociation. Every conv is ``F.conv3d`` (the JAX package's XLA
``conv_general_dilated``, outside any Pallas kernel). A derived weight is
made in fp32 from the kernel, cast to the activations' dtype, and kept on
the kernel tensor once per version of it (``cuda_lib.cached``) unless
autograd records through it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import conv3d_ndhwc
from fetal_mri_segmentation_tpu_torch.ops.cuda_lib import cached
from fetal_mri_segmentation_tpu_torch.ops.dec0 import parity_up_weights
from fetal_mri_segmentation_tpu_torch.utils.device import device_table

Factors = Tuple[int, int, int]


def _check_factors(factors: Sequence[int]) -> Factors:
    f = tuple(int(v) for v in factors)
    if len(f) != 3 or any(v not in (1, 2) for v in f):
        raise ValueError(
            f"fold factors must be three values in {{1,2}}, got {f}")
    return f  # type: ignore[return-value]


def fold(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/f1, H/f2, W/f3, f1*f2*f3*C), sub-voxel-major,
    contiguous."""
    f1, f2, f3 = _check_factors(factors)
    b, d, h, w, c = x.shape
    if d % f1 or h % f2 or w % f3:
        raise ValueError(f"spatial {(d, h, w)} not divisible by factors "
                         f"{(f1, f2, f3)}")
    x = x.reshape(b, d // f1, f1, h // f2, f2, w // f3, f3, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // f1, h // f2, w // f3, f1 * f2 * f3 * c)


def unfold(y: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`fold`."""
    f1, f2, f3 = _check_factors(factors)
    b, d, h, w, fc = y.shape
    c = fc // (f1 * f2 * f3)
    y = y.reshape(b, d, h, w, f1, f2, f3, c)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(b, d * f1, h * f2, w * f3, c)


# Per-axis tap-routing tensors for a FOLDED axis (factor 2), kernel 3:
# output voxel p = 2i+s reads taps k in {0,1,2} at input voxel 2i+s-1+k,
# which lands in window-cell a (window = cells {i-1, i} for s=0, {i, i+1}
# for s=1) at sub-voxel b. T[s][a, b, k] = 1 iff tap k routes to (a, b).
_T_FOLDED = np.zeros((2, 2, 2, 3), np.float32)
_T_FOLDED[0, 0, 1, 0] = 1  # s=0: k=0 -> cell i-1 (a=0), sub 1
_T_FOLDED[0, 1, 0, 1] = 1  # s=0: k=1 -> cell i   (a=1), sub 0
_T_FOLDED[0, 1, 1, 2] = 1  # s=0: k=2 -> cell i   (a=1), sub 1
_T_FOLDED[1, 0, 0, 0] = 1  # s=1: k=0 -> cell i   (a=0), sub 0
_T_FOLDED[1, 0, 1, 1] = 1  # s=1: k=1 -> cell i   (a=0), sub 1
_T_FOLDED[1, 1, 0, 2] = 1  # s=1: k=2 -> cell i+1 (a=1), sub 0

# An UNFOLDED axis keeps its 3 taps: window 3 cells, one sub-voxel.
_T_UNFOLDED = np.eye(3, dtype=np.float32).reshape(3, 1, 3)

# Stride-2 SAME conv, folded axis: SAME stride 2 on an even axis pads (0
# left, 1 right), so output q reads taps at voxels 2q, 2q+1, 2q+2 = cells
# {q, q+1}: exactly the s=1 routing, no parity split.
_T_STRIDE2 = _T_FOLDED[1]


@device_table
def _routing(device: torch.device, factor: int, s: int) -> torch.Tensor:
    """One axis's routing tensor on ``device``: factor 1 -> the identity,
    factor 2 -> parity ``s``'s (s = 2: the stride-2 routing). Made outside
    inference mode, so autograd may save it."""
    table = (_T_UNFOLDED if factor == 1
             else _T_STRIDE2 if s == 2 else _T_FOLDED[s])
    with torch.inference_mode(False):
        return torch.tensor(table, device=device)


@functools.lru_cache(maxsize=None)
def _parities(factors: Factors) -> Tuple[Tuple[int, int, int], ...]:
    f1, f2, f3 = factors
    return tuple((s1, s2, s3)
                 for s1 in range(f1) for s2 in range(f2) for s3 in range(f3))


def _oidhw(w_dhwio: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A DHWIO kernel as the channels-last OIDHW weight ``conv3d_ndhwc``
    takes without a copy."""
    return w_dhwio.to(dtype).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)


def _parity_kernel(kernel: torch.Tensor, factors: Factors,
                   parity) -> torch.Tensor:
    """(3,3,3,Cin,Cout) -> (w1,w2,w3, F*Cin, Cout) in fp32 for one output
    parity (entries 0 / 1; 2 on every axis: the stride-2 routing).

    wj = 2 on folded axes (2-cell window), 3 on unfolded. Routing is an
    outer product of the per-axis T tensors: every original tap appears
    exactly once, so the conv is the same sum, reassociated."""
    t1, t2, t3 = (_routing(kernel.device, f, s)
                  for f, s in zip(factors, parity))
    wf = torch.einsum("auk,bvl,cwm,klmio->abcuvwio", t1, t2, t3,
                      kernel.float())
    w1, w2, w3 = wf.shape[:3]
    n = factors[0] * factors[1] * factors[2]
    return wf.reshape(w1, w2, w3, n * kernel.shape[3], kernel.shape[4])


def _dense_kernel(kernel: torch.Tensor, factors: Factors) -> torch.Tensor:
    """Every parity kernel embedded at its cell offset in one 3^3-cell
    kernel, fp32: (3, 3, 3, F*Cin, P*Cout).

    Folded axis: parity s=0's 2-window covers dense cells {0,1}, s=1's
    covers {1,2}. Unfolded axis: the 3-window is the dense window."""
    cin, cout = kernel.shape[3], kernel.shape[4]
    n = factors[0] * factors[1] * factors[2]
    pars = _parities(factors)
    out = kernel.new_zeros((3, 3, 3, n * cin, len(pars) * cout),
                           dtype=torch.float32)
    for pi, p in enumerate(pars):
        kp = _parity_kernel(kernel, factors, p)
        w1, w2, w3 = kp.shape[:3]
        o1, o2, o3 = (s if f == 2 else 0 for f, s in zip(factors, p))
        out[o1:o1 + w1, o2:o2 + w2, o3:o3 + w3, :,
            pi * cout:(pi + 1) * cout] = kp
    return out


def _parity_window(xpad: torch.Tensor, factors: Factors,
                   parity: Tuple[int, int, int]) -> torch.Tensor:
    """Slice of the cell-padded input covering this parity's taps.

    Folded axis: offset s, length d+1 (VALID 2-window -> d outputs).
    Unfolded axis: offset 0, length d+2 (VALID 3-window -> d outputs)."""
    out = xpad
    for axis, (f, s, n) in enumerate(zip(factors, parity, xpad.shape[1:4])):
        start = s if f == 2 else 0
        out = out.narrow(axis + 1, start, n - 2 + (1 if f == 2 else 2))
    return out


def _pad_cells(xf: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return F.pad(xf, (0, 0, lo, hi, lo, hi, lo, hi))


def conv3_folded(xf: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor], factors: Sequence[int],
                 formulation: str = "parity") -> torch.Tensor:
    """SAME 3^3 stride-1 conv, computed in folded space. Exact.

    xf: folded input (B, d, h, w, F*Cin); kernel: the UNFOLDED (3,3,3,
    Cin, Cout) parameter (checkpoint layout unchanged); returns the folded
    output (B, d, h, w, F*Cout) in xf's dtype."""
    factors = _check_factors(factors)
    pars = _parities(factors)
    dt = xf.dtype
    if len(pars) == 1:  # no folded axis: plain SAME conv
        y = conv3d_ndhwc(xf, _oidhw(kernel, dt), padding=1)
        return y if bias is None else y + bias.to(y.dtype)

    xpad = _pad_cells(xf, 1, 1)
    if formulation == "parity":
        weights = cached(kernel, ("fold parity", factors, dt), lambda k: [
            _oidhw(_parity_kernel(k, factors, p), dt) for p in pars])
        y = torch.cat([conv3d_ndhwc(_parity_window(xpad, factors, p), w)
                       for p, w in zip(pars, weights)], dim=-1)
    elif formulation == "parity_batched":
        # Every parity window has the same SHAPE (2-window on folded axes,
        # 3-window on unfolded) at a different offset, and each parity has
        # its own kernel: the windows stacked on the channel axis and one
        # grouped conv, a group per parity, whose output channels are the
        # parity-major order of the concatenation above.
        weight = cached(kernel, ("fold parity_batched", factors, dt),
                        lambda k: torch.cat([
                            _oidhw(_parity_kernel(k, factors, p), dt)
                            for p in pars]).contiguous(
                                memory_format=torch.channels_last_3d))
        stack = torch.cat([_parity_window(xpad, factors, p) for p in pars],
                          dim=-1)
        y = F.conv3d(stack.permute(0, 4, 1, 2, 3), weight,
                     groups=len(pars)).permute(0, 2, 3, 4, 1)
    elif formulation == "dense":
        weight = cached(kernel, ("fold dense", factors, dt),
                        lambda k: _oidhw(_dense_kernel(k, factors), dt))
        y = conv3d_ndhwc(xpad, weight)
    else:
        raise ValueError(f"unknown formulation {formulation!r}")
    if bias is not None:
        n = factors[0] * factors[1] * factors[2]
        y = y + bias.repeat(n).to(y.dtype)
    return y


def conv3_folded_stride2(xf: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         factors: Sequence[int]) -> torch.Tensor:
    """Stride-2 SAME 3^3 conv with the stride absorbed into the fold.

    On a folded axis the stride-2 outputs ARE the cell grid (one parity,
    the s=1 routing, since SAME stride 2 over an even axis pads (0, 1) so
    output q reads voxels 2q..2q+2), so there is no parity split and no
    output folding: returns (B, D/2, H/2, W/2, Cout), the natural
    resolution of the next level. Unfolded axes run a normal stride-2 SAME
    conv. Equals ``conv(x, k, strides=2, SAME)`` for even input sizes
    (Keras SAME semantics); an odd unfolded axis is refused, since SAME
    stride 2 pads it (1, 1)."""
    factors = _check_factors(factors)
    for ax, (f, d) in enumerate(zip(factors, xf.shape[1:4])):
        if f == 1 and d % 2:
            raise ValueError(
                f"conv3_folded_stride2 requires even spatial dims (SAME "
                f"stride-2 pads odd axes differently); axis {ax} has {d}")
    dt = xf.dtype
    weight = cached(kernel, ("fold stride2", factors, dt),
                    lambda k: _oidhw(
                        _parity_kernel(k, factors, (2, 2, 2)), dt))
    # folded axes: pad 1 cell right, a VALID 2-window at stride 1 on the
    # cell grid; unfolded axes: the explicit (0, 1) pad, stride 2
    strides = tuple(1 if f == 2 else 2 for f in factors)
    y = conv3d_ndhwc(_pad_cells(xf, 0, 1), weight, stride=strides)
    return y if bias is None else y + bias.to(y.dtype)


def pool_folded(xf: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """MaxPool(2, stride 2) with folded axes reduced per cell.

    The per-cell max over the present sub-voxels, then a 2-window pool on
    the axes that are not folded. The output is UNFOLDED (the next level's
    natural resolution), channels back to C. The gradient follows the JAX
    package's: the per-cell max (``jnp.max``) splits it evenly among a
    cell's tied sub-voxels, the window pool (``reduce_window``) sends it
    to the first maximal cell of its window."""
    factors = _check_factors(factors)
    b, d, h, w, fc = xf.shape
    f1, f2, f3 = factors
    x = xf.reshape(b, d, h, w, f1, f2, f3, fc // (f1 * f2 * f3))
    x = x.amax(dim=(4, 5, 6))
    # the axes not folded still need their 2-window pool (VALID); layers
    # imports this module, so its pool is imported here
    from fetal_mri_segmentation_tpu_torch.models.layers import max_pool_3d
    window = tuple(3 - f for f in factors)
    return max_pool_3d(x, window) if window != (1, 1, 1) else x


def up_conv3_folded(x_deep: torch.Tensor, kernel_up: torch.Tensor,
                    factors: Sequence[int]) -> torch.Tensor:
    """conv3^3(upsample_nearest2(x_deep)) emitted directly in folded space.

    The parity decomposition of ``ops/dec0.py::up_concat_conv3x3`` (output
    parity r reads 2 source voxels per axis, 8 effective 2^3 kernels)
    computes one output sub-grid per parity; in folded space those
    sub-grids ARE the channel blocks. Folded axes keep parity as channels;
    unfolded axes still interleave spatially. x_deep is at cell resolution
    (B, d, h, w, Cin); returns (B, d*, h*, w*, F*Cout) with dj* = dj on
    folded axes, 2*dj on unfolded ones. No bias (the caller adds it once
    after the skip half)."""
    factors = _check_factors(factors)
    b, d, h, w, cin = x_deep.shape
    co = kernel_up.shape[-1]
    dt = x_deep.dtype
    # the eight parities' 2^3 kernels, (r1, r2, r3) row-major
    weights = cached(kernel_up, ("fold up", dt), lambda k: [
        _oidhw(w, dt) for w in parity_up_weights(k).flatten(0, 2)])
    xpad = _pad_cells(x_deep, 1, 1)
    outs = [conv3d_ndhwc(xpad[:, r1:r1 + d + 1, r2:r2 + h + 1,
                              r3:r3 + w + 1], weights[(r1 * 2 + r2) * 2 + r3])
            for r1 in range(2) for r2 in range(2) for r3 in range(2)]
    # outs by (r1, r2, r3); each axis's parity goes to the channels
    # (folded) or interleaves spatially (unfolded)
    y = torch.stack(outs, 1).reshape(b, 2, 2, 2, d, h, w, co)
    perm, shape = [0], [b]
    for ax, (f, n) in enumerate(zip(factors, (d, h, w))):
        perm.append(4 + ax)
        if f == 1:
            perm.append(1 + ax)
        shape.append(n * (1 if f == 2 else 2))
    perm += [1 + ax for ax, f in enumerate(factors) if f == 2] + [7]
    shape.append(factors[0] * factors[1] * factors[2] * co)
    return y.permute(perm).reshape(shape)


def concat_folded(a: torch.Tensor, b: torch.Tensor,
                  factors: Sequence[int]) -> torch.Tensor:
    """Channel-concat of two folded tensors, preserving the folded layout:
    the sub-voxel axis split out, concat on c, re-merged (a plain
    concatenation would put whole tensors side by side, not each cell's
    channels)."""
    factors = _check_factors(factors)
    n = factors[0] * factors[1] * factors[2]
    sa, sb = a.shape, b.shape
    out = torch.cat([a.reshape(*sa[:4], n, sa[4] // n),
                     b.reshape(*sb[:4], n, sb[4] // n)], dim=-1)
    return out.reshape(*sa[:4], n * (sa[4] // n + sb[4] // n))


def upsample_nearest_folded(src: torch.Tensor,
                            factors: Sequence[int]) -> torch.Tensor:
    """UpSampling3D(2) emitted directly in folded layout.

    src is at cell resolution, unfolded channels (B, d, h, w, C). On a
    folded axis both sub-voxels copy the SAME source, so the sub-voxel axis
    is a channel tile; unfolded axes repeat as usual. Output: folded (B,
    d1*, d2*, d3*, F*C), dj* = dj on folded axes, 2*dj on unfolded ones;
    ``unfold(result) == upsample_nearest(src)``."""
    factors = _check_factors(factors)
    x = src
    for ax, f in zip((1, 2, 3), factors):
        if f == 1:
            x = x.repeat_interleave(2, dim=ax)
    n = factors[0] * factors[1] * factors[2]
    if n > 1:
        x = x.unsqueeze(4).expand(*x.shape[:4], n, x.shape[4]).reshape(
            *x.shape[:4], n * x.shape[4])
    return x


def conv1_folded(xf: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor],
                 factors: Sequence[int]) -> torch.Tensor:
    """1^3 conv in folded space: a matmul per sub-voxel. Exact.

    kernel: the UNFOLDED (1,1,1,Cin,Cout) parameter in DHWIO. Computes in
    xf's dtype; returns the folded (B, d, h, w, F*Cout) output. The folded
    model heads (the U-Net head, Isensee's localization tails and
    segmentation heads) share it."""
    factors = _check_factors(factors)
    n = factors[0] * factors[1] * factors[2]
    b, d, h, w, fc = xf.shape
    xs = xf.reshape(b, d, h, w, n, fc // n)
    y = torch.matmul(xs, kernel[0, 0, 0].to(xf.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(b, d, h, w, n * kernel.shape[-1])
