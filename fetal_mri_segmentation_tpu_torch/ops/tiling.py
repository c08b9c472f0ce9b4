"""Tile plans of the Hopper conv kernels (``csrc/igemm.cuh``), as integers.

An output tile is ``bm`` output voxels x ``bn`` output channels (128 x 128,
or 256 x 64 where C_out <= 64: :func:`tile_voxels`), and a persistent
kernel block walks over many of them. The voxels are a spatial box
(TD, TH, TW) of the output grid, so that the activation tile of one
(tap, channel chunk) is a single TMA box of the NDHWC input. Every
operand reaches shared memory through a TMA tensor map: a bf16 tensor seen
as up to 5 dimensions (innermost first), byte strides, a box whose inner
extent is one K step of 64 channels (128 bytes, in the 128-byte swizzle) or
32 (64 bytes, 64-byte swizzle), zero fill out of bounds. This module computes those maps, the box
and the grid in Python, where the CPU tests reach them
(``tests/test_torch_tiling.py`` replays the kernels' loads from them); the
C entry points only encode and launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, Sequence

import torch

BM = 128        # output voxels per tile of a 128-wide N tile
BK = 64         # bf16 channels per K step: one 128-byte swizzle row
ELEM = 2        # bytes of a bf16
SPEC_LEN = 18   # integers per map spec (csrc/igemm.cuh::kMapSpecLen)


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """One TMA tiled map over the operand ``operand``: ``dims`` in
    elements and ``strides`` in bytes, innermost first (``strides[0]`` is
    the element size), the ``box`` loaded per request, and the byte
    ``offset`` of the map's origin from the operand's first element."""

    operand: str
    dims: tuple[int, ...]
    strides: tuple[int, ...]
    box: tuple[int, ...]
    offset: int = 0

    def __post_init__(self):
        rank = len(self.dims)
        if not 1 <= rank <= 5 or len(self.strides) != rank or len(
                self.box) != rank:
            raise ValueError(f"{self.operand}: a tensor map has 1 to 5 dims, "
                             f"got dims {self.dims}, strides {self.strides}, "
                             f"box {self.box}")
        if any(not 1 <= d < 2 ** 32 for d in self.dims):
            raise ValueError(f"{self.operand}: dims {self.dims} out of range")
        if any(s % 16 or not 0 < s < 2 ** 40 for s in self.strides[1:]):
            raise ValueError(f"{self.operand}: global strides {self.strides} "
                             "must be positive multiples of 16 bytes")
        if any(not 1 <= b <= 256 for b in self.box):
            raise ValueError(f"{self.operand}: box {self.box} must lie in "
                             "[1, 256] on every dim")
        if self.box[0] * ELEM not in (64, 128):
            raise ValueError(f"{self.operand}: the inner box must be 128 "
                             "or 64 bytes, one swizzle row")
        if self.offset % 16:
            raise ValueError(f"{self.operand}: offset {self.offset} is not "
                             "16-byte aligned")

    def spec(self, base: int) -> list[int]:
        """The C spec: address, rank, dims, strides, box (each padded to
        5), swizzle bytes."""
        address = base + self.offset
        if address % 16:
            raise ValueError(f"{self.operand}: base address is not 16-byte "
                             "aligned")
        pad = (0,) * (5 - len(self.dims))
        return [address, len(self.dims), *self.dims, *pad, *self.strides,
                *pad, *self.box, *pad, self.box[0] * ELEM]


def ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def tile_box(d: int, h: int, w: int,
             voxels: int = BM) -> tuple[int, int, int]:
    """The (TD, TH, TW) box of ``voxels`` output voxels: powers of two, W
    first, covering a small axis whole. For 128: (1, 2, 64) at 64^3,
    (1, 4, 32) at 32^3, (1, 8, 16) at 16^3, (2, 8, 8) at 8^3; ragged axes
    take the next power of two and mask the rows past the end."""
    tw = min(_pow2_ceil(w), voxels)
    th = min(_pow2_ceil(h), voxels // tw)
    return voxels // (tw * th), th, tw


def tile_counts(extent: Sequence[int],
                box: Sequence[int]) -> tuple[int, int, int]:
    return tuple(ceil_div(e, b) for e, b in zip(extent, box))


def choose_bn(co: int) -> int:
    """N tile: 64 where C_out <= 64 (a wider tile would be half zeros),
    else 128. Measured on the H100 at the slice shapes: a 64-wide tile
    takes about as long per K step as a 128-wide one (the step's time is
    the pipeline's, not the products'), so even where the 128-wide grid
    leaves SMs idle (enc3_conv1, 64 tiles on 132 SMs) the 64-wide one does
    not finish sooner."""
    return 64 if co <= 64 else 128


def tile_voxels(bn: int) -> int:
    """Voxels per output tile (``csrc/igemm.cuh::Smem::kBM``): 256 for the
    64-wide N tile, whose kernel swaps the operands so that every
    warpgroup issues 64 x 128 products, else 128."""
    return 2 * BM if bn == 64 else BM


def grid_blocks(n_tiles: int, device: torch.device) -> int:
    """Persistent blocks of a launch: one per SM, or one per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(n_tiles, sms)


def choose_kb(ci: int) -> int:
    """Channels per K step: 32 where C_in <= 32, so that enc0_conv2
    (C_in = 32) does not spend half its products on TMA's zero fill; 64
    (the 128-byte swizzle row) otherwise."""
    return 32 if ci <= 32 else BK


def ndhwc_map(operand: str, shape: Sequence[int], box: Sequence[int], *,
              kb: int = BK, step: int = 1,
              origin: Sequence[int] = (0, 0, 0),
              extent: Sequence[int] | None = None) -> TensorMap:
    """Map over a contiguous NDHWC tensor of ``shape`` (B, D, H, W, C) as
    (C, W, H, D, B), box (kb, TW, TH, TD, 1). ``step`` > 1 takes every
    step-th voxel on each spatial axis from ``origin`` (D, H, W), over
    ``extent`` voxels per axis (the strided sub-parity views of the skip)."""
    B, D, H, W, C = (int(s) for s in shape)
    ext = (D, H, W) if extent is None else tuple(int(e) for e in extent)
    td, th, tw = box
    od, oh, ow = origin
    return TensorMap(
        operand, dims=(C, ext[2], ext[1], ext[0], B),
        strides=(ELEM, step * C * ELEM, step * W * C * ELEM,
                 step * H * W * C * ELEM, D * H * W * C * ELEM),
        box=(kb, tw, th, td, 1),
        offset=((od * H + oh) * W + ow) * C * ELEM)


def weight_map(operand: str, shape: Sequence[int], bn: int,
               kb: int = BK) -> TensorMap:
    """Map over a K-major weight of ``shape`` (C_out, taps, C_in) or
    (parities, C_out, taps, C_in): box (kb, 1, BN[, 1]), BN output
    channels x kb K of one tap."""
    dims = tuple(int(s) for s in reversed(shape))
    strides = [ELEM]
    for d in dims[:-1]:
        strides.append(strides[-1] * d)
    box = (kb, 1, bn) + (1,) * (len(dims) - 3)
    return TensorMap(operand, dims, tuple(strides), box)


def tile_origin(bx: int, box: Sequence[int],
                tiles: Sequence[int]) -> tuple[int, int, int, int]:
    """blockIdx.x -> (b, d0, h0, w0), tile_w fastest (the kernels'
    decode)."""
    tiles_d, tiles_h, tiles_w = tiles
    w0 = bx % tiles_w * box[2]
    bx //= tiles_w
    h0 = bx % tiles_h * box[1]
    bx //= tiles_h
    d0 = bx % tiles_d * box[0]
    return bx // tiles_d, d0, h0, w0


def row_voxel(r: int, box: Sequence[int]) -> tuple[int, int, int]:
    """Tile row r -> its (td, th, tw) inside the box (row-major box)."""
    _, th, tw = box
    return r // (th * tw), r // tw % th, r % tw


def pack_specs(maps: Sequence[TensorMap],
               tensors: Mapping[str, torch.Tensor]):
    values = [v for m in maps for v in m.spec(tensors[m.operand].data_ptr())]
    return (ctypes.c_longlong * len(values))(*values)


def pack_ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)
