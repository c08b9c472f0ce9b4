"""Plain ingest of one NIfTI case, as the reference's ``predict`` prepares
it (ellisdg/3DUnetCNN ``unet3d/utils/utils.py``: nilearn's ``crop_img``
and a linear resample to the training shape, then the fetal fork's
per-volume z-score), and a reader of the NIfTI-1 files the program writes.

- Crop: the bounding box of the voxels whose magnitude exceeds 1e-8 of
  the largest, grown by one voxel per side and clipped to the volume.
- Resample: linear interpolation at the centres of the new grid's voxels
  (source coordinate ``(i + 0.5) * old / new - 0.5``), clamped to the
  edge voxels, axis by axis, in float64.
- Normalize: ``(x - mean) / std`` over the volume (population std).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np
import torch

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16}


def read_nifti(path: str):
    """(array in (i, j, k) order, 4x4 sform affine) of a little-endian
    NIfTI-1 file, gzipped or not; scl_slope / scl_inter applied."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if struct.unpack("<i", raw[:4])[0] != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack("<8h", raw[40:56])
    code = struct.unpack("<h", raw[70:72])[0]
    offset = int(struct.unpack("<f", raw[108:112])[0])
    slope, inter = struct.unpack("<2f", raw[112:120])
    srow = np.array(struct.unpack("<12f", raw[280:328]), np.float64)
    shape = tuple(int(d) for d in dim[1:1 + dim[0]])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, _DTYPES[code], count, offset)
    data = data.reshape(shape, order="F")
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data * np.float32(slope or 1.0) + np.float32(inter)
    affine = np.eye(4)
    affine[:3] = srow.reshape(3, 4)
    return np.ascontiguousarray(data), affine


def crop_box(data: np.ndarray, pad: int = 1):
    big = max(-float(data.min()), float(data.max()))
    mask = np.abs(data) > 1e-8 * big
    box = []
    for axis in range(3):
        other = tuple(a for a in range(3) if a != axis)
        idx = np.nonzero(mask.any(axis=other))[0]
        if idx.size == 0:
            box.append(slice(0, data.shape[axis]))
            continue
        box.append(slice(max(int(idx[0]) - pad, 0),
                         min(int(idx[-1]) + 1 + pad, data.shape[axis])))
    return tuple(box)


def resample_linear(x: torch.Tensor, shape) -> torch.Tensor:
    """x (D, H, W) float64 -> ``shape``, linear, at voxel centres."""
    for axis, new in enumerate(shape):
        old = x.shape[axis]
        if old == new:
            continue
        pos = ((torch.arange(new, dtype=torch.float64, device=x.device) + 0.5)
               * (old / new) - 0.5).clamp(0, old - 1)
        i0 = pos.floor().long().clamp(max=old - 1)
        i1 = (i0 + 1).clamp(max=old - 1)
        t = pos - i0.double()
        view = [1, 1, 1]
        view[axis] = new
        a = x.index_select(axis, i0)
        b = x.index_select(axis, i1)
        x = a * (1 - t.view(view)) + b * t.view(view)
    return x


def prepare(path: str, shape, device) -> torch.Tensor:
    """The (1, D, H, W) float32 network input of the case at ``path``."""
    data, _ = read_nifti(path)
    data = data[crop_box(data)]
    x = torch.from_numpy(np.asarray(data, np.float64)).to(device)
    x = resample_linear(x, shape)
    x = (x - x.mean()) / x.std(correction=0)
    return x.float()[None]
