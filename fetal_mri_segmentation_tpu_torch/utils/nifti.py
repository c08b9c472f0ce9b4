"""Minimal pure-numpy NIfTI reader/writer (.nii / .nii.gz): a copy of
``fetal_mri_segmentation_tpu/utils/nifti.py``, kept in the port so that
the port imports nothing of the JAX package.

The reference uses nibabel for all NIfTI I/O (reference: unet3d/utils/
utils.py::read_image, prediction.py::prediction_to_image → nib.save). nibabel
is not a dependency, and NIfTI is a simple fixed-size-header
format, so we implement exactly the subset the pipeline needs:

- read: NIfTI-1 (348-byte header) AND NIfTI-2 (540-byte header), both
  endiannesses — scanner/pipeline exports are routinely big-endian, and
  nibabel (the reference's reader) accepts all four combinations; dims,
  datatype (u8/i16/i32/f32/f64/i8/u16/u32/i64), scl slope/inter, affine
  from sform (preferred), qform (quaternion), or pixdim fallback;
- write: NIfTI-1 little-endian, data + 4x4 affine with sform_code=1,
  Fortran voxel order, optional gzip (suffix-driven).

Voxel data is returned in x-fastest (Fortran) axis order as a C-contiguous
array indexed [i, j, k], matching nibabel's `get_fdata()` axis convention so
saved outputs align voxel-for-voxel with reference outputs.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_BITPIX = {2: 8, 4: 16, 8: 32, 16: 32, 64: 64, 256: 8, 512: 16, 768: 32, 1024: 64}


@dataclass
class NiftiImage:
    """A volume + its voxel-to-world affine (nibabel-like duck type)."""
    dataobj: np.ndarray
    affine: np.ndarray

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        return np.asarray(self.dataobj, dtype=dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dataobj.shape

    @property
    def header(self):
        return {"dim": self.dataobj.shape}


def _open(path: str, mode: str = "rb"):
    """READ opener (gzip auto-detected by suffix). Writes go through
    save_nifti's atomic temp+rename path, which owns the compression
    policy (gzip level 1 — the default 9 cost seconds per volume on the
    serving path for a few percent smaller files)."""
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# header field layouts: (offset, struct format without byte-order prefix)
# for each NIfTI version.  NIfTI-2 moves/widens fields (dims are int64,
# reals are doubles) but the semantics are identical.
_LAYOUT = {
    1: {"dim": (40, "8h"), "datatype": (70, "h"), "pixdim": (76, "8f"),
        "vox_offset": (108, "f"), "scl": (112, "2f"),
        "qform_code": (252, "h"), "sform_code": (254, "h"),
        "quatern": (256, "3f"), "qoffset": (268, "3f"),
        "srow": (280, "4f", 16), "hdr_size": 348, "default_offset": 352},
    2: {"dim": (16, "8q"), "datatype": (12, "h"), "pixdim": (104, "8d"),
        "vox_offset": (168, "q"), "scl": (176, "2d"),
        "qform_code": (344, "i"), "sform_code": (348, "i"),
        "quatern": (352, "3d"), "qoffset": (376, "3d"),
        "srow": (400, "4d", 32), "hdr_size": 540, "default_offset": 544},
}

# datatypes nibabel reads but a segmentation pipeline cannot use as scalar
# volumes — rejected with a specific message rather than a bare code.
_NONSCALAR = {128: "RGB24", 2304: "RGBA32", 32: "complex64",
              1792: "complex128", 2048: "complex256", 1: "binary(1bit)"}


def _detect_version(raw: bytes, path: str):
    """(version, byte-order prefix) from the sizeof_hdr field.

    NIfTI mandates sizeof_hdr == 348 (v1) / 540 (v2) in the file's own
    byte order, which makes it the endianness probe (same trick nibabel
    uses): 348 byteswapped is 1543569408, 540 byteswapped is 469893120 —
    no ambiguity.
    """
    if len(raw) < 4:
        raise ValueError(f"{path}: not a NIfTI file ({len(raw)} bytes)")
    (le,) = struct.unpack_from("<i", raw, 0)
    if le == 348:
        return 1, "<"
    if le == 540:
        return 2, "<"
    (be,) = struct.unpack_from(">i", raw, 0)
    if be == 348:
        return 1, ">"
    if be == 540:
        return 2, ">"
    raise ValueError(f"{path}: not a NIfTI-1/NIfTI-2 file "
                     f"(sizeof_hdr={le} LE / {be} BE; expected 348 or 540)")


def _quaternion_affine(hdr: bytes, lay, bo: str) -> np.ndarray:
    b, c, d = struct.unpack_from(bo + lay["quatern"][1], hdr,
                                 lay["quatern"][0])
    ox, oy, oz = struct.unpack_from(bo + lay["qoffset"][1], hdr,
                                    lay["qoffset"][0])
    pixdim = struct.unpack_from(bo + lay["pixdim"][1], hdr, lay["pixdim"][0])
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a*a+b*b-c*c-d*d, 2*(b*c-a*d),     2*(b*d+a*c)],
        [2*(b*c+a*d),     a*a+c*c-b*b-d*d, 2*(c*d-a*b)],
        [2*(b*d-a*c),     2*(c*d+a*b),     a*a+d*d-b*b-c*c],
    ])
    S = np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = (ox, oy, oz)
    return aff


def load_nifti(path: str) -> NiftiImage:
    with _open(path, "rb") as f:
        raw = f.read()
    version, bo = _detect_version(raw, path)
    lay = _LAYOUT[version]
    if len(raw) < lay["hdr_size"]:
        # keep the malformed-input error contract (ValueError) — a
        # truncated download would otherwise surface as struct.error from
        # a field unpack, which serving-path error classification misses
        raise ValueError(
            f"{path}: truncated NIfTI-{version} file ({len(raw)} bytes "
            f"< {lay['hdr_size']}-byte header)")
    hdr = raw[:lay["hdr_size"]]

    def field(name):
        off, fmt = lay[name][:2]
        return struct.unpack_from(bo + fmt, hdr, off)

    dim = field("dim")
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        # the spec mandates 1..7; 0 would reshape a 0-element buffer into
        # a scalar with a cryptic numpy message downstream
        raise ValueError(f"{path}: corrupt NIfTI header (dim[0]={ndim}, "
                         "must be 1..7)")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    if any(d < 0 for d in shape):
        raise ValueError(f"{path}: corrupt NIfTI header (negative dim "
                         f"in {shape})")
    (datatype,) = field("datatype")
    (vox_offset,) = field("vox_offset")
    scl_slope, scl_inter = field("scl")
    sform_code = field("sform_code")[0]
    qform_code = field("qform_code")[0]

    if datatype in _NONSCALAR:
        raise ValueError(
            f"{path}: NIfTI datatype {_NONSCALAR[datatype]} ({datatype}) is "
            f"not a scalar volume — this pipeline segments single-valued "
            f"intensity images; convert the file (e.g. take one channel) "
            f"before ingest")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    n = int(np.prod(shape)) if shape else 0
    off = int(vox_offset) if vox_offset else lay["default_offset"]
    if off < lay["hdr_size"] or off + n * dt.itemsize > len(raw):
        # dims/offset inconsistent with the actual byte count — a clear
        # "truncated or corrupt" error instead of numpy's buffer message
        raise ValueError(
            f"{path}: truncated or corrupt NIfTI file — header promises "
            f"{n} voxels of {dt.base.name} at offset {off} but the file "
            f"holds {len(raw)} bytes")
    data = np.frombuffer(raw, dtype=dt, count=n, offset=off)
    data = data.reshape(shape, order="F")
    # nibabel semantics: non-finite scale fields mean NO scaling (scanner
    # exports routinely carry scl_slope=NaN); applying them would turn the
    # whole volume into NaN with no error downstream
    if not np.isfinite(scl_slope):
        scl_slope, scl_inter = 0.0, 0.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope == 0.0:
        # nibabel semantics (get_slope_inter): slope 0 means NO scaling
        # information — the intercept is ignored too. Applying a garbage
        # scl_inter like -1024 would silently shift every label value.
        scl_inter = 0.0
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    else:
        # native byte order out (downstream jnp/h5py paths assume it)
        data = np.ascontiguousarray(
            data.astype(dt.newbyteorder("="), copy=False))

    if sform_code > 0:
        soff, sfmt, stride = lay["srow"]
        rows = [struct.unpack_from(bo + sfmt, hdr, soff + stride * i)
                for i in range(3)]
        affine = np.vstack([np.array(rows), [0, 0, 0, 1]]).astype(np.float64)
    elif qform_code > 0:
        affine = _quaternion_affine(hdr, lay, bo)
    else:
        pixdim = field("pixdim")
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0,
                          pixdim[3] or 1.0, 1.0])
    return NiftiImage(np.ascontiguousarray(data), affine)


def save_nifti(image_or_data, path: str, affine: Optional[np.ndarray] = None,
               scl_slope: float = 1.0, scl_inter: float = 0.0) -> None:
    """Write a NIfTI-1 single file; gzip iff path ends with .gz.

    ``scl_slope``/``scl_inter``: standard NIfTI value scaling — readers
    (this module's loader, nibabel get_fdata) return
    ``stored * slope + inter``. Lets fixed-point probability maps be
    stored as uint8/uint16 with slope 1/255 (4x smaller files and gzip
    time) while every consumer still sees [0,1] floats."""
    if isinstance(image_or_data, NiftiImage):
        # an explicitly passed affine OVERRIDES the image's (a caller
        # re-stamping a resampled image must not silently get the stale one)
        data = image_or_data.dataobj
        affine = image_or_data.affine if affine is None else np.asarray(affine)
    else:
        data = np.asarray(image_or_data)
        affine = np.eye(4) if affine is None else np.asarray(affine)

    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[data.dtype]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, _BITPIX[code])
    # pixdim from affine column norms
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, float(zooms[0] or 1), float(zooms[1] or 1),
                     float(zooms[2] or 1), 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<2f", hdr, 112, float(scl_slope), float(scl_inter))
    struct.pack_into("<2h", hdr, 252, 0, 1)   # qform_code=0, sform_code=1
    for i in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * i, *[float(v) for v in affine[i]])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    # atomic publish: write a sibling temp file and rename into place, so a
    # failed/interrupted write can never leave a truncated .nii[.gz] that
    # downstream consumers (e.g. serve.py's already-predicted check) would
    # mistake for a complete artifact.
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        # compression is decided by the FINAL path (tmp lacks the .gz)
        opener = (gzip.open if str(path).endswith(".gz") else open)
        kw = {"compresslevel": 1} if opener is gzip.open else {}
        with opener(tmp, "wb", **kw) as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


# nibabel-compatible aliases used around the codebase
def load(path: str) -> NiftiImage:
    return load_nifti(path)


def save(img: NiftiImage, path: str) -> None:
    save_nifti(img, path)


def Nifti1Image(data, affine) -> NiftiImage:  # noqa: N802 (nibabel-compat name)
    return NiftiImage(np.asarray(data), np.asarray(affine))
