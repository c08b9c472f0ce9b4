"""Host-side ingest geometry: background crop + resample to uniform shape.
A copy of ``fetal_mri_segmentation_tpu/utils/geometry.py``, kept in the
port so that the port imports nothing of the JAX package.

Reference: unet3d/utils/nilearn_custom_utils::crop_img (zero-background crop
returning slices, shared across modalities+truth), unet3d/utils/utils.py::
resize / read_image_files, unet3d/utils/sitk_utils.py::
sitk_resample_to_spacing + calculate_origin_offset. nilearn/SimpleITK are not
dependencies; the same geometry is implemented with numpy + scipy.ndimage:

- crop: bounding box of voxels above a background threshold (with a small
  margin), returned as slices so one crop applies to all files of a case;
- resample: scipy.ndimage.zoom to the target shape (linear for images,
  nearest for label maps), with the affine updated so world coordinates are
  preserved (spacing scaled, origin offset by the half-voxel shift).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from fetal_mri_segmentation_tpu_torch.utils.nifti import NiftiImage
from fetal_mri_segmentation_tpu_torch.utils.profiling import span


def ensure_3d(data: np.ndarray, origin: str = "volume") -> np.ndarray:
    """Squeeze trailing singleton dims of a >3-D array (scanner exports
    routinely write 3-D volumes as 4-D NIfTI with dim[4]=1); reject true
    multi-frame data with a clear message instead of a scipy shape error.

    Reference: nibabel-backed ingest (utils.py::read_image) — nibabel
    loads such files as 4-D and the reference's resize would face the
    same mismatch; squeezing is the universally-intended reading.
    """
    if data.ndim <= 3:
        return data
    if all(s == 1 for s in data.shape[3:]):
        return data.reshape(data.shape[:3])
    raise ValueError(
        f"{origin}: expected a 3-D volume, got shape {data.shape} — "
        "multi-frame/4-D NIfTI is not supported; split the frames into "
        "separate files (one 3-D volume per file)")


def crop_img_to_slices(data: np.ndarray, rtol: float = 1e-8,
                       pad: int = 1) -> Tuple[slice, ...]:
    """Bounding-box slices of non-background voxels (nilearn crop_img contract)."""
    infinity_norm = max(-data.min(), data.max())
    mask = np.logical_or(data < -rtol * infinity_norm,
                         data > rtol * infinity_norm)
    if mask.ndim > 3:  # extra (time/channel) dims count toward any axis box
        mask = mask.reshape(mask.shape[:3] + (-1,)).any(axis=-1)
    if not mask.any():
        return tuple(slice(0, s) for s in data.shape[:3])
    # per-axis any() projections instead of np.where: the box needs only
    # first/last occupied index per axis, not the O(n_foreground) coordinate
    # lists (3x faster on a mostly-foreground 128^3 volume — serving path)
    start, end = [], []
    for axis in range(3):
        other = tuple(a for a in range(3) if a != axis)
        line = np.flatnonzero(mask.any(axis=other))
        start.append(max(int(line[0]) - pad, 0))
        end.append(min(int(line[-1]) + 1 + pad, data.shape[axis]))
    return tuple(slice(s, e) for s, e in zip(start, end))


def crop_affine(affine: np.ndarray, slices: Sequence[slice]) -> np.ndarray:
    """Shift the affine origin to the crop start (world coords preserved)."""
    out = affine.copy()
    start = np.array([s.start or 0 for s in slices], dtype=np.float64)
    out[:3, 3] = affine[:3, :3] @ start + affine[:3, 3]
    return out


def zoomed_affine(affine: np.ndarray, old_shape: Sequence[int],
                  new_shape: Sequence[int]) -> np.ndarray:
    """Affine after a grid_mode=True zoom old_shape→new_shape: spacing
    scaled, origin shifted by half the voxel-size change (world coords
    preserved). Shared by the host resample below and the device-resample
    ingest path (ops/resample.py), which must stamp identical affines."""
    old = np.asarray(old_shape, dtype=np.float64)
    new = np.asarray(new_shape, dtype=np.float64)
    scale = old / new
    out = affine.copy()
    out[:3, :3] = affine[:3, :3] * scale[None, :]
    half_shift = (scale - 1.0) / 2.0
    out[:3, 3] = affine[:3, :3] @ half_shift + affine[:3, 3]
    return out


def resample_to_shape(image: NiftiImage, new_shape: Sequence[int],
                      interpolation: str = "linear") -> NiftiImage:
    """Zoom a volume to `new_shape`, updating the affine (spacing + origin).

    Reference: utils.py::resize (SimpleITK resample to the spacing implied by
    the new shape; "linear" for images, "nearest" for truth).
    """
    data = image.get_fdata(dtype=np.float32)
    old_shape = data.shape[:3]
    zoom = (np.asarray(new_shape, dtype=np.int64)
            / np.asarray(old_shape, dtype=np.float64))
    order = {"linear": 1, "nearest": 0, "cubic": 3}[interpolation]
    out = ndimage.zoom(data, zoom, order=order, mode="nearest",
                       grid_mode=True, prefilter=(order > 1))
    return NiftiImage(out.astype(np.float32),
                      zoomed_affine(image.affine, old_shape, new_shape))


def read_image(path: str, image_shape: Optional[Sequence[int]] = None,
               crop: Optional[Sequence[slice]] = None,
               interpolation: str = "linear") -> NiftiImage:
    """Load one NIfTI, optionally crop (shared slices) and resample.

    Reference: utils.py::read_image.
    """
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti

    image = load_nifti(path)
    if len(image.shape) > 3:  # 4-D trailing-singleton scanner exports
        image = NiftiImage(ensure_3d(image.get_fdata(dtype=np.float32), path),
                           image.affine)
    if crop is not None:
        data = image.get_fdata(dtype=np.float32)[tuple(crop)]
        image = NiftiImage(data, crop_affine(image.affine, crop))
    if image_shape is not None and tuple(image.shape[:3]) != tuple(image_shape):
        image = resample_to_shape(image, image_shape, interpolation)
    return image


def read_image_files(image_files: Sequence[str],
                     image_shape: Optional[Sequence[int]] = None,
                     crop: Optional[Sequence[slice]] = None,
                     label_indices: Optional[Sequence[int]] = None):
    """Load a case's file list ([mod1, ..., truth]); nearest-interp for labels.

    Reference: utils.py::read_image_files (label_indices selects which files
    get nearest-neighbor interpolation — by convention the last file is
    truth). Pass an explicit EMPTY list for all-modality cases (e.g. ad-hoc
    inference with no truth file) — ``None`` means "last file is the label",
    ``[]`` means "no label files".
    """
    label_indices = set(label_indices if label_indices is not None
                        else [len(image_files) - 1])
    images = []
    for i, f in enumerate(image_files):
        interp = "nearest" if i in label_indices else "linear"
        images.append(read_image(f, image_shape=image_shape, crop=crop,
                                 interpolation=interp))
    return images


def _union_crop(arrays, pad: int = 1) -> Tuple[slice, ...]:
    """Union bounding box of the per-array background crops — THE shared
    crop-union logic; both ingest paths (path-based and single-read) call
    this so they cannot diverge."""
    starts, ends = None, None
    for arr in arrays:
        sl = crop_img_to_slices(arr, pad=pad)
        s = np.array([x.start for x in sl])
        e = np.array([x.stop for x in sl])
        starts = s if starts is None else np.minimum(starts, s)
        ends = e if ends is None else np.maximum(ends, e)
    return tuple(slice(int(s), int(e)) for s, e in zip(starts, ends))


def compute_shared_crop_images(images, pad: int = 1) -> Tuple[slice, ...]:
    """`compute_shared_crop` over ALREADY-LOADED NiftiImages (no re-read).

    Generator, not list: only one float32 conversion is live at a time —
    a 4-modality high-res case would otherwise hold every converted volume
    simultaneously at peak.
    """
    return _union_crop((img.get_fdata(dtype=np.float32) for img in images),
                       pad=pad)


def compute_shared_crop(image_files: Sequence[str], pad: int = 1
                        ) -> Tuple[slice, ...]:
    """Union bounding box over all of a case's files (so one crop fits all).

    Reference: data.py::write_image_data_to_file with crop=True →
    nilearn_custom_utils crop computed across modalities+truth.
    """
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti

    return compute_shared_crop_images(
        [load_nifti(f) for f in image_files], pad=pad)


def process_case_images(images, image_shape: Optional[Sequence[int]] = None,
                        crop: bool = True,
                        label_indices: Optional[Sequence[int]] = None,
                        pad: int = 1):
    """Single-read ingest preprocessing over ALREADY-LOADED NiftiImages:
    shared background crop (union box across all images) + resample to
    ``image_shape`` (nearest for label files, linear otherwise).

    Same semantics as ``compute_shared_crop`` + ``read_image_files`` on
    paths, but each file is decompressed exactly ONCE — the serving hot
    path reads a gzipped case only one time (inference/predict.py::
    predict_case). ``label_indices`` follows read_image_files' convention
    (None = last image is the label; [] = no labels). The resample, given
    ``image_shape``, is the span ``ingest.resample`` (``utils/
    profiling.py``).
    """
    label_set = set(label_indices if label_indices is not None
                    else [len(images) - 1])
    # ONE float32 materialization per file, reused by the crop scan and the
    # crop application (get_fdata converts the on-disk dtype each call);
    # 4-D trailing-singleton exports squeeze to 3-D here (clear error on
    # true multi-frame files)
    arrays = [ensure_3d(img.get_fdata(dtype=np.float32)) for img in images]
    images = [img if arr.shape == tuple(img.shape)
              else NiftiImage(arr, img.affine)
              for img, arr in zip(images, arrays)]
    if crop:
        slices = _union_crop(arrays, pad=pad)
        images = [NiftiImage(arr[slices], crop_affine(img.affine, slices))
                  for img, arr in zip(images, arrays)]
    if image_shape is None:
        return images
    with span("ingest.resample"):
        return [img if tuple(img.shape[:3]) == tuple(image_shape)
                else resample_to_shape(
                    img, image_shape,
                    "nearest" if i in label_set else "linear")
                for i, img in enumerate(images)]
