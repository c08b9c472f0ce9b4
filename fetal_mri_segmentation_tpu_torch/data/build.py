"""NIfTI -> dataset builder and reader (port of
``fetal_mri_segmentation_tpu/data/build.py``).

The array contract is the JAX package's:

- ``data``   (N, n_channels, *image_shape)  float32
- ``truth``  (N, 1, *image_shape)           uint8 (configurable)
- ``affine`` (N, 4, 4)                      float64
- ``subject_ids`` (N,) strings when provided;
- per case: optional shared background crop across modalities and truth,
  resample to the uniform ``image_shape`` (linear for images, nearest for
  truth);
- optional normalization pass over the stored volumes, the ``global``
  mode's moments persisted for serving.

The container differs. The JAX package writes one HDF5 file with h5py; the
port's native layout needs numpy alone: a DIRECTORY at ``config.data_file``
holding ``data.npy``, ``truth.npy`` and ``affine.npy`` (plain ``.npy``
files, written and read as memory maps, so a training-time case read is one
sequential read and nothing is decompressed) and ``meta.json`` with
``format_version``, ``subject_ids``, ``normalization``, ``norm_mean`` and
``norm_std``.

:func:`open_data_file` returns a handle with the reference's surface
(``.root.data / .truth / .affine / .subject_ids``, ``len()``, ``close()``,
context manager, ``filename``) and format-neutral accessors for what the
JAX package reads off ``h5.attrs`` (:attr:`DataFile.subject_ids`,
:attr:`DataFile.normalization`, :attr:`DataFile.global_moments`). A
directory opens as the native layout; a file opens as the JAX package's
HDF5 dataset through a function-local ``import h5py``, and where h5py is
absent the error names the converter::

    python -m fetal_mri_segmentation_tpu_torch.data.build --convert IN.h5 OUT

rewrites an HDF5 dataset into the native layout (run it where h5py is
installed). A blosc-compressed dataset (the PyTables reference format) is
refused: ``tools/convert_reference_h5.py`` of the JAX package rewrites it
into plain HDF5 first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import types
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fetal_mri_segmentation_tpu_torch.data.normalize import (
    normalize_data_storage, normalize_data_storage_per_volume,
    normalize_data_storage_windowed)
from fetal_mri_segmentation_tpu_torch.utils.geometry import (
    process_case_images)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import atomic_json_dump
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti

FORMAT_VERSION = 1
_ARRAYS = ("data", "truth", "affine")
_META = "meta.json"
# HDF5 registered filter id of blosc (PyTables' default compressor)
_BLOSC_FILTER_ID = 32001

_NO_H5PY = (
    "{path} is a file, so it is read as the JAX package's HDF5 dataset, and "
    "that needs h5py, which is not installed here. Convert it where h5py "
    "is installed (python -m fetal_mri_segmentation_tpu_torch.data.build "
    "--convert IN.h5 OUT_DIR) and point config.data_file at OUT_DIR, or "
    "rebuild the dataset from the NIfTI cases with the port's train entry")


class _Root:
    """``file.root.data`` facade over named arrays."""

    def __init__(self, arrays: dict):
        self._arrays = arrays

    def __getattr__(self, name: str):
        try:
            return self.__dict__["_arrays"][name]
        except KeyError as e:
            raise AttributeError(name) from e


class DataFile:
    """Open dataset handle, either format. Reference surface:
    ``tables.open_file(...).root.*``."""

    def __init__(self, filename: str, arrays: dict, meta: dict, closer=None):
        self.filename = filename
        self.root = _Root(arrays)
        self._meta = meta
        self._closer = closer

    @property
    def subject_ids(self) -> Optional[List[str]]:
        """The case names, or None for a dataset built without them."""
        ids = self._meta.get("subject_ids")
        return None if ids is None else [str(s) for s in ids]

    @property
    def normalization(self) -> Optional[str]:
        """The mode the builder normalized the stored volumes with."""
        return self._meta.get("normalization")

    @property
    def global_moments(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The training distribution's per-channel ``(mean, std)`` that a
        ``global`` build persisted; None otherwise."""
        if self._meta.get("norm_mean") is None:
            return None
        return (np.asarray(self._meta["norm_mean"], np.float64),
                np.asarray(self._meta["norm_std"], np.float64))

    def close(self) -> None:
        if self._closer is not None:
            self._closer()
            self._closer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return self.root.data.shape[0]


def _array_path(directory: str, name: str) -> str:
    return os.path.join(directory, name + ".npy")


def _open_native(directory: str, readwrite: str) -> DataFile:
    meta_path = os.path.join(directory, _META)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{directory}: not a dataset directory (no {_META}); the "
            "builder writes it last, so an interrupted build leaves none: "
            "rebuild with overwrite")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"{directory}: dataset format_version "
            f"{meta.get('format_version')!r}, this reader knows "
            f"{FORMAT_VERSION}")
    mode = "r" if readwrite == "r" else "r+"
    arrays = {name: np.load(_array_path(directory, name), mmap_mode=mode)
              for name in _ARRAYS}
    if meta.get("subject_ids") is not None:
        arrays["subject_ids"] = np.asarray(meta["subject_ids"], dtype=object)
    return DataFile(directory, arrays, meta)


def _import_h5py(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(_NO_H5PY.format(path=path)) from e
    return h5py


def _open_hdf5(path: str, readwrite: str) -> DataFile:
    h5py = _import_h5py(path)
    h5 = h5py.File(path, readwrite)
    try:
        for name in _ARRAYS:
            plist = h5[name].id.get_create_plist()
            if _BLOSC_FILTER_ID in {plist.get_filter(i)[0] for i in
                                    range(plist.get_nfilters())}:
                raise RuntimeError(
                    f"{path}:{name} is blosc-compressed (the PyTables "
                    "reference format), which the port does not read: "
                    "rewrite the file with tools/convert_reference_h5.py "
                    "(where libblosc is installed), then convert the result "
                    "with python -m fetal_mri_segmentation_tpu_torch.data."
                    "build --convert")
        arrays = {name: h5[name] for name in _ARRAYS}
        meta = {"subject_ids": None,
                "normalization": h5.attrs.get("normalization"),
                "norm_mean": None, "norm_std": None}
        if "subject_ids" in h5:
            arrays["subject_ids"] = h5["subject_ids"]
            meta["subject_ids"] = [
                s.decode() if isinstance(s, bytes) else str(s)
                for s in h5["subject_ids"][:]]
        if "norm_mean" in h5.attrs:
            meta["norm_mean"] = np.asarray(h5.attrs["norm_mean"]).tolist()
            meta["norm_std"] = np.asarray(h5.attrs["norm_std"]).tolist()
        if meta["normalization"] is not None:
            meta["normalization"] = str(meta["normalization"])
    except BaseException:
        h5.close()
        raise
    return DataFile(path, arrays, meta, closer=h5.close)


def open_data_file(filename: str, readwrite: str = "r") -> DataFile:
    """Open a dataset: a directory as the native layout, a file as the JAX
    package's HDF5 dataset (needs h5py). Reference:
    ``data.py::open_data_file``."""
    if os.path.isdir(filename):
        return _open_native(filename, readwrite)
    if not os.path.exists(filename):
        raise FileNotFoundError(
            f"{filename}: no dataset (a directory in the port's layout, or "
            "an HDF5 file of the JAX package)")
    return _open_hdf5(filename, readwrite)


def create_data_file(out_file: str, n_channels: int, n_samples: int,
                     image_shape: Sequence[int], truth_dtype=np.uint8):
    """Create the native layout, pre-sized: the three arrays as writable
    memory maps under the directory ``out_file`` (an existing dataset there
    is replaced). ``meta.json`` is written last, by the builder, so a
    directory without it is an interrupted build. Returns a namespace with
    ``data``, ``truth`` and ``affine``."""
    image_shape = tuple(int(s) for s in image_shape)
    if os.path.isdir(out_file):
        shutil.rmtree(out_file)
    elif os.path.exists(out_file):
        os.remove(out_file)
    os.makedirs(out_file)
    shapes = {"data": ((n_samples, n_channels) + image_shape, np.float32),
              "truth": ((n_samples, 1) + image_shape, np.dtype(truth_dtype)),
              "affine": ((n_samples, 4, 4), np.float64)}
    return types.SimpleNamespace(**{
        name: np.lib.format.open_memmap(_array_path(out_file, name),
                                        mode="w+", dtype=dtype, shape=shape)
        for name, (shape, dtype) in shapes.items()})


def _write_meta(out_file: str, subject_ids, normalization, moments) -> None:
    mean, std = moments if moments is not None else (None, None)
    atomic_json_dump({
        "format_version": FORMAT_VERSION,
        "subject_ids": (None if subject_ids is None
                        else [str(s) for s in subject_ids]),
        "normalization": normalization,
        "norm_mean": (None if mean is None
                      else np.asarray(mean, np.float64).tolist()),
        "norm_std": (None if std is None
                     else np.asarray(std, np.float64).tolist()),
    }, os.path.join(out_file, _META))


def write_data_to_file(training_data_files: Sequence[Sequence[str]],
                       out_file: str,
                       image_shape: Sequence[int],
                       truth_dtype=np.uint8,
                       subject_ids: Optional[Sequence[str]] = None,
                       normalize: Optional[str] = "per_volume",
                       crop: bool = True) -> str:
    """Convert per-case NIfTI file lists ``[mod1.nii, ..., truth.nii]`` into
    one dataset directory. Reference: ``data.py::write_data_to_file``.

    ``normalize``: None | "per_volume" | "global" | "windowed" (see
    ``data/normalize.py``: the upstream lineage uses a single global
    (mean, std), the fetal adaptation a per-volume z-score).
    """
    if normalize not in (None, "per_volume", "global", "windowed"):
        # the serving-time twin (normalize.py::normalize_case) validates;
        # the builder must too: applying per_volume for a typo like
        # "per-volume" and persisting the bogus string would poison every
        # later reader of the dataset's normalization
        raise ValueError(
            f"normalize={normalize!r} — must be None, 'per_volume', "
            f"'global' or 'windowed'")
    n_samples = len(training_data_files)
    n_channels = len(training_data_files[0]) - 1

    arrays = create_data_file(out_file, n_channels, n_samples, image_shape,
                              truth_dtype=truth_dtype)
    for i, case_files in enumerate(training_data_files):
        # single-read: each (gzipped) file decompressed exactly once for
        # both the shared-crop scan and the resample
        images = process_case_images(
            [load_nifti(f) for f in case_files],
            image_shape=image_shape, crop=crop)
        arrays.data[i] = np.stack([img.get_fdata(dtype=np.float32)
                                   for img in images[:-1]], axis=0)
        arrays.truth[i] = images[-1].get_fdata(
            dtype=np.float32)[None].astype(truth_dtype)
        arrays.affine[i] = images[0].affine
    moments = None
    if normalize == "global":
        # persisted so serving-time cases are shifted into the training
        # distribution rather than z-scored against themselves
        moments = normalize_data_storage(arrays.data)
    elif normalize == "windowed":
        normalize_data_storage_windowed(arrays.data)
    elif normalize:
        normalize_data_storage_per_volume(arrays.data)
    for name in _ARRAYS:
        getattr(arrays, name).flush()
    del arrays
    _write_meta(out_file, subject_ids, normalize, moments)
    return out_file


def dataset_bytes(path: str) -> int:
    """The bytes a dataset holds on disk (either format)."""
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
    return os.path.getsize(path)


def convert_hdf5(in_file: str, out_dir: str) -> str:
    """Rewrite a JAX-package HDF5 dataset as the native layout; the
    ``subject_ids``, the normalization mode and the ``global`` moments come
    across. Needs h5py."""
    with _open_hdf5(in_file, "r") as src:
        data, truth = src.root.data, src.root.truth
        arrays = create_data_file(out_dir, data.shape[1], data.shape[0],
                                  data.shape[2:], truth_dtype=truth.dtype)
        for i in range(data.shape[0]):  # one case (one HDF5 chunk) at a time
            arrays.data[i] = data[i]
            arrays.truth[i] = truth[i]
        arrays.affine[:] = src.root.affine[:]
        for name in _ARRAYS:
            getattr(arrays, name).flush()
        del arrays
        _write_meta(out_dir, src.subject_ids, src.normalization,
                    src.global_moments)
    return out_dir


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--convert", nargs=2, metavar=("IN_H5", "OUT_DIR"),
                    required=True,
                    help="rewrite a JAX-package HDF5 dataset into the "
                         "port's directory layout (needs h5py)")
    args = ap.parse_args()
    out = convert_hdf5(*args.convert)
    with open_data_file(out) as f:
        print(f"wrote {len(f)} cases, {dataset_bytes(out)} bytes, "
              f"normalization={f.normalization!r}, to {out}")
