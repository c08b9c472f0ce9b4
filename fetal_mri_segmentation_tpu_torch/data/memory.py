"""Stacked training cases held in host memory, read like the HDF5 data file.

The JAX package's dataset is an HDF5 file (``data/build.py``, h5py) whose
``root.data`` is (N, C, D, H, W) float32 and ``root.truth`` (N, 1, D, H, W)
uint8. :class:`InMemoryDataFile` exposes numpy arrays of the same layout
under the same names, so the generators (``pipeline/generator.py``) read it
unchanged. It is not a file format and writes nothing to disk: the port's
dataset on disk is ``data/build.py``'s directory layout, and this class
stays for tests that want cases in memory.
"""

from __future__ import annotations

import types
from typing import Sequence

import numpy as np

from fetal_mri_segmentation_tpu_torch.inference.predict import (
    preprocess_case)


class InMemoryDataFile:
    """``.root.data`` (N, C, D, H, W) float32 and ``.root.truth``
    (N, 1, D, H, W) uint8, in host memory."""

    def __init__(self, data: np.ndarray, truth: np.ndarray):
        data = np.asarray(data, np.float32)
        truth = np.asarray(truth, np.uint8)
        if truth.ndim == data.ndim - 1:
            truth = truth[:, None]
        if (data.ndim != 5 or truth.shape[1] != 1
                or truth.shape[:1] + truth.shape[2:]
                != data.shape[:1] + data.shape[2:]):
            raise ValueError(f"data {data.shape} and truth {truth.shape} "
                             "are not (N, C, D, H, W) and (N, 1, D, H, W)")
        self.root = types.SimpleNamespace(data=data, truth=truth)

    @classmethod
    def from_cases(cls, paths: Sequence[str], config) -> "InMemoryDataFile":
        """NIfTI case directories (each with its truth) through the port's
        host preprocessing (``preprocess_case``: crop, resample to
        ``config.image_shape``, normalize), stacked."""
        data, truth = [], []
        for path in paths:
            x, _, truth_image = preprocess_case(path, config)
            if truth_image is None:
                raise ValueError(f"{path}: a training case needs a truth "
                                 "file")
            data.append(x)
            truth.append(truth_image.get_fdata(dtype=np.float32).astype(
                np.uint8))
        return cls(np.stack(data), np.stack(truth))

    def close(self) -> None:
        """Nothing to release (the HDF5 file's interface)."""
