"""Synthetic ellipsoid "fetal brain" cases for smoke runs and the quality
loops.

Copies of ``tests/synthetic.py::make_ellipsoid_case``,
``write_synthetic_dataset``, ``make_multiclass_case`` and
``write_multiclass_dataset`` (that module imports the JAX package): a
random ellipsoid as truth, a noisy bright copy of it as the image, written
as ``<directory>/case_<i>/{<modality>.nii.gz, truth.nii.gz}``; or three
disjoint ellipsoids labelled 1, 2 and 4. Tests hold the copies equal to the
originals.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from fetal_mri_segmentation_tpu_torch.utils.nifti import save_nifti


def make_ellipsoid_case(shape=(24, 24, 24), seed=0,
                        noise: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    center = np.array(shape) / 2 + rng.uniform(-3, 3, 3)
    radii = np.array(shape) * rng.uniform(0.2, 0.35, 3)
    grids = np.mgrid[: shape[0], : shape[1], : shape[2]]
    d = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
    truth = (d < 1).astype(np.uint8)
    vol = truth * 2.0 + rng.normal(0, noise, shape)
    return vol.astype(np.float32), truth


def write_synthetic_dataset(directory: str, n_cases: int = 4,
                            shape=(24, 24, 24),
                            modalities: Sequence[str] = ("volume",)
                            ) -> List[List[str]]:
    """Write per-case NIfTI files; returns the [mod..., truth] path lists."""
    os.makedirs(directory, exist_ok=True)
    training_files = []
    for i in range(n_cases):
        vol, truth = make_ellipsoid_case(shape=shape, seed=i)
        case_dir = os.path.join(directory, f"case_{i}")
        os.makedirs(case_dir, exist_ok=True)
        affine = np.diag([1.0, 1.0, 2.0, 1.0])  # anisotropic like fetal MRI
        affine[:3, 3] = (-12, -12, -24)
        files = []
        for m in modalities:
            p = os.path.join(case_dir, f"{m}.nii.gz")
            save_nifti(vol, p, affine=affine)
            files.append(p)
        pt = os.path.join(case_dir, "truth.nii.gz")
        save_nifti(truth, pt, affine=affine)
        files.append(pt)
        training_files.append(files)
    return training_files


def make_multiclass_case(shape=(36, 36, 36), seed=0, noise: float = 0.25
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Three DISJOINT ellipsoid structures with distinct intensities along
    the volume diagonal, labelled 1, 2 and 4 (non-contiguous label values
    exercise the argmax -> labels[i] mapping).

    Copy of ``tests/synthetic.py::make_multiclass_case``. Each structure
    holds ~1000+ voxels: per-channel soft dice leaves a channel whose
    probability saturates early with ~zero gradient, and small structures
    trip that (``docs/PARITY.md``, multi-class failure modes).
    """
    rng = np.random.default_rng(seed)
    grids = np.mgrid[: shape[0], : shape[1], : shape[2]]

    def ellipsoid(center, radii):
        return sum(((g - c) / r) ** 2
                   for g, c, r in zip(grids, center, radii)) < 1

    truth = np.zeros(shape, np.uint8)
    for lab, frac in ((1, 0.24), (2, 0.52), (4, 0.78)):
        center = np.array(shape) * frac + rng.uniform(-1.5, 1.5, 3)
        radii = np.array(shape) * rng.uniform(0.16, 0.20, 3)
        truth[ellipsoid(center, radii) & (truth == 0)] = lab
    vol = ((truth == 1) * 1.0 + (truth == 2) * 3.0 + (truth == 4) * 2.0
           + rng.normal(0, noise, shape))
    return vol.astype(np.float32), truth


def write_multiclass_dataset(directory: str, n_cases: int = 24,
                             shape=(40, 40, 40)) -> List[List[str]]:
    """Per-case [volume, truth] NIfTIs with the 3-structure label maps.
    Copy of ``tests/synthetic.py::write_multiclass_dataset``."""
    os.makedirs(directory, exist_ok=True)
    training_files = []
    for i in range(n_cases):
        vol, truth = make_multiclass_case(shape=shape, seed=i)
        case_dir = os.path.join(directory, f"case_{i}")
        os.makedirs(case_dir, exist_ok=True)
        affine = np.diag([1.0, 1.0, 2.0, 1.0])
        affine[:3, 3] = (-12, -12, -24)
        pv = os.path.join(case_dir, "volume.nii.gz")
        pt = os.path.join(case_dir, "truth.nii.gz")
        save_nifti(vol, pv, affine=affine)
        save_nifti(truth, pt, affine=affine)
        training_files.append([pv, pt])
    return training_files
