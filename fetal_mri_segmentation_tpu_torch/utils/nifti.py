"""NIfTI reading and writing: the JAX package's numpy-only
``utils/nifti.py``, imported as it is (it imports no jax)."""

from fetal_mri_segmentation_tpu.utils.nifti import (  # noqa: F401
    NiftiImage, load_nifti, save_nifti)
