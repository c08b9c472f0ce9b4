"""The port's copies of the patch-grid and normalization functions equal
the JAX package's originals (same numpy code: exact equality)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu.data import normalize as jax_norm  # noqa: E402
from fetal_mri_segmentation_tpu.ops import patches as jax_patches  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data import normalize  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import patches  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("image_shape,patch_size,overlap,start", [
    ((128, 128, 128), (64, 64, 64), 16, None),
    ((24, 30, 17), (16, 16, 8), (4, 2, 0), None),
    ((40, 40, 40), (16, 16, 16), 0, 5),
    ((10, 12, 14), (16, 16, 16), 4, (1, 2, 3)),
])
def test_compute_patch_indices_equal(image_shape, patch_size, overlap, start):
    np.testing.assert_array_equal(
        patches.compute_patch_indices(image_shape, patch_size, overlap, start),
        jax_patches.compute_patch_indices(image_shape, patch_size, overlap,
                                          start))


def test_compute_patch_indices_rejects_overlap_as_large_as_patch():
    with pytest.raises(ValueError, match="smaller than the patch"):
        patches.compute_patch_indices((32,) * 3, (16,) * 3, 16)


@pytest.mark.parametrize("start,stop,step", [
    ((-16, -16, -16), (112, 112, 112), (48, 48, 48)),
    ((0, 2, -3), (9, 20, 7), (3, 5, 2)),
])
def test_get_set_of_patch_indices_equal(start, stop, step):
    args = [np.asarray(a) for a in (start, stop, step)]
    np.testing.assert_array_equal(patches.get_set_of_patch_indices(*args),
                                  jax_patches.get_set_of_patch_indices(*args))


@pytest.mark.parametrize("shape,sigma_scale", [
    ((64, 64, 64), 0.125), ((16, 8, 12), 0.25), ((5, 1, 7), 0.125)])
def test_gaussian_importance_map_equal(shape, sigma_scale):
    np.testing.assert_array_equal(
        patches.gaussian_importance_map(shape, sigma_scale),
        jax_patches.gaussian_importance_map(shape, sigma_scale))


def _case(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, 50.0, size=(2, 8, 9, 10))
            + rng.normal(0, 5, size=(2, 8, 9, 10))).astype(np.float32)


@pytest.mark.parametrize("mode,moments", [
    ("per_volume", None), ("windowed", None), ("none", None), (None, None),
    ("global", ((3.0, 7.0), (2.0, 0.0)))])
def test_normalize_case_equal(mode, moments):
    mean, std = moments if moments else (None, None)
    np.testing.assert_array_equal(
        normalize.normalize_case(_case(), mode, mean=mean, std=std),
        jax_norm.normalize_case(_case(), mode, mean=mean, std=std))


def test_normalize_case_global_without_moments_raises():
    with pytest.raises(ValueError, match="mean, std"):
        normalize.normalize_case(_case(), "global")


@pytest.mark.parametrize("lo,hi", [(1.0, 99.0), (5.0, 90.0)])
def test_window_intensities_equal(lo, hi):
    np.testing.assert_array_equal(
        normalize.window_intensities(_case(1), lo, hi),
        jax_norm.window_intensities(_case(1), lo, hi))


def test_normalize_data_equal_with_zero_std():
    args = (_case(2), np.array([1.0, -2.0]), np.array([0.0, 3.0]))
    np.testing.assert_array_equal(normalize.normalize_data(*args),
                                  jax_norm.normalize_data(*args))
