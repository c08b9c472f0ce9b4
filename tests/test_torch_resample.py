"""On-device ingest of the port (``ops/resample.py``) against the JAX
package's ``ops/resample.py`` and the scipy host oracle, on the CPU:
``resample_3d`` against JAX at 1e-5 and against ``ndimage.zoom(grid_mode=
True)`` at atol 2e-3, rtol 1e-4 (the JAX tests' bound); the
``DevicePreprocessor`` against the JAX one for every normalization mode;
``preprocess_case(device_pre=...)`` against the host path at atol 5e-3,
rtol 1e-3 with the affine at 1e-9, as the JAX tests hold theirs."""

import numpy as np
import pytest
from scipy import ndimage

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.data.normalize import (  # noqa: E402
    normalize_case as jax_normalize_case)
from fetal_mri_segmentation_tpu.ops import resample as jax_resample  # noqa: E402
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    make_device_preprocessor, preprocess_case)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops.resample import (  # noqa: E402
    BUCKET_STEP, DevicePreprocessor, _percentiles, bucket_shape, resample_3d)
from fetal_mri_segmentation_tpu_torch.utils.nifti import save_nifti  # noqa: E402

torch.set_num_threads(1)

SHAPES = [
    ((37, 52, 41), (32, 32, 32)),    # downscale, anisotropic
    ((20, 20, 20), (64, 48, 32)),    # upscale, anisotropic out
    ((64, 64, 64), (32, 32, 32)),    # exact 2x down (half-point coords)
    ((16, 16, 16), (16, 16, 16)),    # identity
    ((100, 80, 60), (64, 64, 64)),
    ((1, 5, 2), (4, 4, 4)),          # one-voxel axis
]


def _padded(a):
    p = np.zeros(bucket_shape(a.shape), np.float32)
    p[:a.shape[0], :a.shape[1], :a.shape[2]] = a
    return p


def _scipy_zoom(a, out_shape, order):
    z = np.asarray(out_shape) / np.asarray(a.shape, dtype=np.float64)
    return ndimage.zoom(a, z, order=order, mode="nearest", grid_mode=True,
                        prefilter=False)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("in_shape,out_shape", SHAPES)
def test_resample_matches_jax_and_scipy(in_shape, out_shape, order):
    rng = np.random.default_rng(sum(in_shape) + order)
    a = (rng.normal(size=in_shape).astype(np.float32) * 100 if order
         else rng.integers(0, 4, size=in_shape).astype(np.float32))
    p = _padded(a)
    got = resample_3d(torch.from_numpy(p)[None], in_shape, out_shape,
                      order)[0].numpy()
    want = np.asarray(jax_resample.resample_3d(
        jnp.asarray(p)[None], jnp.asarray(in_shape), out_shape, order)[0])
    assert got.shape == tuple(out_shape)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ref = _scipy_zoom(a, out_shape, order)
    if order:
        np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-4)
    else:
        np.testing.assert_array_equal(got, ref)


def test_padding_is_invisible():
    a = np.random.default_rng(0).normal(size=(30, 30, 30)).astype(np.float32)
    small = torch.zeros(1, 32, 32, 32)
    small[0, :30, :30, :30] = torch.from_numpy(a)
    big = torch.zeros(1, 64, 48, 32)
    big[0, :30, :30, :30] = torch.from_numpy(a)
    np.testing.assert_array_equal(
        resample_3d(small, a.shape, (24, 24, 24)).numpy(),
        resample_3d(big, a.shape, (24, 24, 24)).numpy())


def test_bucket_shape():
    assert bucket_shape((1, 16, 17)) == (BUCKET_STEP, 16, 32)
    assert bucket_shape((1, 16, 17)) == jax_resample.bucket_shape((1, 16, 17))


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_percentiles_follow_numpy_linear(n):
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    got = _percentiles(torch.from_numpy(x), (1.0, 50.0, 99.0)).numpy()
    np.testing.assert_allclose(got, np.percentile(x, [1, 50, 99], axis=1),
                               rtol=1e-6, atol=1e-6)


MOMENTS = ((np.float32(290.0), np.float32(310.0)),
           (np.float32(75.0), np.float32(85.0)))


@pytest.mark.parametrize("mode", ["per_volume", "global", "windowed", "none"])
def test_preprocessor_matches_jax_and_host(mode):
    rng = np.random.default_rng(7)
    vols = [rng.normal(loc=300, scale=80, size=(41, 37, 29)).astype(
        np.float32) for _ in range(2)]
    out_shape = (32, 32, 32)
    moments = MOMENTS if mode == "global" else None
    got = DevicePreprocessor(out_shape, mode, moments=moments,
                             device="cpu")(vols)
    assert got.shape == (2,) + out_shape and got.dtype == torch.float32
    want = np.asarray(jax_resample.DevicePreprocessor(
        out_shape, mode, moments=moments)(vols))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    host = np.stack([_scipy_zoom(v, out_shape, 1) for v in vols])
    ref = jax_normalize_case(host, mode,
                             mean=MOMENTS[0] if mode == "global" else None,
                             std=MOMENTS[1] if mode == "global" else None)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-3, rtol=1e-3)


def test_preprocessor_bf16_staging_stays_within_bf16_rounding():
    vols = [np.random.default_rng(11).normal(loc=300, scale=80, size=(
        41, 37, 29)).astype(np.float32)]
    f32 = DevicePreprocessor((32, 32, 32), "per_volume", device="cpu")(vols)
    b16 = DevicePreprocessor((32, 32, 32), "per_volume", device="cpu",
                             transfer_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)(vols)
    assert b16.dtype == torch.bfloat16
    err = (b16.float() - f32).abs()
    assert err.max() / f32.std() < 5e-2
    assert err.mean() / f32.std() < 1e-2


def test_preprocessor_refusals():
    pre = DevicePreprocessor((8, 8, 8), "per_volume", device="cpu")
    with pytest.raises(ValueError, match="share the crop shape"):
        pre([np.zeros((10, 10, 10), np.float32),
             np.zeros((10, 10, 9), np.float32)])
    with pytest.raises(ValueError, match="mean, std"):
        DevicePreprocessor((8, 8, 8), "global", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePreprocessor((8, 8, 8), "per_volume")


def _write_case(case, shape=(48, 40, 36), modalities=("t2",), seed=3):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    vol[8:40, 6:34, 5:30] = rng.normal(loc=200, scale=50, size=(32, 28, 25))
    affine = np.diag([1.0, 1.2, 0.9, 1.0])
    affine[:3, 3] = (-10, 4, 2)
    case.mkdir()
    for i, m in enumerate(modalities):
        save_nifti(vol * (1 + 0.5 * i) + 10 * i, str(case / f"{m}.nii.gz"),
                   affine=affine)
    save_nifti((vol > 220).astype(np.float32), str(case / "truth.nii.gz"),
               affine=affine)


@pytest.mark.parametrize("modalities,mode", [
    (("t2",), "per_volume"), (("t1", "t2"), "per_volume"),
    (("t2",), "windowed"), (("t2",), "global")])
def test_preprocess_case_device_matches_host(tmp_path, modalities, mode):
    _write_case(tmp_path / "case", modalities=modalities)
    cfg = Config(image_shape=(32, 32, 32), all_modalities=modalities,
                 normalization=mode)
    moments = MOMENTS if mode == "global" else None
    host, host_aff, host_truth = preprocess_case(
        str(tmp_path / "case"), cfg, global_moments=moments)
    pre = DevicePreprocessor(cfg.image_shape, mode, moments=moments,
                             device="cpu")
    dev, dev_aff, dev_truth = preprocess_case(
        str(tmp_path / "case"), cfg, global_moments=moments, device_pre=pre)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_allclose(dev.numpy(), host, atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(dev_aff, host_aff, atol=1e-9)
    np.testing.assert_array_equal(dev_truth.get_fdata(),
                                  host_truth.get_fdata())


def test_preprocess_case_device_refusals(tmp_path):
    _write_case(tmp_path / "case")
    cfg = Config(image_shape=(16, 16, 16), all_modalities=("t2",))
    with pytest.raises(ValueError, match="normalization"):
        preprocess_case(str(tmp_path / "case"), cfg,
                        device_pre=DevicePreprocessor(
                            cfg.image_shape, "windowed", device="cpu"))
    gcfg = Config(image_shape=(16, 16, 16), all_modalities=("t2",),
                  normalization="global")
    pre = DevicePreprocessor(gcfg.image_shape, "global", moments=MOMENTS,
                             device="cpu")
    with pytest.raises(ValueError, match="moments differ"):
        preprocess_case(str(tmp_path / "case"), gcfg, device_pre=pre,
                        global_moments=((1.0, 1.0), (2.0, 2.0)))


def test_make_device_preprocessor_follows_the_model():
    for dtype, want in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        cfg = Config(image_shape=(16, 16, 16), depth=2, n_base_filters=4,
                     compute_dtype=dtype)
        pre = make_device_preprocessor(build_model(cfg, "cpu"), cfg)
        assert pre._dtype == pre._transfer_dtype == want
        assert pre.device.type == "cpu"
    gcfg = Config(image_shape=(16, 16, 16), depth=2, n_base_filters=4,
                  normalization="global")
    model = build_model(gcfg, "cpu")
    # no moments handed in and no dataset at config.data_file to read them
    with pytest.raises(ValueError, match="load_global_moments"):
        make_device_preprocessor(model, gcfg)
    assert make_device_preprocessor(model, gcfg, moments=(12.5, 3.25)
                                    )._host_moments == (12.5, 3.25)
