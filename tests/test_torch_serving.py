"""The serving slice as a whole: the port's SlidingWindowPredictor against
the JAX one on the same params (probabilities within atol 2e-4, label maps
equal away from the threshold), then the port's ``--input`` entry point
against JAX ``predict_case`` on synthetic ellipsoid NIfTI cases: the same
output files and equal label maps. fp32, fold off, on the CPU."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.inference import predict as jax_predict  # noqa: E402
from fetal_mri_segmentation_tpu.inference.labelmaps import (  # noqa: E402
    get_prediction_labels)
from fetal_mri_segmentation_tpu.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor as JaxPredictor)
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.utils.nifti import load_nifti  # noqa: E402
from fetal_mri_segmentation_tpu_torch import predict as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    build_serving_predictor, load_serving_model, preprocess_case)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ATOL = 2e-4
OVERLAP = 4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX model with its params, and the same params as an npz."""
    cfg = Config(image_shape=(20, 24, 28), patch_shape=(16, 16, 16),
                 depth=2, n_base_filters=8, compute_dtype="float32",
                 fold_level0="off")
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 16, 16, 16, 1)))["params"]
    flat = flatten_dict(params, sep="/")
    npz = tmp_path_factory.mktemp("params") / "params.npz"
    np.savez(npz, **flat)
    jax_pred = JaxPredictor(model, cfg, cfg.image_shape, overlap=OVERLAP,
                            patch_batch_size=4)
    return cfg, model, {"params": params}, str(npz), jax_pred


def test_sliding_window_matches_jax(served):
    cfg, _, variables, npz, jax_pred = served
    port = SlidingWindowPredictor(load_serving_model(cfg, npz, "cpu"), cfg,
                                  cfg.image_shape, overlap=OVERLAP,
                                  patch_batch_size=3)
    x = np.random.default_rng(0).normal(size=(1,) + cfg.image_shape)
    x = x.astype(np.float32)
    want = np.asarray(jax_pred(variables, x))
    got = port(x)
    assert got.shape == want.shape == (1,) + cfg.image_shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    far = np.abs(want[0] - 0.5) > ATOL
    labels = port.predict_labels(x)
    assert labels.dtype == np.uint8
    np.testing.assert_array_equal(labels[far],
                                  jax_pred.predict_labels(variables, x)[far])


def test_predict_entry_matches_jax_predict_case(served, tmp_path):
    cfg, model, variables, npz, jax_pred = served
    write_synthetic_dataset(str(tmp_path / "cases"), n_cases=2,
                            shape=(24, 24, 24))
    inputs = [str(tmp_path / "cases" / f"case_{i}") for i in range(2)]
    n = entry.main(cfg, npz, inputs, output_dir=str(tmp_path / "port"),
                   overlap=OVERLAP, patch_batch_size=4, device="cpu",
                   verbose=False)
    assert n == 2
    for path, name in zip(inputs, entry.assign_output_names(inputs)):
        jax_dir, port_dir = tmp_path / "jax" / name, tmp_path / "port" / name
        jax_predict.predict_case(path, str(jax_dir), model, variables, cfg,
                                 predictor=jax_pred, overlap=OVERLAP)
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) \
            == ["data_volume.nii.gz", "prediction.nii.gz", "truth.nii.gz"]
        for fname in os.listdir(jax_dir):
            want = load_nifti(str(jax_dir / fname))
            got = load_nifti(str(port_dir / fname))
            np.testing.assert_array_equal(got.get_fdata(), want.get_fdata())
            np.testing.assert_array_equal(got.affine, want.affine)


def test_output_names_follow_the_predict_py_rule():
    assert entry.assign_output_names(
        ["a/foo.nii.gz", "b/foo.nii", "c/foo_2", "d/foo"]) == [
            "foo", "foo_2", "foo_2_2", "foo_3"]


def test_multiclass_label_map_semantics():
    cfg = Config(image_shape=(12, 12, 12), patch_shape=(8, 8, 8), depth=2,
                 n_base_filters=4, n_labels=3, labels=(1, 2, 4),
                 activation_name="softmax", compute_dtype="float32")
    pred = SlidingWindowPredictor(build_model(cfg, "cpu"), cfg,
                                  cfg.image_shape, overlap=2)
    x = np.random.default_rng(1).normal(size=(1, 12, 12, 12))
    prob = pred(x.astype(np.float32))
    for threshold in (0.0, 0.4):
        np.testing.assert_array_equal(
            pred.predict_labels(x, threshold),
            get_prediction_labels(prob, threshold, cfg.labels))


def test_refusals(served):
    cfg, _, _, npz, _ = served
    model = load_serving_model(cfg, npz, "cpu")
    with pytest.raises(ValueError, match="CUBIC"):
        build_serving_predictor(model, cfg, direct=True, tta="permute")
    with pytest.raises(ValueError, match="TTA mode"):
        build_serving_predictor(model, cfg, tta="rotate")
    pred = build_serving_predictor(model, cfg, overlap=OVERLAP)
    with pytest.raises(ValueError, match="image_shape"):
        pred(np.zeros((1, 8, 8, 8), np.float32))
    global_cfg = Config(normalization="global", image_shape=cfg.image_shape)
    with pytest.raises(ValueError, match="load_global_moments"):
        preprocess_case("unused", global_cfg)
