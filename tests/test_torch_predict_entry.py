"""The port's ``--input`` surface on the CPU: ``predict_cases_pipelined``
writes the same trees as ``predict_case`` case by case (label and
probability maps, every transfer dtype), ``python -m
fetal_mri_segmentation_tpu_torch.predict``'s ``main`` against the root
``predict.py``'s on the same synthetic NIfTI cases and weights (identical
label maps except voxels within 1e-3 of the threshold; probability maps
within the model tolerance), the flag validation of the root entry point
and the port's refusals, and the card as the default device."""

import gzip
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu_torch import predict as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    build_serving_predictor, make_device_preprocessor, predict_case,
    predict_cases_pipelined, resolve_tta)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-4


def _tree(directory):
    return {f: load_nifti(os.path.join(directory, f))
            for f in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipelined")
    write_synthetic_dataset(str(d / "in"), n_cases=3, shape=(26, 28, 24))
    cfg = Config(image_shape=(24, 24, 24), patch_shape=(16, 16, 16),
                 depth=3, n_base_filters=4, compute_dtype="float32")
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    paths = [str(d / "in" / f"case_{i}") for i in range(3)]
    return d, cfg, model, paths


@pytest.mark.parametrize("direct,device_pre", [(False, False), (True, True)])
@pytest.mark.parametrize("prob", [None, "float32", "float16", "uint8",
                                  "uint16"])
def test_pipelined_writes_the_sequential_trees(cases, direct, device_pre,
                                               prob):
    d, cfg, model, paths = cases
    predictor = build_serving_predictor(model, cfg, direct=direct,
                                        overlap=4)
    pre = make_device_preprocessor(model, cfg) if device_pre else None
    tag = f"{direct}-{device_pre}-{prob}"
    n = predict_cases_pipelined(
        [(p, str(d / f"pipe_{tag}" / Path(p).name)) for p in paths],
        predictor, cfg, device_pre=pre, verbose=False,
        output_label_map=prob is None, prob_dtype=prob or "float32")
    assert n == 3
    for p in paths:
        seq_dir = d / f"seq_{tag}" / Path(p).name
        predict_case(p, str(seq_dir), predictor, cfg, device_pre=pre,
                     output_label_map=prob is None)
        got = _tree(d / f"pipe_{tag}" / Path(p).name)
        want = _tree(seq_dir)
        assert sorted(got) == sorted(want) == [
            "data_volume.nii.gz", "prediction.nii.gz", "truth.nii.gz"]
        for f in got:
            np.testing.assert_array_equal(got[f].affine, want[f].affine)
            tol = {"float16": 4.9e-4, "uint8": 0.5 / 255 + 1e-7,
                   "uint16": 0.5 / 65535 + 1e-7}.get(prob, 0.0)
            if f != "prediction.nii.gz" or not tol:
                np.testing.assert_array_equal(got[f].get_fdata(),
                                              want[f].get_fdata())
            else:
                np.testing.assert_allclose(got[f].get_fdata(),
                                           want[f].get_fdata(), atol=tol)
        if prob in ("uint8", "uint16"):  # integers on disk, scl_slope set
            assert got["prediction.nii.gz"].dataobj.dtype == np.float32
            with gzip.open(d / f"pipe_{tag}" / Path(p).name
                           / "prediction.nii.gz", "rb") as f:
                raw = f.read(72)
            assert np.frombuffer(raw[70:72], "<i2")[0] == {
                "uint8": 2, "uint16": 512}[prob]


def test_pipeline_keeps_the_cases_before_a_failing_one(cases, tmp_path):
    d, cfg, model, paths = cases
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "volume.nii").write_bytes(b"not a nifti")
    predictor = build_serving_predictor(model, cfg, overlap=4)
    with pytest.raises(ValueError, match="NIfTI"):
        predict_cases_pipelined(
            [(paths[0], str(tmp_path / "a")), (str(bad), str(tmp_path / "b"))],
            predictor, cfg, verbose=False)
    assert (tmp_path / "a" / "prediction.nii.gz").exists()


def _load_root(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """Synthetic cases, a JAX checkpoint, and the same weights as an npz."""
    import jax
    from flax.traverse_util import flatten_dict

    from fetal_mri_segmentation_tpu.config import Config as JaxConfig
    from fetal_mri_segmentation_tpu.models import build_model as jax_build
    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO

    d = tmp_path_factory.mktemp("predict_main")
    write_synthetic_dataset(str(d / "in"), n_cases=2, shape=(24, 26, 28))
    cfg = JaxConfig(image_shape=(24, 24, 24), patch_shape=(16, 16, 16),
                    depth=3, n_base_filters=4, compute_dtype="float32",
                    fold_level0="off", validation_patch_overlap=4,
                    data_file=str(d / "none.h5"),
                    model_file=str(d / "ckpt"))
    state = create_train_state(jax_build(cfg), cfg, jax.random.PRNGKey(1))
    CheckpointIO(cfg.model_file).save(state, epoch=1, best_val=-0.5)
    np.savez(d / "params.npz", **flatten_dict(state.params, sep="/"))
    return d, cfg, [str(d / "in" / f"case_{i}") for i in range(2)]


@pytest.mark.parametrize("flags", [
    {}, {"direct": True, "tta": "permute"},
    {"tta": "flips", "device_preprocess": True}],
    ids=["sliding", "direct-permute", "sliding-flips-device-pre"])
def test_predict_main_matches_root_predict(experiment, monkeypatch, flags):
    d, cfg, inputs = experiment
    monkeypatch.setenv("FETAL_TPU_NO_CACHE", "1")
    root = _load_root("predict")
    tag = "-".join(f"{k}{v}" for k, v in sorted(flags.items())) or "plain"
    outs = {}
    for prob in (False, True):
        jax_dir, port_dir = d / f"jax_{tag}_{prob}", d / f"port_{tag}_{prob}"
        root.main(cfg, output_dir=str(jax_dir), inputs=inputs, prob_map=prob,
                  **flags)
        n = entry.main(cfg, str(d / "params.npz"), inputs,
                       output_dir=str(port_dir), device="cpu",
                       verbose=False, prob_map=prob, **flags)
        assert n == 2
        outs[prob] = (jax_dir, port_dir)
    for name in entry.assign_output_names(inputs):
        (jl, pl), (jp, pp) = outs[False], outs[True]
        want_p = load_nifti(str(jp / name / "prediction.nii.gz")).get_fdata()
        got_p = load_nifti(str(pp / name / "prediction.nii.gz")).get_fdata()
        np.testing.assert_allclose(got_p, want_p, atol=ATOL)
        want = load_nifti(str(jl / name / "prediction.nii.gz"))
        got = load_nifti(str(pl / name / "prediction.nii.gz"))
        far = np.abs(want_p - 0.5) > 1e-3
        np.testing.assert_array_equal(got.get_fdata()[far],
                                      want.get_fdata()[far])
        np.testing.assert_array_equal(got.affine, want.affine)
        assert sorted(os.listdir(pl / name)) == sorted(os.listdir(jl / name))


def test_predict_main_uint8_probabilities_match_root(experiment, monkeypatch):
    d, cfg, inputs = experiment
    monkeypatch.setenv("FETAL_TPU_NO_CACHE", "1")
    _load_root("predict").main(cfg, output_dir=str(d / "jax_u8"),
                               inputs=inputs, prob_map=True,
                               prob_dtype="uint8")
    entry.main(cfg, str(d / "params.npz"), inputs,
               output_dir=str(d / "port_u8"), device="cpu", verbose=False,
               prob_map=True, prob_dtype="uint8")
    for name in entry.assign_output_names(inputs):
        want = load_nifti(str(d / "jax_u8" / name / "prediction.nii.gz"))
        got = load_nifti(str(d / "port_u8" / name / "prediction.nii.gz"))
        # one quantization step where the two models' probabilities fall
        # on opposite sides of a rounding boundary
        np.testing.assert_allclose(got.get_fdata(), want.get_fdata(),
                                   atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("kwargs,error,match", [
    ({"prob_dtype": "uint8"}, ValueError, "--prob-map"),
    ({"inputs": None, "device_preprocess": True}, ValueError,
     "--device-preprocess"),
    ({"prob_map": True, "export_path": "x"}, ValueError, "not exportable"),
    ({"num_devices": 2}, ValueError, "single-device"),
    # several devices on the validation-set path are ported: the weights
    # are looked for before any rank starts; both meshes at once refuse
    ({"inputs": None, "num_devices": 2}, FileNotFoundError,
     "--params PARAMS.npz"),
    ({"inputs": None, "spatial_devices": 2, "num_devices": 2}, ValueError,
     "mutually exclusive"),
    # --export and --from-keras are ported (tests/test_torch_export.py,
    # test_torch_keras.py): they look for their weights, the .npz or the
    # .h5, before anything else
    ({"export_path": "x"}, FileNotFoundError, "unused.npz"),
    ({"from_keras": "m.h5"}, FileNotFoundError, "m.h5"),
    # the validation-set path is ported: with no weights at either place
    # it names both ways to get them
    ({"inputs": None}, FileNotFoundError, "--params PARAMS.npz"),
])
def test_predict_flag_validation(kwargs, error, match):
    kwargs = {"inputs": ["case"], **kwargs}
    cfg = Config(depth=2, n_base_filters=4)
    with pytest.raises(error, match=match):
        entry.main(cfg, "unused.npz", kwargs.pop("inputs"), device="cpu",
                   **kwargs)


def test_predict_cli_parses_the_new_flags():
    args = entry._parser().parse_args([
        "--config", "c.json", "--params", "p.npz", "--input", "a", "b",
        "--direct", "--tta-mode", "flips", "--device-preprocess",
        "--prob-map", "--prob-dtype", "uint16"])
    assert args.input == ["a", "b"] and args.direct
    assert resolve_tta(args.tta, args.tta_mode) == "flips"
    assert resolve_tta(True, None) == "permute"
    assert resolve_tta(False, None) is False
    assert (args.device_preprocess, args.prob_map, args.prob_dtype,
            args.device) == (True, True, "uint16", "cuda")


def test_the_card_is_the_default_device(experiment):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    d, cfg, inputs = experiment
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(Config(depth=2, n_base_filters=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main(cfg, str(d / "params.npz"), inputs,
                   output_dir=str(d / "nocuda"))
