"""The port keeps its own copies of the JAX package's numpy-only modules
(``config``, ``utils/nifti.py``, ``utils/io_utils.py``,
``utils/geometry.py``, ``inference/labelmaps.py``,
``utils/surface_metrics.py``, ``data/normalize.py``'s storage passes, the
synthetic cases of ``tests/synthetic.py``, ``data/blosc_compat.py`` and the
Keras readers and layer orders of ``utils/keras_*.py``) so that it imports
nothing of the JAX package. Each copy is held equal to its original here:
the same fields, defaults and loaded configs, the same arrays and affines,
files that either side reads back as the other wrote them."""

import dataclasses
import glob
import os
import warnings
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from fetal_mri_segmentation_tpu import config as jax_config  # noqa: E402
from fetal_mri_segmentation_tpu.inference import (  # noqa: E402
    labelmaps as jax_labelmaps)
from fetal_mri_segmentation_tpu.utils import (  # noqa: E402
    geometry as jax_geometry, io_utils as jax_io, nifti as jax_nifti)
from fetal_mri_segmentation_tpu_torch import config as port_config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.inference import (  # noqa: E402
    labelmaps as port_labelmaps)
from fetal_mri_segmentation_tpu_torch.utils import (  # noqa: E402
    geometry as port_geometry, io_utils as port_io, nifti as port_nifti)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "configs" / "*.json")))


def _shared(d: dict) -> dict:
    """A port config's dict without the port's own fields (``PORT_ONLY``,
    read for the port's own families only)."""
    return {k: v for k, v in d.items() if k not in port_config.PORT_ONLY}


def test_config_fields_and_defaults_equal():
    """The JAX ``Config``'s fields in its order and with its defaults, then
    the port's own (``PORT_ONLY``) at the end."""
    jax_fields = dataclasses.fields(jax_config.Config)
    port_fields = dataclasses.fields(port_config.Config)
    assert [f.name for f in port_fields] == (
        [f.name for f in jax_fields] + list(port_config.PORT_ONLY))
    for a, b in zip(jax_fields, port_fields):
        assert a.default == b.default, a.name
    assert (_shared(dataclasses.asdict(port_config.Config()))
            == dataclasses.asdict(jax_config.Config()))
    assert (port_config.Config(model_name="isensee").depth
            == jax_config.Config(model_name="isensee").depth == 5)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_load_equal(path):
    port = port_config.Config.load(path)
    want = jax_config.Config.load(path)
    assert _shared(dataclasses.asdict(port)) == dataclasses.asdict(want)
    assert port.to_dict() == want.to_dict()


@pytest.mark.parametrize("kw", [
    {"labels": (1, 2), "n_labels": 1}, {"compute_dtype": "float16"},
    {"normalization": "zscore"}, {"fold_level0": (1, 3, 1)},
    {"batch_size": 0}, {"device_case_cache": "On"}])
def test_config_rejects_what_the_original_rejects(kw):
    with pytest.raises(ValueError):
        jax_config.Config(**kw)
    with pytest.raises(ValueError):
        port_config.Config(**kw)


def test_config_round_trips_through_json(tmp_path):
    cfg = port_config.Config(image_shape=(32, 40, 48), depth=3,
                             labels=(1, 4), n_labels=2)
    cfg.save(str(tmp_path / "c.json"))
    # a U-Net's saved config carries none of the port's own fields, so
    # the JAX Config loads it without a warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = jax_config.Config.load(str(tmp_path / "c.json"))
    assert dataclasses.asdict(loaded) == _shared(dataclasses.asdict(cfg))
    assert (dataclasses.asdict(port_config.Config.load(str(tmp_path
                                                           / "c.json")))
            == dataclasses.asdict(cfg))


def _case(shape=(30, 26, 22), seed=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    vol[4:24, 5:20, 3:18] = rng.normal(200, 40, (20, 15, 15))
    truth = (vol > 210).astype(np.float32)
    affine = np.diag([0.8, 1.1, 2.0, 1.0])
    affine[:3, 3] = (-12.0, 3.5, 7.25)
    return vol, truth, affine


@pytest.mark.parametrize("image_shape", [None, (16, 16, 16), (24, 12, 20)])
@pytest.mark.parametrize("crop", [True, False])
def test_process_case_images_equal(image_shape, crop):
    vol, truth, affine = _case()
    out = []
    for mod in (jax_nifti, port_nifti):
        images = [mod.NiftiImage(vol, affine), mod.NiftiImage(truth, affine)]
        geometry = port_geometry if mod is port_nifti else jax_geometry
        out.append(geometry.process_case_images(
            images, image_shape=image_shape, crop=crop, label_indices=[1]))
    for a, b in zip(*out):
        np.testing.assert_array_equal(b.get_fdata(), a.get_fdata())
        np.testing.assert_array_equal(b.affine, a.affine)


def test_geometry_helpers_equal():
    vol, _, affine = _case(seed=1)
    assert (port_geometry.crop_img_to_slices(vol)
            == jax_geometry.crop_img_to_slices(vol))
    np.testing.assert_array_equal(
        port_geometry.zoomed_affine(affine, (30, 26, 22), (16, 16, 16)),
        jax_geometry.zoomed_affine(affine, (30, 26, 22), (16, 16, 16)))
    np.testing.assert_array_equal(port_geometry.ensure_3d(vol[..., None]),
                                  jax_geometry.ensure_3d(vol[..., None]))


@pytest.mark.parametrize("dtype,slope", [
    (np.float32, 1.0), (np.uint8, 1.0), (np.int16, 1.0),
    (np.uint8, 1.0 / 255), (np.uint16, 1.0 / 65535)])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_round_trips_read_by_both(tmp_path, dtype, slope, suffix):
    rng = np.random.default_rng(2)
    data = (rng.random((7, 5, 3)) * 200).astype(dtype)
    affine = np.diag([0.5, 0.75, 1.5, 1.0])
    affine[:3, 3] = (1.0, -2.0, 3.0)
    for i, writer in enumerate((jax_nifti, port_nifti)):
        path = str(tmp_path / f"w{i}{suffix}")
        writer.save_nifti(data, path, affine=affine, scl_slope=slope)
        a, b = jax_nifti.load_nifti(path), port_nifti.load_nifti(path)
        np.testing.assert_array_equal(b.get_fdata(), a.get_fdata())
        assert b.get_fdata().dtype == a.get_fdata().dtype
        np.testing.assert_array_equal(b.affine, a.affine)
        if slope != 1.0:
            np.testing.assert_allclose(b.get_fdata(), data * np.float32(slope),
                                       rtol=1e-6)
    with open(tmp_path / f"w0{suffix}", "rb") as f0, \
            open(tmp_path / f"w1{suffix}", "rb") as f1:
        if suffix == ".nii":
            assert f0.read() == f1.read()


def test_nifti_rejects_what_the_original_rejects(tmp_path):
    bad = tmp_path / "bad.nii.gz"
    import gzip
    with gzip.open(bad, "wb") as f:
        f.write(b"not a nifti")
    for mod in (jax_nifti, port_nifti):
        with pytest.raises(ValueError, match="not a NIfTI"):
            mod.load_nifti(str(bad))


@pytest.mark.parametrize("labels", [(1,), (1, 2, 4), (3, 300)])
def test_labelmaps_equal(labels):
    rng = np.random.default_rng(len(labels))
    prob = rng.random((len(labels), 6, 5, 4)).astype(np.float32)
    for threshold in (0.0, 0.5, 0.9):
        np.testing.assert_array_equal(
            port_labelmaps.get_prediction_labels(prob, threshold, labels),
            jax_labelmaps.get_prediction_labels(prob, threshold, labels))
    assert (port_labelmaps.label_map_dtype(labels)
            == jax_labelmaps.label_map_dtype(labels))
    for label_map in (False, True):
        a = jax_labelmaps.prediction_to_image(prob, np.eye(4), label_map,
                                              labels=labels)
        b = port_labelmaps.prediction_to_image(prob, np.eye(4), label_map,
                                               labels=labels)
        np.testing.assert_array_equal(b.dataobj, a.dataobj)
        assert b.dataobj.dtype == a.dataobj.dtype


@pytest.mark.parametrize("path", ["a/scan.nii.gz", "b/scan.nii",
                                  "c/scan.nii.gz.bak", "d/case_7/",
                                  "e/x.nii.gz.nii"])
def test_case_names_equal(path):
    assert (port_io.case_name_from_path(path)
            == jax_io.case_name_from_path(path))


def test_pickle_and_json_helpers_interchange(tmp_path):
    port_io.pickle_dump([3, 1, 2], str(tmp_path / "p.pkl"))
    assert jax_io.pickle_load(str(tmp_path / "p.pkl")) == [3, 1, 2]
    jax_io.pickle_dump({"a": 1}, str(tmp_path / "q.pkl"))
    assert port_io.pickle_load(str(tmp_path / "q.pkl")) == {"a": 1}
    port_io.atomic_json_dump({"x": [1, 2]}, str(tmp_path / "s.json"))
    import json
    with open(tmp_path / "s.json") as f:
        assert json.load(f) == {"x": [1, 2]}
    assert [p.name for p in tmp_path.iterdir()
            if p.suffix == ".tmp"] == []


def test_surface_metrics_source_equals_original():
    """``utils/surface_metrics.py`` is a copy: below the module docstring
    the two files are the same text."""
    def body(path):
        text = Path(path).read_text()
        return text[text.index("from __future__"):]
    assert (body(ROOT / "fetal_mri_segmentation_tpu_torch" / "utils"
                 / "surface_metrics.py")
            == body(ROOT / "fetal_mri_segmentation_tpu" / "utils"
                    / "surface_metrics.py"))


def test_surface_metrics_equal():
    from fetal_mri_segmentation_tpu.utils import surface_metrics as jax_sm
    from fetal_mri_segmentation_tpu_torch.utils import (
        surface_metrics as port_sm)
    vol, truth, affine = _case()
    pred = np.roll(truth, 2, axis=1)
    spacing = port_sm.voxel_spacing_from_affine(affine)
    assert spacing == jax_sm.voxel_spacing_from_affine(affine)
    assert (port_sm.surface_metric_pair(truth > 0, pred > 0, spacing)
            == jax_sm.surface_metric_pair(truth > 0, pred > 0, spacing))


@pytest.mark.parametrize("name", [
    "normalize_data", "normalize_data_storage",
    "normalize_data_storage_per_volume", "normalize_data_storage_windowed",
    "window_intensities", "normalize_case"])
def test_normalize_source_equals_original(name):
    """Each function of the port's ``data/normalize.py`` has its
    original's code (comments and docstrings aside)."""
    import ast
    import inspect

    from fetal_mri_segmentation_tpu.data import normalize as jax_norm
    from fetal_mri_segmentation_tpu_torch.data import (
        normalize as port_norm)

    def code(fn):
        tree = ast.parse(inspect.getsource(fn))
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                body.pop(0)  # the docstring
        return ast.dump(tree)
    assert code(getattr(port_norm, name)) == code(getattr(jax_norm, name))


@pytest.mark.parametrize("modalities", [("volume",), ("t2", "adc")])
def test_synthetic_cases_equal(tmp_path, modalities):
    from fetal_mri_segmentation_tpu_torch.data import synthetic as port_syn
    from tests import synthetic as test_syn
    for seed in range(3):
        for a, b in zip(port_syn.make_ellipsoid_case((12, 14, 10), seed),
                        test_syn.make_ellipsoid_case((12, 14, 10), seed)):
            np.testing.assert_array_equal(a, b)
    got = port_syn.write_synthetic_dataset(str(tmp_path / "port"), 2,
                                           (12, 12, 12), modalities)
    want = test_syn.write_synthetic_dataset(str(tmp_path / "test"), 2,
                                            (12, 12, 12), modalities)
    assert ([[os.path.relpath(f, tmp_path / "port") for f in c] for c in got]
            == [[os.path.relpath(f, tmp_path / "test") for f in c]
                for c in want])
    for case_got, case_want in zip(got, want):
        for f, g in zip(case_got, case_want):
            a, b = port_nifti.load_nifti(f), jax_nifti.load_nifti(g)
            np.testing.assert_array_equal(a.get_fdata(), b.get_fdata())
            np.testing.assert_array_equal(a.affine, b.affine)


@pytest.mark.parametrize("shape", [(12, 14, 10), (16, 16, 16)])
def test_multiclass_cases_equal(tmp_path, shape):
    from fetal_mri_segmentation_tpu_torch.data import synthetic as port_syn
    from tests import synthetic as test_syn
    for seed in range(3):
        got = port_syn.make_multiclass_case(shape, seed)
        want = test_syn.make_multiclass_case(shape, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert set(np.unique(got[1])) <= {0, 1, 2, 4}
    got = port_syn.write_multiclass_dataset(str(tmp_path / "port"), 2, shape)
    want = test_syn.write_multiclass_dataset(str(tmp_path / "test"), 2, shape)
    assert ([[os.path.relpath(f, tmp_path / "port") for f in c] for c in got]
            == [[os.path.relpath(f, tmp_path / "test") for f in c]
                for c in want])
    for case_got, case_want in zip(got, want):
        for f, g in zip(case_got, case_want):
            a, b = port_nifti.load_nifti(f), jax_nifti.load_nifti(g)
            np.testing.assert_array_equal(a.get_fdata(), b.get_fdata())
            np.testing.assert_array_equal(a.affine, b.affine)


# (port module, JAX module, names) of the interop code copied verbatim; the
# functions adapted to the port are held to their originals' results in
# tests/test_torch_keras.py and test_torch_blosc.py
VERBATIM = [
    ("data.blosc_compat", "data.blosc_compat",
     ("_libblosc", "blosc_available", "blosc_decompress", "blosc_compress",
      "dataset_filters", "is_unreadable_blosc", "_filter_registered",
      "BloscDataset")),
    ("utils.keras_import", "utils.keras_import",
     ("keras_weight_list_from_model", "keras_weight_list_from_h5",
      "_unet_param_order", "_is_norm", "_is_conv", "_isensee_param_order")),
    ("utils.keras_export", "utils.keras_export",
     ("_weighted_layers", "_set_weights")),
    ("utils.keras_opt", "utils.keras_opt",
     ("AdamSlots", "_names_from_group", "keras_adam_slots_from_h5",
      "keras_adam_slots_from_model", "slots_as_weight_list")),
    ("utils.keras_migrate", "utils.keras_migrate",
     ("read_keras_model_config", "read_keras_training_lr", "_layer_seq",
      "_is_instance_like", "derive_arch_from_model_config",
      "derive_arch_from_weight_list")),
]


@pytest.mark.parametrize("port,original,name", [
    (p, o, n) for p, o, names in VERBATIM for n in names],
    ids=lambda v: v if isinstance(v, str) else None)
def test_interop_source_equals_original(port, original, name):
    """Each verbatim copy of the interop modules has the original's code
    (docstrings aside), and the constants they read are equal."""
    import ast
    import importlib
    import inspect

    got = importlib.import_module(f"fetal_mri_segmentation_tpu_torch.{port}")
    want = importlib.import_module(f"fetal_mri_segmentation_tpu.{original}")

    def code(obj):
        obj = inspect.unwrap(obj)
        tree = ast.parse(inspect.getsource(obj))
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                body.pop(0)  # the docstring
        return ast.dump(tree)
    assert code(getattr(got, name)) == code(getattr(want, name))
    for const in ("BLOSC_FILTER_ID", "_NORM_CLASSES"):
        if hasattr(want, const):
            assert getattr(got, const) == getattr(want, const)


def test_native_source_equals_original():
    """The port builds its host library from its own copy of
    ``native/fastloader.cpp``: a comment header naming the original, then
    that file byte for byte."""
    port = (ROOT / "fetal_mri_segmentation_tpu_torch" / "native"
            / "fastloader.cpp").read_text()
    original = (ROOT / "native" / "fastloader.cpp").read_text()
    assert port.endswith(original)
    header = port[:len(port) - len(original)].splitlines()
    assert header and all(line.startswith("//") for line in header)
    assert "native/fastloader.cpp" in header[0]


def test_fold_constants_equal_original():
    """``FOLD_AUTO``, the fold's tap-routing tables and the dilated form's
    tap-spread matrix, and the fold's factor check and parity order, equal
    the JAX package's."""
    from fetal_mri_segmentation_tpu.models import layers as jax_layers
    from fetal_mri_segmentation_tpu.ops import fold as jax_fold
    from fetal_mri_segmentation_tpu_torch.models import layers as port_layers
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as port_dec0
    from fetal_mri_segmentation_tpu_torch.ops import fold as port_fold

    assert port_layers.FOLD_AUTO == jax_layers.FOLD_AUTO
    assert port_dec0._DILATE_M == jax_layers._DILATE_M
    for table in ("_T_FOLDED", "_T_UNFOLDED", "_T_STRIDE2"):
        np.testing.assert_array_equal(getattr(port_fold, table),
                                      getattr(jax_fold, table))
    for factors in [(1, 1, 1), (2, 2, 2), (1, 2, 1), [2, 1, 2]]:
        assert (port_fold._check_factors(factors)
                == jax_fold._check_factors(factors))
        f = tuple(factors)
        assert port_fold._parities(f) == jax_fold._parities(f)


def test_bench_copies_name_their_original():
    """The port's bench keeps its own copies of the root ``bench.py``'s
    constants and ``_make_batch`` (that file imports JAX in every row): the
    module's header names them, and they equal the originals."""
    import importlib.util

    from fetal_mri_segmentation_tpu_torch import bench as port_bench

    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    header = port_bench.__doc__.split("Copies of root ``bench.py``")[1]
    for name in ("PATCH", "VOLUME", "OVERLAP", "TRAIN_PATCHES_PER_VOLUME"):
        assert f"``{name}``" in header
        assert getattr(port_bench, name) == getattr(root_bench, name)
    assert "``_make_batch``" in header and "bench.py:45" in header
    assert port_bench._make_batch.__doc__.startswith(
        "Copy of root ``bench.py::_make_batch``")
    for got, want in zip(port_bench._make_batch(np.random.default_rng(3)),
                         root_bench._make_batch(np.random.default_rng(3))):
        np.testing.assert_array_equal(got, want)


# the plain Swin UNETR reference at the repository's root and its copy in
# the benchmark's family file, which may not import it
SWIN_SHARED = ("param_spec", "up_blocks", "window_and_shift",
               "relative_position_index", "window_partition",
               "window_reverse", "shift_mask", "layer_norm", "linear",
               "attention", "swin_block", "merge", "encoder", "res_block",
               "up_block", "forward")


def _swin_family():
    from perfbench.families import family

    return family({"model_name": "swin_unetr"})


def test_swin_family_source_copies_the_reference():
    import inspect

    from reference import swin_unetr as ref

    fam = _swin_family()
    for name in SWIN_SHARED:
        assert (inspect.getsource(getattr(fam, name))
                == inspect.getsource(getattr(ref, name))), name
    for name in ("WINDOW", "PATCH", "DEPTHS", "HEADS", "MLP_RATIO", "LN_EPS",
                 "IN_EPS", "SLOPE", "MERGE_OFFSETS"):
        assert getattr(fam, name) == getattr(ref, name), name


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "float8"])
def test_swin_family_forward_equals_the_reference(quant):
    """The family's forward and the reference's on the benchmark's seeded
    weights (``perfbench/inputs.py::make_weights``), plain and with the
    float8 control's rounding: equal bit for bit."""
    import torch

    from perfbench import inputs
    from perfbench.reference.models import quantize_fp8
    from reference import swin_unetr as ref

    cfg = {"model_name": "swin_unetr", "n_base_filters": 12, "n_labels": 1,
           "compute_dtype": "float32"}
    w = inputs.make_weights(cfg, 2 ** 31 + 5, "cpu")
    x = torch.randn((1, 1, 32, 32, 32),
                    generator=torch.Generator().manual_seed(3))
    q = quantize_fp8 if quant else None
    with torch.no_grad():
        got = _swin_family().forward(w, x, cfg, q)
        want = ref.forward(w, x, cfg, q)
    assert torch.equal(got, want)


# the plain MedNeXt reference at the repository's root and its copy in the
# benchmark's family file, which may not import it
MEDNEXT_SHARED = ("tables", "param_spec", "conv", "group_norm", "block",
                  "run_block", "network")
MEDNEXT_CFG = {"model_name": "mednext", "n_base_filters": 8, "n_labels": 1,
               "mednext_size": "L", "mednext_kernel": 5,
               "compute_dtype": "float32"}


def _mednext_family():
    from perfbench.families import family

    return family({"model_name": "mednext"})


def test_mednext_family_source_copies_the_reference():
    import inspect

    from reference import mednext as ref

    fam = _mednext_family()
    for name in MEDNEXT_SHARED:
        assert (inspect.getsource(getattr(fam, name))
                == inspect.getsource(getattr(ref, name))), name
    for name in ("SIZES", "GN_EPS", "LEVELS", "UP_PAD"):
        assert getattr(fam, name) == getattr(ref, name), name


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "float8"])
def test_mednext_family_forward_equals_the_reference(quant):
    """The family's forward and the reference's on the benchmark's seeded
    weights (``perfbench/inputs.py::make_weights``), plain and with the
    float8 control's rounding (operands e4m3, each conv's output gradient
    e5m2): logits and every leaf's gradient equal bit for bit."""
    import torch

    from perfbench import inputs
    from perfbench.reference.models import _GradFP8, quantize_fp8
    from reference import mednext as ref

    w = inputs.make_weights(MEDNEXT_CFG, 2 ** 31 + 5, "cpu")
    x = torch.randn((1, 1, 32, 32, 32),
                    generator=torch.Generator().manual_seed(3))
    runs = []
    for forward, grad in ((_mednext_family().forward, None),
                          (ref.forward, _GradFP8.apply if quant else None)):
        p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        kw = {} if forward is not ref.forward else {"grad": grad}
        out = forward(p, x, MEDNEXT_CFG, quantize_fp8 if quant else None,
                      **kw)
        grads = torch.autograd.grad(out.square().mean(), list(p.values()))
        runs.append((out.detach(), grads))
    (got, got_g), (want, want_g) = runs
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
