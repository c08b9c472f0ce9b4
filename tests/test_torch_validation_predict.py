"""The validation-set path of the port on the CPU.

- The mode fault: a predictor built on a module before a train step and
  used after it must run the EVAL forward (the JAX predictors apply with
  ``train=False``): probabilities equal an eval-mode forward's, BatchNorm's
  running buffers do not move, Isensee2017 with dropout does not ask for
  masks.
- ``load_serving_model`` reads the port's own checkpoint
  (``training/checkpoint.py``) as well as an exported ``.npz``.
- ``run_validation_cases`` against the JAX package's on the same params and
  the same cases (its HDF5 dataset, the port's directory): the same tree;
  ``data_*`` and ``truth`` equal; probability maps within ATOL 2e-4 (fp32
  convolutions summed in another order); label maps equal except voxels
  whose JAX probability lies within 1e-4 of the threshold, at most 8 of
  the 13,824 voxels of a case (random weights leave many voxels near 0.5).
- ``predict.main`` with no ``--input`` and no ``--params`` walks the
  validation split from the checkpoint and the dataset; ``global``
  normalization reads its moments from the dataset.
"""

import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.data import (  # noqa: E402
    open_data_file as jax_open, write_data_to_file as jax_write)
from fetal_mri_segmentation_tpu.inference.predict import (  # noqa: E402
    run_validation_cases as jax_run_validation_cases)
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.training import create_train_state as jax_state  # noqa: E402
from fetal_mri_segmentation_tpu_torch import predict as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data.build import (  # noqa: E402
    open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    load_serving_model, preprocess_case, run_validation_case,
    run_validation_cases)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (  # noqa: E402
    DataMesh)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (  # noqa: E402
    HybridMesh, make_direct_predictor)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_dump  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ATOL = 2e-4
NEAR = 1e-4        # |p - threshold| under which a label may differ
MAX_DIFFER = 8     # label voxels that may differ per 24^3 case, all near


# --- the mode fault -----------------------------------------------------------


def _train_one_step(model, cfg, seed=0):
    rng = np.random.default_rng(seed)
    y = np.zeros((2, 1) + tuple(cfg.patch_shape), np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    x = (y * 2 + rng.normal(0, 0.3, y.shape)).astype(np.float32)
    step = make_train_step(model, cfg,
                           generator=torch.Generator().manual_seed(seed))
    step(create_train_state(model, cfg), torch.from_numpy(x),
         torch.from_numpy(y))


@pytest.mark.parametrize("kind", ["sliding", "direct"])
@pytest.mark.parametrize("family", ["unet-bn", "isensee-dropout"])
def test_predictor_built_before_a_train_step_predicts_in_eval_mode(kind,
                                                                   family):
    kw = (dict(model_name="unet", depth=2, batch_normalization=True)
          if family == "unet-bn"
          else dict(model_name="isensee", depth=3, dropout_rate=0.3,
                    n_segmentation_levels=2))
    cfg = Config(n_base_filters=4, patch_shape=(8, 8, 8),
                 image_shape=(16, 16, 16), batch_size=2,
                 compute_dtype="float32", augment=False, **kw)
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    if family == "unet-bn":  # running statistics off their initial values
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand_like(buf) + 0.5)
    predictor = (SlidingWindowPredictor(model, cfg, (16, 16, 16), overlap=4)
                 if kind == "sliding" else make_direct_predictor(model, cfg))
    _train_one_step(model, cfg)
    assert model.training  # the step leaves the module in training mode
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    vol = np.random.default_rng(1).normal(size=(1, 16, 16, 16)).astype(
        np.float32)
    got = predictor(vol)
    assert not model.training
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, buffers[n], atol=0, rtol=0, msg=n)
    if family == "unet-bn":
        assert buffers  # there are running statistics to hold still
    # an eval-mode forward of the same module on the same volume
    fresh = (SlidingWindowPredictor(model.eval(), cfg, (16, 16, 16),
                                    overlap=4)
             if kind == "sliding"
             else make_direct_predictor(model.eval(), cfg))
    np.testing.assert_array_equal(got, fresh(vol))
    if kind == "direct":
        with torch.no_grad():
            want = model(torch.from_numpy(vol).permute(1, 2, 3, 0)[None])
        np.testing.assert_allclose(got, want[0].permute(3, 0, 1, 2).numpy(),
                                   atol=1e-6)
    # the label and probability entries enter eval mode too
    model.train()
    predictor.predict_labels(vol)
    assert not model.training
    model.train()
    predictor.unpack_prob(predictor.predict_prob_async(vol))
    assert not model.training


# --- the port serves its own checkpoint ---------------------------------------


def test_load_serving_model_from_the_ports_checkpoint(tmp_path):
    cfg = Config(depth=2, n_base_filters=4, batch_normalization=True,
                 patch_shape=(8, 8, 8), batch_size=2,
                 compute_dtype="float32", augment=False,
                 model_file=str(tmp_path / "model.ckpt"))
    torch.manual_seed(3)
    model = build_model(cfg, "cpu")
    state = create_train_state(model, cfg)
    _train_one_step(model, cfg)  # moves parameters and running statistics
    with pytest.raises(FileNotFoundError) as e:
        load_serving_model(cfg, device="cpu")
    assert "fetal_mri_segmentation_tpu_torch.train" in str(e.value)
    assert "--params PARAMS.npz" in str(e.value)
    CheckpointIO(cfg.model_file).save(state, epoch=1, best_val=-0.5)
    served = load_serving_model(cfg, device="cpu")
    assert not served.training
    want = model.state_dict()
    assert set(served.state_dict()) == set(want)
    for key, value in served.state_dict().items():
        torch.testing.assert_close(value, want[key], atol=0, rtol=0)
    with pytest.raises(FileNotFoundError, match="absent.npz"):
        load_serving_model(cfg, str(tmp_path / "absent.npz"), "cpu")


# --- run_validation_cases against the JAX package -----------------------------


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """Cases, both datasets, a split, JAX variables and the port's
    checkpoint of the same weights."""
    d = tmp_path_factory.mktemp("validation_predict")
    files = write_synthetic_dataset(str(d / "cases"), n_cases=4,
                                    shape=(26, 28, 24))
    ids = [f"case_{i}" for i in range(4)]
    kw = dict(image_shape=(24, 24, 24), patch_shape=(16, 16, 16), depth=3,
              n_base_filters=4, compute_dtype="float32", fold_level0="off",
              validation_patch_overlap=4,
              validation_file=str(d / "validation_ids.pkl"),
              model_file=str(d / "model.ckpt"))
    jcfg = JaxConfig(data_file=str(d / "data.h5"), **kw)
    cfg = Config(data_file=str(d / "data"), **kw)
    jax_write(files, jcfg.data_file, image_shape=jcfg.image_shape,
              subject_ids=ids, normalize="per_volume")
    write_data_to_file(files, cfg.data_file, image_shape=cfg.image_shape,
                       subject_ids=ids, normalize="per_volume")
    pickle_dump([2, 0, 3], cfg.validation_file)
    jmodel = jax_build(jcfg)
    jstate = jax_state(jmodel, jcfg, jax.random.PRNGKey(4))
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(flatten_dict(jstate.params, sep="/")))
    CheckpointIO(cfg.model_file).save(create_train_state(model, cfg),
                                      epoch=1, best_val=-0.5)
    return d, jcfg, cfg, jmodel, {"params": jstate.params}, model


def _tree(directory):
    return {case: {f: load_nifti(os.path.join(directory, case, f))
                   for f in sorted(os.listdir(os.path.join(directory, case)))}
            for case in sorted(os.listdir(directory))}


def _jax_run(experiment, tag, **kw):
    d, jcfg, _, jmodel, variables, _ = experiment
    out = str(d / f"jax_{tag}")
    if not os.path.isdir(out):
        with jax_open(jcfg.data_file) as data_file:
            jax_run_validation_cases(jcfg.validation_file, jmodel, variables,
                                     data_file, jcfg, output_dir=out,
                                     overlap=4, **kw)
    return _tree(out)


@pytest.mark.parametrize("direct", [False, True], ids=["sliding", "direct"])
def test_run_validation_cases_matches_jax(experiment, direct):
    d, _, cfg, _, _, model = experiment
    from jax.sharding import Mesh
    jkw = ({"spatial_mesh": Mesh(np.asarray(jax.devices()[:1]),
                                 ("spatial",))} if direct else {})
    tag = "direct" if direct else "sliding"
    want_prob = _jax_run(experiment, f"prob_{tag}", output_label_map=False,
                         **jkw)
    want = _jax_run(experiment, f"labels_{tag}", **jkw)
    out, out_prob = str(d / f"port_{tag}"), str(d / f"port_prob_{tag}")
    with open_data_file(cfg.data_file) as data_file:
        n = run_validation_cases(cfg.validation_file, model, data_file, cfg,
                                 output_dir=out, overlap=4, direct=direct,
                                 device="cpu")
        run_validation_cases(cfg.validation_file, model, data_file, cfg,
                             output_dir=out_prob, overlap=4, direct=direct,
                             output_label_map=False, device="cpu")
    assert n == 3
    got, got_prob = _tree(out), _tree(out_prob)
    assert sorted(got) == sorted(want) == ["case_0", "case_2", "case_3"]
    differing = []
    for case in got:
        assert sorted(got[case]) == sorted(want[case]) == [
            "data_volume.nii.gz", "prediction.nii.gz", "truth.nii.gz"]
        for f in ("data_volume.nii.gz", "truth.nii.gz"):
            np.testing.assert_array_equal(got[case][f].get_fdata(),
                                          want[case][f].get_fdata())
        for f in got[case]:
            np.testing.assert_array_equal(got[case][f].affine,
                                          want[case][f].affine)
        p_want = want_prob[case]["prediction.nii.gz"].get_fdata()
        np.testing.assert_allclose(
            got_prob[case]["prediction.nii.gz"].get_fdata(), p_want,
            atol=ATOL, rtol=0)
        a = got[case]["prediction.nii.gz"]
        b = want[case]["prediction.nii.gz"]
        assert a.dataobj.dtype == b.dataobj.dtype
        differ = a.get_fdata() != b.get_fdata()
        near = np.abs(p_want - 0.5) <= NEAR
        assert not (differ & ~near).any()
        differing.append(int(differ.sum()))
        assert 0 < a.get_fdata().sum() < a.get_fdata().size
    print("label voxels that differ per case:", differing)
    assert max(differing) <= MAX_DIFFER


def test_run_validation_case_and_names_without_subject_ids(experiment,
                                                           tmp_path):
    d, _, cfg, _, _, model = experiment
    files = [[str(d / "cases" / f"case_{i}" / f) for f in
              ("volume.nii.gz", "truth.nii.gz")] for i in range(2)]
    write_data_to_file(files, str(tmp_path / "noids"),
                       image_shape=cfg.image_shape, normalize="per_volume")
    pickle_dump([1], str(tmp_path / "v.pkl"))
    with open_data_file(str(tmp_path / "noids")) as data_file:
        assert data_file.subject_ids is None
        run_validation_cases(str(tmp_path / "v.pkl"), model, data_file, cfg,
                             output_dir=str(tmp_path / "out"), overlap=4,
                             device="cpu")
        predictor = SlidingWindowPredictor(model, cfg, cfg.image_shape,
                                           overlap=4)
        one = run_validation_case(1, str(tmp_path / "one"), data_file, cfg,
                                  predictor)
    assert os.listdir(tmp_path / "out") == ["validation_case_1"]
    got = load_nifti(str(tmp_path / "out" / "validation_case_1"
                         / "prediction.nii.gz")).get_fdata()
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(
        got, load_nifti(str(tmp_path / "one" / "prediction.nii.gz")
                        ).get_fdata())


@pytest.mark.parametrize("kw,match", [
    ({"mesh": DataMesh(None, 0, 2, torch.device("cpu")),
      "spatial_mesh": HybridMesh(None, None, None, 0, 1, 2,
                                 torch.device("cpu"))},
     "mutually exclusive"),
    ({"spatial_mesh": HybridMesh(None, None, None, 0, 1, 5,
                                 torch.device("cpu"))},
     "volume depth 24 not divisible by the mesh's 5 spatial shards"),
    # slabs of 6 rows that go odd at level 1: accepted, as JAX accepts
    # them (the models gather that level; tests/test_torch_spatial.py runs
    # it on ranks); a mesh view with no group predicts whole volumes
    ({"spatial_mesh": HybridMesh(None, None, None, 0, 1, 4,
                                 torch.device("cpu"))}, None)])
def test_more_than_one_device_raises_by_name(experiment, tmp_path, kw, match):
    """More than one device is ported (``tests/test_torch_sharded_predict.py``
    runs both meshes on two ranks); what still raises, before any case is
    read or written: both meshes at once and a volume depth that does not
    split over the spatial ranks (JAX's messages). A slab that goes odd
    before the last halving is predicted, equal to the direct predictor."""
    _, _, cfg, _, _, model = experiment
    with open_data_file(cfg.data_file) as data_file:
        if match is None:
            run_validation_cases(cfg.validation_file, model, data_file, cfg,
                                 output_dir=str(tmp_path / "o"), device="cpu",
                                 **kw)
            run_validation_cases(cfg.validation_file, model, data_file, cfg,
                                 output_dir=str(tmp_path / "direct"),
                                 direct=True, device="cpu")
            got, want = _tree(tmp_path / "o"), _tree(tmp_path / "direct")
            assert sorted(got) == sorted(want) and len(got) == 3
            for case, files in want.items():
                for f, img in files.items():
                    np.testing.assert_array_equal(got[case][f].get_fdata(),
                                                  img.get_fdata())
            return
        with pytest.raises(ValueError, match=match):
            run_validation_cases(cfg.validation_file, model, data_file, cfg,
                                 output_dir=str(tmp_path / "o"), device="cpu",
                                 **kw)
    assert not (tmp_path / "o").exists()


# --- the entry point ----------------------------------------------------------


@pytest.mark.parametrize("flags", [{}, {"direct": True},
                                   {"prob_map": True, "prob_dtype": "uint8"},
                                   {"tta": "flips"}], ids=str)
def test_predict_main_walks_the_validation_split(experiment, flags):
    """No ``--input`` and no ``--params``: the checkpoint and the dataset.
    The same files as ``run_validation_cases`` with the same options."""
    d, _, cfg, _, _, model = experiment
    tag = "_".join(f"{k}-{v}" for k, v in flags.items()) or "plain"
    out = str(d / f"main_{tag}")
    n = entry.main(cfg, output_dir=out, device="cpu", verbose=False, **flags)
    assert n == 3
    ref = str(d / f"ref_{tag}")
    with open_data_file(cfg.data_file) as data_file:
        run_validation_cases(
            cfg.validation_file, model, data_file, cfg, output_dir=ref,
            overlap=cfg.validation_patch_overlap,
            direct=flags.get("direct", False),
            permute=flags.get("tta", False),
            output_label_map=not flags.get("prob_map", False),
            prob_dtype=flags.get("prob_dtype", "float32"), device="cpu")
    got, want = _tree(out), _tree(ref)
    assert sorted(got) == ["case_0", "case_2", "case_3"]
    for case in got:
        assert sorted(got[case]) == sorted(want[case])
        for f in got[case]:
            np.testing.assert_array_equal(got[case][f].get_fdata(),
                                          want[case][f].get_fdata())


def test_device_preprocess_without_input_keeps_its_error(experiment):
    _, _, cfg, _, _, _ = experiment
    with pytest.raises(ValueError, match="--device-preprocess"):
        entry.main(cfg, device="cpu", device_preprocess=True)
    assert entry._parser().parse_args(["--config", "c.json"]).params is None


def test_global_moments_come_from_the_dataset(experiment, tmp_path):
    """``normalization="global"``: ``predict --input`` reads the training
    moments from the dataset once; the prediction equals the one made with
    the moments handed in, and differs from a per-volume one."""
    import dataclasses
    d, _, cfg, _, _, model = experiment
    files = [[str(d / "cases" / f"case_{i}" / f) for f in
              ("volume.nii.gz", "truth.nii.gz")] for i in range(4)]
    gcfg = dataclasses.replace(cfg, normalization="global",
                               data_file=str(tmp_path / "gdata"))
    write_data_to_file(files, gcfg.data_file, image_shape=gcfg.image_shape,
                       normalize="global")
    with open_data_file(gcfg.data_file) as f:
        moments = f.global_moments
    case = str(d / "cases" / "case_1")
    want, _, _ = preprocess_case(case, gcfg, global_moments=moments)
    with open_data_file(gcfg.data_file) as f:  # the stored, normalized case
        np.testing.assert_allclose(want, np.asarray(f.root.data[1]),
                                   atol=1e-5)
    for pre in (False, True):
        out = tmp_path / f"out_{pre}"
        entry.main(gcfg, None, [case], output_dir=str(out), device="cpu",
                   verbose=False, device_preprocess=pre)
        got = load_nifti(str(out / "case_1" / "data_volume.nii.gz")
                         ).get_fdata()
        np.testing.assert_allclose(got, want[0],
                                   atol=5e-3 if pre else 0, rtol=1e-3)
    # no dataset to read the moments from: the error says what is needed
    lost = dataclasses.replace(gcfg, data_file=str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="load_global_moments"):
        entry.main(lost, None, [case], output_dir=str(tmp_path / "x"),
                   device="cpu", verbose=False)
