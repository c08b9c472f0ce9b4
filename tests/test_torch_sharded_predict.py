"""The port's multi-device inference on the CPU: the patch-grid sharded
predictor (``parallel/distributed.py::make_sharded_predictor``),
``run_validation_cases`` with a data mesh and with a spatial mesh, and
``predict.main`` with ``num_devices`` and ``spatial_devices``.

Two gloo ranks run once as subprocesses
(``tests/test_torch_sharded_predict_worker.py``) while the JAX package's
``make_sharded_predictor`` on ``make_mesh(2)`` runs here on conftest's
virtual devices, on the same weights (fp32, fold off), at overlaps 4 and 5
as in ``tests/test_parallel.py::test_sharded_predictor_matches_single_device``.
Tolerance: probabilities atol 1e-5 against JAX and against the port's
one-device sliding window (the overlap-add sums in another order); label
maps equal. ``predict.main`` starts its own two ranks.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.inference import (  # noqa: E402
    SlidingWindowPredictor as JaxSlidingWindow)
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from fetal_mri_segmentation_tpu.parallel.distributed import (  # noqa: E402
    make_sharded_predictor as jax_sharded)
from fetal_mri_segmentation_tpu.training import (  # noqa: E402
    create_train_state as jax_state)
from fetal_mri_segmentation_tpu_torch import predict as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data.build import (  # noqa: E402
    open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    run_validation_cases)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (  # noqa: E402
    DataMesh)
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (  # noqa: E402
    free_port)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (  # noqa: E402
    HybridMesh)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_dump  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402
from tests import test_torch_sharded_predict_worker as W  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300
ATOL = 1e-5


def _tree(directory):
    return {case: {f: load_nifti(os.path.join(directory, case, f))
                   for f in sorted(os.listdir(os.path.join(directory, case)))}
            for case in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A dataset, a split, a checkpoint of JAX-initialized weights, the two
    ranks' results and the JAX sharded predictor's probabilities."""
    d = tmp_path_factory.mktemp("sharded_predict")
    files = write_synthetic_dataset(str(d / "cases"), n_cases=3,
                                    shape=(18, 20, 18))
    kw = dict(image_shape=(16, 16, 16), patch_shape=(8, 8, 8), depth=2,
              n_base_filters=4, compute_dtype="float32", fold_level0="off",
              validation_patch_overlap=4)
    cfg = Config(data_file=str(d / "data"),
                 validation_file=str(d / "validation_ids.pkl"),
                 model_file=str(d / "model.ckpt"), **kw)
    write_data_to_file(files, cfg.data_file, image_shape=cfg.image_shape,
                       subject_ids=[f"case_{i}" for i in range(3)],
                       normalize="per_volume")
    pickle_dump([2, 0], cfg.validation_file)
    jcfg = JaxConfig(**kw)
    jmodel = jax_build(jcfg)
    params = jax_state(jmodel, jcfg, jax.random.PRNGKey(2)).params
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    CheckpointIO(cfg.model_file).save(create_train_state(model, cfg),
                                      epoch=1, best_val=-0.5)
    cfg.save(str(d / "config.json"))
    torch.save(model.state_dict(), str(d / "weights.pt"))

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable,
         str(ROOT / "tests" / "test_torch_sharded_predict_worker.py"),
         str(rank), "2", str(port), str(d)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        jax_prob = {}
        for overlap in W.OVERLAPS:
            pred = JaxSlidingWindow(jmodel, jcfg, W.VOLUME, jcfg.patch_shape,
                                    overlap=overlap,
                                    patch_batch_size=W.PATCH_BATCH)
            jax_prob[overlap] = jax_sharded(pred, jax_mesh(2))(
                {"params": params}, W.volume())
        one = dict(sharded=W.predict(cfg, model),
                   flips=W.predict(cfg, model, tta="flips"))
        outputs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, f"rank failed:\n{o[-3000:]}"
    ranks = [torch.load(str(d / f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return d, cfg, model, jax_prob, one, ranks


@pytest.mark.parametrize("tta", [False, "flips"], ids=str)
@pytest.mark.parametrize("overlap", W.OVERLAPS)
def test_sharded_predictor_on_two_ranks(experiment, overlap, tta):
    """Each rank predicts its contiguous chunk of the patch batches and
    returns the whole probability map: against the one-device sliding
    window (and without TTA the JAX sharded predictor) within 1e-5, the
    label map equal, the fp16 transfer within fp16's rounding."""
    _, _, _, jax_prob, one, ranks = experiment
    key = "flips" if tta else "sharded"
    want = one[key][overlap]
    shares = [r[key][overlap]["batches"] for r in ranks]
    assert shares[0] + shares[1] == want["batches"] and all(shares)
    for r in ranks:
        got = r[key][overlap]
        assert got["prob"].shape == (1,) + W.VOLUME
        np.testing.assert_allclose(got["prob"], want["prob"], atol=ATOL,
                                   rtol=0)
        if not tta:
            np.testing.assert_allclose(got["prob"], jax_prob[overlap],
                                       atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["prob16"], want["prob"], atol=5e-4,
                                   rtol=0)
    np.testing.assert_array_equal(ranks[0][key][overlap]["prob"],
                                  ranks[1][key][overlap]["prob"])


@pytest.mark.parametrize("tag,direct", [("mesh", False), ("spatial", True)])
def test_run_validation_cases_on_two_ranks(experiment, tmp_path, tag, direct):
    """The data mesh shards the patch grid, the spatial mesh the volume's
    depth: rank 0's tree equals one device's (the sliding window, or the
    direct whole-volume forward), and rank 1 writes nothing."""
    d, cfg, model, _, _, ranks = experiment
    with open_data_file(cfg.data_file) as data_file:
        run_validation_cases(cfg.validation_file, model, data_file, cfg,
                             output_dir=str(tmp_path / "one"), overlap=4,
                             direct=direct, device="cpu")
    assert [r[f"{tag} cases"] for r in ranks] == [2, 2]
    assert not (d / f"{tag}_rank1").exists()
    got, want = _tree(str(d / f"{tag}_rank0")), _tree(str(tmp_path / "one"))
    assert sorted(got) == sorted(want) == ["case_0", "case_2"]
    for case in want:
        assert sorted(got[case]) == sorted(want[case])
        for f in want[case]:
            np.testing.assert_array_equal(got[case][f].get_fdata(),
                                          want[case][f].get_fdata())
            np.testing.assert_array_equal(got[case][f].affine,
                                          want[case][f].affine)


@pytest.mark.parametrize("flags", [{"num_devices": 2, "prob_map": True},
                                   {"spatial_devices": 2}], ids=str)
def test_predict_main_starts_its_own_ranks(experiment, tmp_path, flags):
    """``predict.main`` with no ``--input`` on two devices: it starts the
    two ranks itself, and the tree equals the one-device run's (the
    patch grid's probabilities within 1e-5; the spatial mesh against
    ``--direct``)."""
    _, cfg, _, _, _, _ = experiment
    os.environ.setdefault("OMP_NUM_THREADS", "1")  # the ranks inherit it
    got_dir, want_dir = str(tmp_path / "ranks"), str(tmp_path / "one")
    assert entry.main(cfg, output_dir=got_dir, device="cpu", verbose=False,
                      rank_timeout_s=RANK_TIMEOUT_S, **flags) is None
    one = {k: v for k, v in flags.items() if k == "prob_map"}
    assert entry.main(cfg, output_dir=want_dir, device="cpu", verbose=False,
                      direct="spatial_devices" in flags, **one) == 2
    got, want = _tree(got_dir), _tree(want_dir)
    assert sorted(got) == sorted(want) == ["case_0", "case_2"]
    for case in want:
        for f in want[case]:
            np.testing.assert_allclose(got[case][f].get_fdata(),
                                       want[case][f].get_fdata(), atol=ATOL,
                                       rtol=0)


def test_mutually_exclusive_meshes_and_input_refuse(experiment, tmp_path):
    """JAX's errors: a data mesh and a spatial mesh of more than one device
    together, and ``--input`` on several devices; neither writes."""
    _, cfg, model, _, _, _ = experiment
    mesh = DataMesh(None, 0, 2, torch.device("cpu"))
    spatial = HybridMesh(None, None, None, 0, 1, 2, torch.device("cpu"))
    with open_data_file(cfg.data_file) as data_file:
        with pytest.raises(ValueError, match="mutually exclusive"):
            run_validation_cases(cfg.validation_file, model, data_file, cfg,
                                 output_dir=str(tmp_path / "o"), mesh=mesh,
                                 spatial_mesh=spatial, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        entry.main(cfg, output_dir=str(tmp_path / "o"), device="cpu",
                   num_devices=2, spatial_devices=2)
    with pytest.raises(ValueError, match="--input is single-device"):
        entry.main(cfg, inputs=["case"], output_dir=str(tmp_path / "o"),
                   device="cpu", spatial_devices=2)
    assert not (tmp_path / "o").exists()
