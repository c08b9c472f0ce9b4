"""The port's training loop end to end on the in-memory data file, and the
pieces it stands on against their JAX originals: callbacks, patch
generators, the in-memory file against the HDF5 writer, prefetch and
checkpoints. Resume, a run without validation and zero training steps as
in ``tests/test_loop.py``; the mesh and cache combinations the loop
refuses (``tests/test_torch_device_cache.py`` and ``test_torch_parallel.py``
hold the ones it runs).

Tolerance: the generators, callbacks and patch functions are copies and
must agree exactly; the in-memory file against the HDF5 writer atol 1e-5
(the same float32 normalization, sums in another order).
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.data import (  # noqa: E402
    open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu.ops import patches as JP  # noqa: E402
from fetal_mri_segmentation_tpu.pipeline import generator as JG  # noqa: E402
from fetal_mri_segmentation_tpu.training import callbacks as JC  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data.memory import InMemoryDataFile  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import patches as TP  # noqa: E402
from fetal_mri_segmentation_tpu_torch.pipeline import generator as TG  # noqa: E402
from fetal_mri_segmentation_tpu_torch.pipeline.prefetch import (  # noqa: E402
    prefetch, to_device)
from fetal_mri_segmentation_tpu_torch.training import callbacks as TC  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.training.loop import (  # noqa: E402
    detect_dice_collapse, epoch_seed, train_model)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    from_flax, init_flax_like)
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_loop")
    files = write_synthetic_dataset(str(d / "nii"), n_cases=4,
                                    shape=(20, 20, 20))
    return d, files


@pytest.fixture(scope="module")
def data_file(cases):
    d, files = cases
    cfg = make_cfg(d)
    return InMemoryDataFile.from_cases(
        [os.path.dirname(f[0]) for f in files], cfg)


def make_cfg(d, **kw):
    defaults = dict(
        image_shape=(16, 16, 16), patch_shape=(8, 8, 8), depth=2,
        n_base_filters=8, batch_size=4, validation_batch_size=4, n_epochs=2,
        compute_dtype="float32", augment=True, flip=True, permute=True,
        contrast=0.1, initial_learning_rate=1e-2, early_stop=50,
        use_pallas_conv=True, use_pallas_dec0=True,
        model_file=str(d / "model.pt"), training_file=str(d / "t.pkl"),
        validation_file=str(d / "v.pkl"),
        training_log=str(d / "training.log"))
    defaults.update(kw)
    return Config(**defaults)


def _generators(cfg, data_file, mod=TG, **kw):
    args = dict(batch_size=cfg.batch_size, n_labels=1,
                training_keys_file=cfg.training_file,
                validation_keys_file=cfg.validation_file, data_split=0.75,
                overwrite=True, patch_shape=cfg.patch_shape,
                validation_batch_size=cfg.validation_batch_size,
                training_patch_start_offset=(2, 2, 2), skip_blank=True,
                seed=0)
    args.update(kw)
    return mod.get_training_and_validation_generators(data_file, **args)


def _fresh_state(cfg, seed=0):
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(init_flax_like(cfg, seed=seed)))
    return model, create_train_state(model, cfg)


# --- pieces against their JAX originals --------------------------------------


def test_in_memory_file_matches_the_hdf5_writer(cases, data_file, tmp_path):
    _, files = cases
    h5 = write_data_to_file(files, str(tmp_path / "data.h5"),
                            image_shape=(16, 16, 16), normalize="per_volume")
    ref = open_data_file(h5)
    try:
        np.testing.assert_allclose(data_file.root.data, ref.root.data[:],
                                   atol=1e-5)
        np.testing.assert_array_equal(data_file.root.truth,
                                      ref.root.truth[:])
    finally:
        ref.close()
    assert data_file.root.data.dtype == np.float32
    assert data_file.root.truth.shape == (4, 1, 16, 16, 16)
    with pytest.raises(ValueError, match="N, C, D, H, W"):
        InMemoryDataFile(np.zeros((2, 1, 4, 4, 4)), np.zeros((2, 1, 4, 4)))


@pytest.mark.parametrize("skip_batches", [0, 3])
def test_generators_match_jax(cases, data_file, skip_batches):
    d, _ = cases
    cfg = make_cfg(d, training_file=str(d / "gt.pkl"),
                   validation_file=str(d / "gv.pkl"))
    got = _generators(cfg, data_file)
    want = _generators(cfg, data_file, mod=JG)
    assert got[1::2] == want[1::2]
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        tg = TG.data_generator(data_file, [0, 1, 2], batch_size=3,
                               patch_shape=(8, 8, 8), seed=4,
                               patch_start_offset=(2, 2, 2),
                               skip_batches=skip_batches)
        jg = JG.data_generator(data_file, [0, 1, 2], batch_size=3,
                               patch_shape=(8, 8, 8), seed=4,
                               patch_start_offset=(2, 2, 2),
                               skip_batches=skip_batches)
        for _ in range(4):
            for a, b in zip(next(g), next(w)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(next(tg), next(jg)):
                np.testing.assert_array_equal(a, b)


def test_patch_functions_match_jax(monkeypatch):
    """The patch functions against the JAX package's numpy path (its
    optional native library is turned off, so the result does not hang on
    whether that library was built). A corner wholly outside the volume on
    one axis is held to the zero patch the port documents, which is what
    the JAX native loader returns; the JAX numpy path returns a wrongly
    shaped patch there (ROADMAP.md queue 3, record)."""
    monkeypatch.setenv("FETAL_TPU_NO_NATIVE", "1")
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2, 9, 10, 11)).astype(np.float32)
    for corner in ([-3, 2, 4], [0, 0, 0], [5, 6, 7]):
        np.testing.assert_array_equal(
            TP.get_patch_from_3d_data(data, (6, 6, 6), corner),
            JP.get_patch_from_3d_data(data, (6, 6, 6), corner))
    outside = TP.get_patch_from_3d_data(data, (6, 6, 6), [-8, -8, 9])
    assert outside.shape == (2, 6, 6, 6)
    np.testing.assert_array_equal(outside, np.zeros((2, 6, 6, 6), np.float32))
    a = TP.get_random_nd_index((3, 4, 5), np.random.default_rng(1))
    b = JP.get_random_nd_index((3, 4, 5), np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        TG.create_patch_index_list([0, 2], (16, 16, 16), (8, 8, 8), 2,
                                   (2, 2, 2), np.random.default_rng(2))[5][1],
        JG.create_patch_index_list([0, 2], (16, 16, 16), (8, 8, 8), 2,
                                   (2, 2, 2), np.random.default_rng(2))[5][1])


def test_callbacks_match_jax(tmp_path):
    for args in ((0, 1.0, 0.5, 10), (9, 1.0, 0.5, 10), (19, 2e-3, 0.25, 4)):
        assert TC.step_decay(*args) == JC.step_decay(*args)
    losses = [1.0, 1.1, 1.2, 0.5, 0.6, 0.7, 0.8]
    tp, jp = TC.ReduceLROnPlateau(1.0, patience=2), JC.ReduceLROnPlateau(
        1.0, patience=2)
    te, je = TC.EarlyStopping(patience=2), JC.EarlyStopping(patience=2)
    for v in losses:
        assert tp.update(v) == jp.update(v)
        assert te.update(v) == je.update(v)
    for mod, name in ((TC, "t.log"), (JC, "j.log")):
        p = str(tmp_path / name)
        mod.CSVLogger(p).log(0, {"loss": 1.0})
        mod.CSVLogger(p).log(1, {"loss": 0.5, "label_0_dice_coef": 0.9})
        mod.CSVLogger(p).log(2, {"loss": 0.4})
    with open(tmp_path / "t.log") as f, open(tmp_path / "j.log") as g:
        assert f.read() == g.read()
    meter = TC.ThroughputMeter((8, 8, 8), (16, 16, 16))
    meter.add(4)
    assert meter.vox_ratio == 1 / 8 and meter.rates()["patches_per_sec"] > 0


def test_dice_collapse_detection():
    assert not detect_dice_collapse([0.001, 0.002])
    assert detect_dice_collapse([0.5, 0.001, 0.002, 0.003])
    assert not detect_dice_collapse([0.001, 0.5, 0.002, 0.003])


def test_epoch_seed_is_a_pure_function_of_seed_and_epoch():
    assert epoch_seed(0, 3) == epoch_seed(0, 3)
    assert len({epoch_seed(s, e) for s in range(3) for e in range(3)}) == 9


def test_prefetch_keeps_order_and_raises_producer_errors():
    out = list(prefetch(iter(range(7)), size=2,
                        device_put=lambda i: to_device(np.full(2, i), "cpu")))
    assert [int(t[0]) for t in out] == list(range(7))

    def broken():
        yield 1
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(prefetch(broken()))


def test_checkpoint_roundtrip(cases, tmp_path):
    d, _ = cases
    cfg = make_cfg(d, augment=False, model_file=str(tmp_path / "m.pt"))
    model, state = _fresh_state(cfg)
    step = make_train_step(model, cfg)
    x = torch.randn(2, 1, 8, 8, 8)
    y = (torch.rand(2, 1, 8, 8, 8) > 0.5).float()
    for _ in range(3):
        step(state, x, y)
    state.set_learning_rate(5e-3)
    io = CheckpointIO(cfg.model_file)
    assert not io.exists() and io.peek_epoch() is None
    io.save(state, epoch=7, best_val=-0.5)
    assert io.exists() and io.peek_epoch() == 7
    with open(cfg.model_file + ".meta.json") as f:
        assert json.load(f)["data_order"] == {"mode": "lockstep"}
    model2, state2 = _fresh_state(cfg, seed=5)
    state2, epoch, best, sched = io.restore(state2)
    assert (epoch, best, state2.step) == (7, -0.5, 3)
    assert sched == {"plateau_best": -0.5, "plateau_wait": 0.0,
                     "early_best": -0.5, "early_wait": 0.0}
    assert state2.learning_rate == 5e-3
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=n)
        for k in ("mu", "nu"):
            torch.testing.assert_close(state.optimizer.state[a][k],
                                       state2.optimizer.state[b][k],
                                       atol=0, rtol=0)
    # both continue identically
    m1, m2 = step(state, x, y), make_train_step(model2, cfg)(state2, x, y)
    torch.testing.assert_close(m1["loss"], m2["loss"], atol=0, rtol=0)


# --- the loop -----------------------------------------------------------------


def test_train_model_end_to_end_and_resume(cases, data_file):
    d, _ = cases
    cfg = make_cfg(d)
    tg, n_t, vg, n_v = _generators(cfg, data_file)
    model, state = _fresh_state(cfg)
    state = train_model(model, state, cfg, tg, vg, n_t, n_v, verbose=False)
    assert state.step == 2 * n_t
    with open(cfg.training_log) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    for col in ("epoch", "loss", "val_loss", "dice_coefficient",
                "val_dice_coefficient", "lr", "patches_per_sec"):
        assert col in rows[0]
    io = CheckpointIO(cfg.model_file)
    assert io.exists() and io.peek_epoch() in (1, 2)
    best = min(float(r["val_loss"]) for r in rows)
    _, fresh = _fresh_state(cfg, seed=9)
    _, epoch, best_val, _ = io.restore(fresh)
    assert best_val == pytest.approx(best) and epoch == io.peek_epoch()

    # resume: runs epoch 2 only, from the checkpoint
    cfg3 = make_cfg(d, n_epochs=3)
    model3, state3 = _fresh_state(cfg3, seed=4)
    state3 = train_model(model3, state3, cfg3, tg, vg, n_t, n_v,
                         verbose=False)
    assert state3.step == epoch * n_t + n_t * (3 - epoch)
    with open(cfg.training_log) as f:
        assert [r["epoch"] for r in csv.DictReader(f)][-1] == "2"


def test_train_model_without_validation_warns(cases, data_file, tmp_path,
                                              capsys):
    d, _ = cases
    cfg = make_cfg(d, model_file=str(tmp_path / "nv.pt"),
                   training_log=str(tmp_path / "nv.log"), n_epochs=1)
    tg, n_t, vg, _ = _generators(cfg, data_file)
    model, state = _fresh_state(cfg)
    train_model(model, state, cfg, tg, vg, n_t, 0, verbose=True)
    assert "no validation will run" in capsys.readouterr().out
    with open(cfg.training_log) as f:
        header = f.readline()
    assert "loss" in header and "val_loss" not in header
    assert CheckpointIO(cfg.model_file).exists()


def test_train_model_refuses_zero_steps_and_unported_paths(cases, data_file):
    d, _ = cases
    cfg = make_cfg(d)
    tg, _, vg, n_v = _generators(cfg, data_file)
    model, state = _fresh_state(cfg)
    with pytest.raises(ValueError, match="steps_per_epoch=0"):
        train_model(model, state, cfg, tg, vg, 0, n_v, verbose=False)
    # the cache and the mesh are ported; what stays refused, as in the JAX
    # loop: the cache on a spatial mesh, a partial cache on any mesh
    from types import SimpleNamespace as NS
    with pytest.raises(ValueError, match="spatial/hybrid"):
        train_model(model, state, cfg, tg, vg, 1, n_v, verbose=False,
                    mesh=NS(size=4, rank=0, axis_names=("data", "spatial")),
                    device_cache=NS(partial=False))
    with pytest.raises(ValueError, match="single-device only"):
        train_model(model, state, cfg, tg, vg, 1, n_v, verbose=False,
                    mesh=NS(size=2, rank=0, axis_names=("data",)),
                    device_cache=NS(partial=True))
