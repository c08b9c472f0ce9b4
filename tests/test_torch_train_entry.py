"""The port's training entry point ``python -m
fetal_mri_segmentation_tpu_torch.train`` against the root ``train.py`` on
the same synthetic cases and tiny config (CPU, fp32): the dataset (equal
arrays), the split pickles (equal), the log's columns (equal) and the
checkpoint with its sidecar, as the root entry leaves them; resume; a start
from the variables and Adam moments that ``tools/export_params_npz.py``
writes (equal bit for bit after loading); the refusals by name.
"""

import csv
import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.data import open_data_file as jax_open  # noqa: E402
from fetal_mri_segmentation_tpu_torch import train as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data.build import open_data_file  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    from_flax, load_npz_train_state)
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_cfg(cls, d, data_name, **kw):
    defaults = dict(
        image_shape=(16, 16, 16), patch_shape=(8, 8, 8),
        validation_patch_overlap=2, training_patch_start_offset=(2, 2, 2),
        depth=2, n_base_filters=4, batch_size=4, n_epochs=2,
        compute_dtype="float32", fold_level0="off", augment=True,
        distort=0.25, rotate=15.0, contrast=0.1, validation_split=0.75,
        num_devices=1,  # tests/conftest.py gives JAX 8 virtual CPU devices
        data_file=str(d / data_name), model_file=str(d / "model.ckpt"),
        training_file=str(d / "training_ids.pkl"),
        validation_file=str(d / "validation_ids.pkl"),
        training_log=str(d / "training.log"))
    defaults.update(kw)
    return cls(**defaults)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_entry")
    write_synthetic_dataset(str(d / "cases"), n_cases=4, shape=(20, 22, 18))
    return d


@pytest.fixture(scope="module")
def runs(cases):
    """The root ``train.py`` and the port's entry on the same cases."""
    (cases / "jax").mkdir()
    (cases / "port").mkdir()
    jcfg = make_cfg(JaxConfig, cases / "jax", "data.h5")
    _load("root_train", ROOT / "train.py").main(
        jcfg, str(cases / "cases"), verbose=False, seed=3)
    cfg = make_cfg(Config, cases / "port", "data")
    state = entry.main(cfg, str(cases / "cases"), verbose=False, seed=3,
                       device="cpu")
    return jcfg, cfg, state


def test_fetch_training_data_files_equals_the_root(cases):
    root = _load("root_train_fetch", ROOT / "train.py")
    os.makedirs(cases / "cases" / "incomplete", exist_ok=True)
    assert (entry.fetch_training_data_files(str(cases / "cases"),
                                            ("volume",))
            == root.fetch_training_data_files(str(cases / "cases"),
                                              ("volume",)))
    files, ids = entry.fetch_training_data_files(str(cases / "cases"),
                                                 ("volume",))
    assert ids == [f"case_{i}" for i in range(4)]


def test_dataset_and_split_as_the_root_leaves_them(runs):
    jcfg, cfg, _ = runs
    assert os.path.isdir(cfg.data_file) and os.path.isfile(jcfg.data_file)
    with open_data_file(cfg.data_file) as port, \
            jax_open(jcfg.data_file) as ref:
        np.testing.assert_array_equal(np.asarray(port.root.data),
                                      ref.root.data[:])
        np.testing.assert_array_equal(np.asarray(port.root.truth),
                                      ref.root.truth[:])
        np.testing.assert_array_equal(np.asarray(port.root.affine),
                                      ref.root.affine[:])
        assert port.subject_ids == [f"case_{i}" for i in range(4)]
        assert port.normalization == "per_volume"
    for name in ("training_file", "validation_file"):
        assert (pickle_load(getattr(cfg, name))
                == pickle_load(getattr(jcfg, name)))
    assert len(pickle_load(cfg.training_file)) == 3
    assert len(pickle_load(cfg.validation_file)) == 1


def test_log_columns_and_checkpoint_as_the_root_leaves_them(runs):
    jcfg, cfg, state = runs
    with open(cfg.training_log) as f:
        rows = list(csv.DictReader(f))
    with open(jcfg.training_log) as f:
        want = list(csv.DictReader(f))
    assert list(rows[0]) == list(want[0])
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in want] == [
        "0", "1"]
    assert all(np.isfinite(float(r["loss"])) and
               np.isfinite(float(r["val_loss"])) for r in rows)
    io = CheckpointIO(cfg.model_file)
    assert io.exists() and io.peek_epoch() in (1, 2)
    with open(cfg.model_file + ".meta.json") as f:
        meta = json.load(f)
    with open(jcfg.model_file + ".meta.json") as f:
        jmeta = json.load(f)
    assert set(meta) >= {"epoch", "best_val", "data_order"}
    assert set(jmeta) >= {"epoch", "best_val"}
    assert state.step > 0 and state.step % 2 == 0  # two epochs of steps


def test_resume_continues_from_the_checkpoint(runs, capsys):
    _, cfg, _ = runs
    epoch = CheckpointIO(cfg.model_file).peek_epoch()
    cfg3 = dataclasses.replace(cfg, n_epochs=3)
    state = entry.main(cfg3, "unused: the dataset exists", verbose=True,
                       seed=3, device="cpu")
    out = capsys.readouterr().out
    assert f"[resume] epoch {epoch}" in out and "building" not in out
    with open(cfg.training_log) as f:
        epochs = [r["epoch"] for r in csv.DictReader(f)]
    assert epochs[-1] == "2" and len(epochs) == 2 + (3 - epoch)
    assert state.step % 3 == 0  # three epochs' worth of steps in all
    # --overwrite starts afresh: the dataset is rebuilt, the log restarts
    cfg1 = dataclasses.replace(cfg, n_epochs=1)
    entry.main(cfg1, str(Path(cfg.data_file).parent.parent / "cases"),
               overwrite=True, verbose=True, seed=3, device="cpu")
    assert "building" in capsys.readouterr().out
    assert CheckpointIO(cfg.model_file).peek_epoch() == 1


def test_same_seed_trains_the_same_model(cases, tmp_path):
    """Init, split, patch sampling, augmentation draws: all from --seed."""
    weights = []
    for tag, seed in (("a", 5), ("b", 5), ("c", 6)):
        (tmp_path / tag).mkdir()
        cfg = make_cfg(Config, tmp_path / tag, "data", n_epochs=1)
        state = entry.main(cfg, str(cases / "cases"), verbose=False,
                           seed=seed, device="cpu")
        weights.append(torch.cat([p.detach().reshape(-1)
                                  for p in state.model.parameters()]))
    torch.testing.assert_close(weights[0], weights[1], atol=0, rtol=0)
    assert not torch.equal(weights[0], weights[2])


def test_init_params_with_adam_moments_from_the_export_tool(runs, cases,
                                                            tmp_path,
                                                            capsys):
    """The root entry's checkpoint through ``tools/export_params_npz.py``
    into ``--init-params``: variables, Adam mu / nu, the step count and
    the learning rate arrive bit for bit, and training goes on from
    them."""
    import jax
    from flax.traverse_util import flatten_dict

    from fetal_mri_segmentation_tpu.models import build_model as jax_build
    from fetal_mri_segmentation_tpu.training.checkpoint import load_old_model

    jcfg, _, _ = runs
    tool = _load("export_params_npz", ROOT / "tools" / "export_params_npz.py")
    npz = str(tmp_path / "params.npz")
    jstate, _, _ = load_old_model(jcfg.model_file, jax_build(jcfg), jcfg)
    n_vars = len(jax.tree_util.tree_leaves(jstate.params))
    assert tool.export_params(jcfg, npz) == n_vars
    with np.load(npz) as f:
        names = set(f.files)
        count = int(f["opt/count"])
    assert count > 0 and "opt/learning_rate" in names
    assert sum(n.startswith("opt/mu/") for n in names) == n_vars
    assert sum(n.startswith("opt/nu/") for n in names) == n_vars

    cfg = make_cfg(Config, tmp_path, "data", n_epochs=1)
    model = build_model(cfg, "cpu")
    state = create_train_state(model, cfg)
    assert load_npz_train_state(state, npz) is True
    adam = tool.adam_state(jstate.opt_state)
    want_w = from_flax(flatten_dict(jstate.params, sep="/"))
    want_mu = from_flax(flatten_dict(adam.mu, sep="/"))
    want_nu = from_flax(flatten_dict(adam.nu, sep="/"))
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want_w[name], atol=0, rtol=0)
        slot = state.optimizer.state[p]
        assert slot["count"] == count == int(adam.count)
        torch.testing.assert_close(slot["mu"], want_mu[name], atol=0, rtol=0)
        torch.testing.assert_close(slot["nu"], want_nu[name], atol=0, rtol=0)
    assert state.step == count
    assert state.learning_rate == pytest.approx(
        float(jstate.opt_state.hyperparams["learning_rate"]))

    trained = entry.main(cfg, str(cases / "cases"), verbose=True, seed=3,
                         init_params=npz, device="cpu")
    assert f"Adam state at step {count}" in capsys.readouterr().out
    assert trained.step > count
    slot = trained.optimizer.state[next(trained.model.parameters())]
    assert slot["count"] == trained.step

    # a params-only file (the earlier form) starts a fresh optimizer
    plain = str(tmp_path / "plain.npz")
    np.savez(plain, **{k: np.asarray(v) for k, v in
                       flatten_dict(jstate.params, sep="/").items()})
    state2 = create_train_state(build_model(cfg, "cpu"), cfg)
    assert load_npz_train_state(state2, plain) is False
    assert state2.step == 0 and not state2.optimizer.state
    # an existing checkpoint and --init-params: refuse the ambiguity
    with pytest.raises(SystemExit, match="--init-params"):
        entry.main(cfg, str(cases / "cases"), verbose=False,
                   init_params=npz, device="cpu")


@pytest.mark.parametrize("kw,flags,match", [
    ({}, {"from_keras": "m.h5"}, "Keras interop"),
    ({"num_devices": 2}, {}, "DDP"),
    ({"spatial_devices": 2}, {}, "spatial sharding"),
    ({"device_case_cache": "on"}, {}, "device case cache"),
])
def test_refusals_by_name(cases, tmp_path, kw, flags, match):
    cfg = make_cfg(Config, tmp_path, "data", **kw)
    with pytest.raises(NotImplementedError, match=match):
        entry.main(cfg, str(cases / "cases"), device="cpu", **flags)
    assert not os.path.exists(cfg.data_file)  # refused before any work


def test_no_cases_found_exits_like_the_root(tmp_path):
    (tmp_path / "empty").mkdir()
    cfg = make_cfg(Config, tmp_path, "data")
    with pytest.raises(SystemExit, match="no cases found under"):
        entry.main(cfg, str(tmp_path / "empty"), device="cpu")


def test_the_card_is_the_default_device(cases, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    cfg = make_cfg(Config, tmp_path, "data")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main(cfg, str(cases / "cases"), verbose=False)


def test_smoke_run_and_profile_trace(tmp_path, capsys):
    entry.run_smoke(str(tmp_path / "smoke"), device="cpu")
    assert "smoke run complete" in capsys.readouterr().out
    d = tmp_path / "smoke"
    assert (d / "data" / "meta.json").exists()
    assert (d / "model.ckpt").exists() and (d / "config.json").exists()
    with open(d / "training.log") as f:
        assert len(list(csv.DictReader(f))) == 2
    # --profile LOGDIR writes one trace file
    cfg = Config.load(str(d / "config.json"))
    cfg.n_epochs = 1
    entry.main(cfg, str(d / "cases"), overwrite=True, verbose=False,
               profile_dir=str(tmp_path / "prof"), device="cpu")
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_cli_parses():
    args = entry._parser().parse_args(
        ["--config", "c.json", "--data-dir", "d", "--model", "isensee",
         "--overwrite", "--seed", "4", "--init-params", "p.npz",
         "--profile", "logs"])
    assert (args.config, args.data_dir, args.model_name, args.overwrite,
            args.seed, args.init_params, args.profile, args.device) == (
        "c.json", "d", "isensee", True, 4, "p.npz", "logs", "cuda")
    assert entry._parser().parse_args(["--smoke"]).smoke
