"""The port's quality-loop tools on the CPU at a tiny size (4 cases of 16^3,
2 epochs, ``--device cpu``): each runs ``train.main`` -> ``predict.main``
-> ``evaluate.main`` end to end and writes its summary with the JAX tool's
keys. ``tools/torch_parity_dice.py``'s dataset arrays and split pickles
equal those of the root ``parity_dice.py`` at the same size (its
``build_dataset`` writes the HDF5 file, and its training path's generators
write the pickles), and each tool's config is its JAX twin's with the
kernel switches on. On the CPU every kernel route runs its plain version,
so no launch is counted. The multi-class tool's summary carries pass or
fail, the compute dtype (``--compute-dtype float32`` runs too), the best
validation epoch and the collapse epoch (``curve_record``, held on a
written log), and ``tools/multiclass_quality_seeds.py`` runs the JAX
recipe with a seed through the root entry points at the same tiny size."""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu_torch.data.build import open_data_file  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti  # noqa: E402

from fetal_mri_segmentation_tpu_torch import config as port_config  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TINY = dict(device="cpu", n_cases=4, image=(16, 16, 16))
NO_LAUNCHES = {"conv3x3": 0, "conv3x3_flat": 0,
               "up_concat_conv3x3_kernel": 0}
# what differs between a tool's config and its JAX twin's by design (and
# the port's own Config fields, which the JAX Config does not have)
PORT_ONLY = {"use_pallas_conv", "use_pallas_dec0", "data_file", "model_file",
             "training_file", "validation_file", "training_log",
             *port_config.PORT_ONLY}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tool(name):
    return _load(f"port_{name}", ROOT / "tools" / f"{name}.py")


def _same_recipe(port_cfg, jax_cfg):
    port, want = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)
    assert {k: v for k, v in port.items() if k not in PORT_ONLY} == {
        k: v for k, v in want.items() if k not in PORT_ONLY}
    assert port_cfg.use_pallas_conv and port_cfg.use_pallas_dec0


def _launches(summary):
    assert summary["launches"] == {"train.main": NO_LAUNCHES,
                                   "predict.main": NO_LAUNCHES}


def test_parity_dice_matches_the_root_tool(tmp_path, monkeypatch):
    import jax

    from fetal_mri_segmentation_tpu.data import open_data_file as jax_open
    from fetal_mri_segmentation_tpu.pipeline import (
        get_training_and_validation_generators)

    root = _load("root_parity_dice", ROOT / "parity_dice.py")
    monkeypatch.setattr(root, "N_CASES", TINY["n_cases"])
    monkeypatch.setattr(root, "IMAGE", TINY["image"])
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    h5 = root.build_dataset(str(jax_dir))
    jcfg = root.make_config(str(jax_dir), h5, 2)
    with jax_open(h5) as f:
        # the generators of parity_dice.py::train_and_predict_ours, which
        # write the split pickles
        get_training_and_validation_generators(
            f, batch_size=jcfg.batch_size, n_labels=jcfg.n_labels,
            training_keys_file=jcfg.training_file,
            validation_keys_file=jcfg.validation_file,
            data_split=jcfg.validation_split, labels=jcfg.labels,
            patch_shape=jcfg.patch_shape,
            validation_batch_size=jcfg.validation_batch_size,
            skip_blank=jcfg.skip_blank, seed=0)
        want = {n: np.asarray(getattr(f.root, n)[:])
                for n in ("data", "truth", "affine")}
    del jax

    tool = _tool("torch_parity_dice")
    out = tmp_path / "port"
    summary = tool.main(str(out), epochs=2, **TINY)
    cfg = tool.make_config(str(out), str(out / "data"), 2, TINY["image"])
    _same_recipe(cfg, jcfg)
    with open_data_file(str(out / "data")) as f:
        for name, arr in want.items():
            np.testing.assert_array_equal(np.asarray(getattr(f.root, name)),
                                          arr, err_msg=name)
    for name in ("training_ids.pkl", "validation_ids.pkl"):
        assert pickle_load(str(out / name)) == pickle_load(
            str(jax_dir / name))
    with open(out / "summary.json") as f:
        assert json.load(f) == summary
    assert {"ours_mean_dice", "keras_mean_dice", "delta_mean",
            "n_val_cases", "epochs"} <= set(summary)
    assert summary["n_val_cases"] == 1 and summary["epochs"] == 2
    assert summary["keras_source"] == "recorded"
    assert summary["keras_mean_dice"] == tool.KERAS_RECORDED_MEAN == 0.9556
    assert 0.0 <= summary["ours_mean_dice"] <= 1.0
    _launches(summary)
    rows = (out / "parity_dice.csv").read_text().splitlines()
    assert rows[0] == "case,ours_dice,keras_dice,delta" and len(rows) == 2


@pytest.mark.parametrize("kw", [{}, {"seed": 1, "kernels_off": True},
                                {"compute_dtype": "float32"}],
                         ids=["recipe", "seed1-kernels-off", "float32"])
def test_multiclass_quality_matches_the_root_tool(tmp_path, kw):
    sys.path.insert(0, str(ROOT / "tests"))
    root = _load("root_multiclass_quality",
                 ROOT / "tools" / "multiclass_quality.py")
    tool = _tool("torch_multiclass_quality")
    for softmax in (False, True):
        _same_recipe(tool.make_config(str(tmp_path), 500, softmax=softmax),
                     root.make_config(str(tmp_path), 500, softmax=softmax))
    summary = tool.main(str(tmp_path), 2, **TINY, **kw)
    with open(tmp_path / "summary.json") as f:
        saved = json.load(f)
    assert saved["seed"] == kw.get("seed", 0)
    dtype = kw.get("compute_dtype", "bfloat16")
    assert saved["compute_dtype"] == dtype
    # fp32 runs the stock convolutions: the kernels are bf16 only
    assert saved["kernels"] == (not kw.get("kernels_off", False)
                                and dtype == "bfloat16")
    with open(tmp_path / "config.json") as f:
        config = json.load(f)
    assert config["use_pallas_conv"] == saved["kernels"]
    assert config["compute_dtype"] == saved["compute_dtype"]
    assert {"1", "2", "4", "region_whole", "train_wall_s",
            "distort"} <= set(saved)
    for key in ("1", "2", "4", "region_whole"):
        mean, low = saved[key]
        assert 0.0 <= low <= mean <= 1.0
        assert tuple(saved[key]) == summary[key]
    assert saved["passed"] == all(m >= 0.95 for m, _ in summary.values())
    assert saved["best_val_epoch"] in (0, 1)
    assert saved["collapse_epoch"] is None  # 2 epochs cannot hold 25
    _launches(saved)
    with open(tmp_path / "training.log") as f:
        header = f.readline().strip().split(",")
    assert {f"{p}label_{i}_dice_coef" for p in ("", "val_")
            for i in range(3)} <= set(header)
    labels = set()
    for case in os.listdir(tmp_path / "prediction"):
        labels |= set(np.unique(load_nifti(str(
            tmp_path / "prediction" / case / "prediction.nii.gz")
            ).get_fdata()).tolist())
    assert labels <= {0.0, 1.0, 2.0, 4.0}


@pytest.mark.parametrize("recipe", ["unet", "isensee"])
def test_quality_loops(tmp_path, recipe):
    from fetal_mri_segmentation_tpu_torch.config import Config

    tool = _tool("torch_quality_loops")
    name, overrides, n_cases, epochs, _ = tool.RECIPES[recipe]
    cfg = tool.make_config(recipe, str(tmp_path), epochs)
    want = Config.load(str(ROOT / "configs" / name))
    _same_recipe(cfg, dataclasses.replace(
        want, **overrides, n_epochs=epochs, image_shape=(64, 64, 64)))
    assert (recipe, n_cases, epochs) in (("unet", 16, 40),
                                         ("isensee", 48, 100))
    summary = tool.main(recipe, str(tmp_path), epochs=2, device="cpu",
                        n_cases=4, image=16)
    assert summary["n_val_cases"] == 1 and summary["epochs_run"] == 2
    assert 0.0 <= summary["min_dice"] <= summary["mean_dice"] <= 1.0
    _launches(summary)
    tiny = Config.load(str(tmp_path / "config.json"))
    assert tiny.image_shape == (16, 16, 16)
    assert tiny.patch_shape == ((8, 8, 8) if recipe == "unet"
                                else (16, 16, 16))


def test_curve_record_finds_the_best_epoch_and_a_collapse(tmp_path):
    """A loss that falls to -0.9, rises 0.3+ above it at epoch 40 and stays
    there 25 epochs collapsed at 40; a rise that falls back within 25
    epochs did not."""
    common = _tool("torch_quality_common")

    def write(loss, val):
        path = tmp_path / "training.log"
        with open(path, "w") as f:
            f.write("epoch,loss,val_loss\n")
            for e, (a, b) in enumerate(zip(loss, val)):
                f.write(f"{e},{a},{b}\n")
        return str(path)

    fall = list(np.linspace(-0.1, -0.9, 30))
    val = [-v for v in range(70)]
    val[12] = -100.0
    risen = fall + [-0.85] * 10 + [-0.5] * 30
    rec = common.curve_record(write(risen, val))
    assert rec == {"best_val_epoch": 12, "best_val_loss": -100.0,
                   "collapse_epoch": 40}
    brief = fall + [-0.85] * 10 + [-0.5] * 24 + [-0.9] * 6
    assert common.curve_record(write(brief, val))["collapse_epoch"] is None


def test_multiclass_quality_seeds_runs_the_root_recipe(tmp_path,
                                                       monkeypatch):
    """``tools/multiclass_quality_seeds.py`` (JAX) at 4 cases of 16^3, 2
    epochs, seed 1, on one device: the root tool's config, ``train.main`` with the seed,
    the root tool's predict and evaluate, and the record with its keys."""
    tool = _load("multiclass_quality_seeds",
                 ROOT / "tools" / "multiclass_quality_seeds.py")
    monkeypatch.setattr(tool.recipe, "N_CASES", 4)
    monkeypatch.setattr(tool.recipe, "IMAGE", (16, 16, 16))
    # one device: the tests' CPU mesh of 8 does not divide the batch of 3
    make = tool.recipe.make_config
    monkeypatch.setattr(tool.recipe, "make_config", lambda *a, **k: (
        dataclasses.replace(make(*a, **k), num_devices=1)))
    (record,) = tool.main(str(tmp_path), 2, [1])
    out = tmp_path / "seed1"
    with open(out / "summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(record))
    assert record["seed"] == 1 and record["epochs"] == 2
    assert record["compute_dtype"] == "bfloat16"
    for key in ("1", "2", "4", "region_whole"):
        mean, low = record[key]
        assert 0.0 <= low <= mean <= 1.0
    assert record["passed"] == all(
        record[k][0] >= 0.95 for k in ("1", "2", "4", "region_whole"))
    assert record["best_val_epoch"] in (0, 1)
    assert record["collapse_epoch"] is None
    with open(out / "config.json") as f:
        assert tuple(json.load(f)["image_shape"]) == (16, 16, 16)
    assert len(os.listdir(out / "prediction")) == 1


def test_multiclass_sweep_runs_variants_and_counts_passes(tmp_path,
                                                           monkeypatch):
    """``tools/torch_multiclass_sweep.py`` on the CPU at 4 cases of 16^3,
    2 epochs: a kernels-on and an fp32 run in parallel processes, each
    summary in the table, the pass counts, and the one-sided Fisher test
    against JAX records (2 of 7 against 3 of 3 gives 21/252)."""
    sweep = _tool("torch_multiclass_sweep")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the runs' processes
    assert sweep.parse_runs(["on:0-2", "fp32:4,6"]) == [
        ("on", 0), ("on", 1), ("on", 2), ("fp32", 4), ("fp32", 6)]
    assert sweep.fisher_less(2, 7, 3, 3) == pytest.approx(21 / 252)
    assert sweep.fisher_less(3, 3, 0, 3) == 1.0
    jax_dir = tmp_path / "jax"
    for seed, passed in ((0, True), (1, False)):
        (jax_dir / f"seed{seed}").mkdir(parents=True)
        with open(jax_dir / f"seed{seed}" / "summary.json", "w") as f:
            json.dump({"seed": seed, "passed": passed}, f)
    result = sweep.main(str(tmp_path / "sweep"), [("on", 0), ("fp32", 1)],
                        epochs=2, parallel=2, device="cpu",
                        jax_dirs=[str(jax_dir)],
                        extra=["--n-cases", "4", "--image-size", "16"])
    assert result["failed"] == []
    assert [(r["variant"], r["seed"], r["compute_dtype"])
            for r in result["runs"]] == [("on", 0, "bfloat16"),
                                         ("fp32", 1, "float32")]
    assert result["counts"] == {"on": 1, "off": 0, "fp32": 1}
    assert result["jax"] == {"seeds": [0, 1], "passes": [0]}
    n_on = len(result["passes"]["on"])
    assert result["fisher_on_vs_jax"] == pytest.approx(
        sweep.fisher_less(n_on, 1, 1, 2))
    with open(tmp_path / "sweep" / "sweep.json") as f:
        assert json.load(f) == json.loads(json.dumps(result))
