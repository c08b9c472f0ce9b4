"""The port runs where there is no JAX stack: in a subprocess whose import
system refuses jax, jaxlib, flax, optax, orbax, h5py and the JAX package
itself, every port module imports, a tiny bf16 predict runs on the CPU
through the kernel routes, a direct predict with flips TTA, a
``DevicePreprocessor`` and one ``serve --once`` sweep run,
``train_model`` trains two epochs from an in-memory data file, and
Isensee2017 and a BatchNorm U-Net each predict and take two train steps,
and the experiment path runs end to end (a native dataset built from NIfTI
cases by ``train.main --device cpu`` for one epoch with scale and rotation
augmentation, the validation-set ``predict.main`` from the port's own
checkpoint, ``evaluate.main``, ``ensemble.main``; an HDF5 file at
``config.data_file`` raises and names the converter);
``device="cuda"`` raises on this CUDA-less machine; and ``chip_smoke.py``
exits non-zero without printing a result, in the repository and alone."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import importlib, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "h5py",
           "fetal_mri_segmentation_tpu"}


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused in this test")
        return None


sys.meta_path.insert(0, Refuse())

import numpy as np
import torch

import fetal_mri_segmentation_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.ops import conv3x3, dec0

torch.set_num_threads(1)
cfg = Config(image_shape=(12, 12, 12), patch_shape=(8, 8, 8), depth=2,
             n_base_filters=8, use_pallas_conv=True, use_pallas_dec0=True)
pred = SlidingWindowPredictor(build_model(cfg, "cpu"), cfg, cfg.image_shape,
                              overlap=2)
x = np.random.default_rng(0).normal(size=(1, 12, 12, 12)).astype(np.float32)
prob = pred(x)
labels = pred.predict_labels(x)
assert prob.shape == (1, 12, 12, 12) and np.isfinite(prob).all()
assert labels.shape == (12, 12, 12) and labels.dtype == np.uint8
assert conv3x3.conv3x3_flat.launches == 0
assert dec0.up_concat_conv3x3_kernel.launches == 0
try:
    build_model(cfg, "cuda")
except RuntimeError as e:
    assert "cuda" in str(e)
else:
    raise AssertionError("device='cuda' did not raise")

# serving: a direct predict with flips TTA, the device preprocessor and
# one watch-directory sweep through the serve entry point
import os, tempfile
from fetal_mri_segmentation_tpu_torch import serve
from fetal_mri_segmentation_tpu_torch.inference.predict import (
    make_device_preprocessor)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_direct_predictor)
from fetal_mri_segmentation_tpu_torch.utils.nifti import save_nifti
from fetal_mri_segmentation_tpu_torch.utils.params import init_flax_like

model = build_model(cfg, "cpu")
direct = make_direct_predictor(model, cfg, tta="flips", device="cpu")
prob = direct(x)
assert prob.shape == (1, 12, 12, 12) and np.isfinite(prob).all()
pre = make_device_preprocessor(model, cfg)
vol = np.random.default_rng(2).normal(100, 20, (14, 10, 13)).astype(
    np.float32)
staged = pre([vol])
assert staged.shape == (1, 12, 12, 12) and staged.dtype == torch.bfloat16
work = tempfile.mkdtemp()
watch = os.path.join(work, "watch")
for i in range(2):
    os.makedirs(os.path.join(watch, f"case_{i}"))
    save_nifti(vol + i, os.path.join(watch, f"case_{i}", "volume.nii.gz"),
               affine=np.diag([1.0, 1.2, 0.9, 1.0]))
np.savez(os.path.join(work, "params.npz"), **init_flax_like(cfg, seed=0))
stats = os.path.join(work, "stats.json")
n = serve.main(cfg, os.path.join(work, "params.npz"), watch,
               output=os.path.join(work, "served"), overlap=2, once=True,
               direct=True, tta="flips", device_preprocess=True,
               stats_file=stats, device="cpu", verbose=False)
assert n == 2, n
assert os.path.exists(os.path.join(work, "served", "case_1",
                                   "prediction.nii.gz"))
assert conv3x3.conv3x3_flat.launches == 0

# training: two epochs of train_model with augmentation on an in-memory
# data file, through the kernel routes, a checkpoint and its reload
from fetal_mri_segmentation_tpu_torch.data.memory import InMemoryDataFile
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
    get_training_and_validation_generators)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import CheckpointIO
from fetal_mri_segmentation_tpu_torch.training.loop import train_model
from fetal_mri_segmentation_tpu_torch.training.state import (
    create_train_state)

work = tempfile.mkdtemp()
tcfg = Config(image_shape=(12, 12, 12), patch_shape=(8, 8, 8), depth=2,
              n_base_filters=8, batch_size=2, validation_batch_size=2,
              use_pallas_conv=True, use_pallas_dec0=True, n_epochs=2,
              model_file=os.path.join(work, "m.pt"),
              training_file=os.path.join(work, "t.pkl"),
              validation_file=os.path.join(work, "v.pkl"),
              training_log=os.path.join(work, "log.csv"))
rng = np.random.default_rng(1)
truth = np.zeros((3, 1, 12, 12, 12), np.uint8)
truth[:, :, 3:9, 3:9, 3:9] = 1
data = (truth * 2.0 + rng.normal(0, 0.3, truth.shape)).astype(np.float32)
tg, n_t, vg, n_v = get_training_and_validation_generators(
    InMemoryDataFile(data, truth), batch_size=2, n_labels=1,
    training_keys_file=tcfg.training_file,
    validation_keys_file=tcfg.validation_file, data_split=0.7,
    patch_shape=tcfg.patch_shape, training_patch_start_offset=(2, 2, 2),
    seed=0)
model = build_model(tcfg, "cpu")
state = train_model(model, create_train_state(model, tcfg), tcfg, tg, vg,
                    n_t, n_v, verbose=False)
assert state.step == 2 * n_t
assert CheckpointIO(tcfg.model_file).peek_epoch() in (1, 2)

# Isensee2017 and a BatchNorm U-Net: a sliding-window predict and two train
# steps each (dropout and the weighted dice for Isensee)
from fetal_mri_segmentation_tpu_torch.models import Isensee2017
from fetal_mri_segmentation_tpu_torch.training.train_step import (
    make_train_step)

for kw in ({"model_name": "isensee", "n_segmentation_levels": 2},
           {"batch_normalization": True}):
    mcfg = Config(image_shape=(12, 12, 12), patch_shape=(8, 8, 8), depth=3,
                  n_base_filters=8, use_pallas_conv=True,
                  use_pallas_dec0=True, augment=False, **kw)
    model = build_model(mcfg, "cpu")
    assert isinstance(model, Isensee2017) == ("model_name" in kw)
    prob = SlidingWindowPredictor(model, mcfg, mcfg.image_shape, overlap=2)(x)
    assert prob.shape == (1, 12, 12, 12) and np.isfinite(prob).all()
    step = make_train_step(model, mcfg,
                           generator=torch.Generator().manual_seed(0))
    mstate = create_train_state(model, mcfg)
    xb = torch.from_numpy(data[:2, :, :8, :8, :8].copy())
    yb = torch.from_numpy(truth[:2, :, :8, :8, :8].astype(np.float32))
    for _ in range(2):
        metrics = step(mstate, xb, yb)
    assert torch.isfinite(metrics["loss"]) and mstate.step == 2
# the experiment path: synthetic cases -> train (builds the native dataset)
# -> predict the validation split from the checkpoint -> evaluate -> ensemble
import csv
from fetal_mri_segmentation_tpu_torch import ensemble, evaluate, predict, train
from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
from fetal_mri_segmentation_tpu_torch.data.synthetic import (
    write_synthetic_dataset)

work = tempfile.mkdtemp()
write_synthetic_dataset(os.path.join(work, "cases"), n_cases=4,
                        shape=(20, 20, 20))
ecfg = Config(image_shape=(16, 16, 16), patch_shape=(8, 8, 8), depth=2,
              n_base_filters=4, batch_size=4, n_epochs=1,
              compute_dtype="float32", validation_patch_overlap=2,
              training_patch_start_offset=(2, 2, 2), distort=0.25,
              rotate=15.0, contrast=0.1, validation_split=0.5,
              data_file=os.path.join(work, "data"),
              model_file=os.path.join(work, "model.ckpt"),
              training_file=os.path.join(work, "t.pkl"),
              validation_file=os.path.join(work, "v.pkl"),
              training_log=os.path.join(work, "training.log"))
estate = train.main(ecfg, os.path.join(work, "cases"), verbose=False,
                    device="cpu")
assert estate.step > 0 and os.path.isdir(ecfg.data_file)
with open_data_file(ecfg.data_file) as f:
    assert len(f) == 4 and f.subject_ids[0] == "case_0"
assert predict.main(ecfg, output_dir=os.path.join(work, "pred"),
                    device="cpu", verbose=False) == 2
rows = evaluate.main(os.path.join(work, "pred"), [1],
                     os.path.join(work, "scores.csv"), plot=False,
                     surface_metrics=True)
assert len(rows) == 2
with open(os.path.join(work, "scores.csv")) as f:
    assert len(list(csv.reader(f))) == 3
for tag in ("a", "b"):
    predict.main(ecfg, output_dir=os.path.join(work, "prob_" + tag),
                 device="cpu", verbose=False, prob_map=True,
                 direct=tag == "b")
assert ensemble.main([os.path.join(work, "prob_a"),
                      os.path.join(work, "prob_b")],
                     os.path.join(work, "ens"), labels=[1]) == 2
# an HDF5 file cannot be read here (h5py is refused): the error names the
# converter
open(os.path.join(work, "data.h5"), "wb").close()
try:
    open_data_file(os.path.join(work, "data.h5"))
except ImportError as e:
    assert "--convert" in str(e)
else:
    raise AssertionError("an HDF5 dataset opened without h5py")

loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
assert not loaded, loaded
print("imported", len(names), "modules")
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def test_port_imports_and_predicts_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd, env = tmp_path, {k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"}
    else:
        cwd, env = ROOT, _env()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
