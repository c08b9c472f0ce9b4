"""The port runs where there is no JAX stack: in a subprocess whose import
system refuses jax, jaxlib, flax, optax, orbax, h5py and the JAX package
itself, every port module imports, a tiny bf16 predict runs on the CPU
through the kernel routes, a direct predict with flips TTA, a
``DevicePreprocessor`` and one ``serve --once`` sweep run,
``train_model`` trains two epochs from an in-memory data file, and
a fold config predicts and the native patch loader copies patches,
Isensee2017 and a BatchNorm U-Net each predict and take two train steps,
and the experiment path runs end to end (a native dataset built from NIfTI
cases by ``train.main --device cpu`` for one epoch with scale and rotation
augmentation, the validation-set ``predict.main`` from the port's own
checkpoint, ``evaluate.main``, ``ensemble.main``; an HDF5 file at
``config.data_file`` raises and names the converter); interop runs as far
as it can without h5py and Keras (the Keras mapping through a weight list,
``load_old_model`` refused with h5py named, the portable program exported
and loaded);
the device case cache and the data mesh run too (``train.main`` with
``device_case_cache="on"`` equal to "off", and one rank that joins a gloo
group through ``initialize_distributed`` and takes a data-parallel cached
step, a GSPMD step on a 1 x 1 hybrid mesh and predicts with the spatial
and the patch-grid sharded predictors);
a bf16 Swin UNETR predicts through the sliding window near the plain
reference ``reference/swin_unetr.py`` (imported under the same refusals),
and so does a bf16 MedNeXt near ``reference/mednext.py``;
``device="cuda"`` raises on this CUDA-less machine (the port's bench,
``fetal_mri_segmentation_tpu_torch.bench``, imports with the root
``bench.py`` refused too); and ``chip_smoke.py``
exits non-zero without printing a result, in the repository and alone.
The quality-loop tools (``tools/torch_parity_dice.py``,
``torch_multiclass_quality.py``, ``torch_quality_loops.py``,
``torch_multiclass_sweep.py`` and their ``torch_quality_common.py``)
import under the same refusals and make their recipes' configs."""

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
           "fetal_mri_segmentation_tpu", "bench"}


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

# the port's bench: imported by the walk above, with the root bench.py
# ("bench") refused
assert "fetal_mri_segmentation_tpu_torch.bench" in names

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
# a fold config predicts the same probabilities up to bf16 rounding; the
# native loader copies patches
import dataclasses
from fetal_mri_segmentation_tpu_torch.ops import patches as port_patches
from fetal_mri_segmentation_tpu_torch.utils import native
fold_cfg = dataclasses.replace(cfg, fold_level0=(1, 1, 2))
fold_model = build_model(fold_cfg, "cpu")
fold_model.load_state_dict(pred.model.state_dict())
assert np.abs(SlidingWindowPredictor(fold_model, fold_cfg, cfg.image_shape,
                                     overlap=2)(x) - prob).max() < 2e-2
assert native.available()
assert np.array_equal(port_patches.get_patch_from_3d_data(
    x, (8, 8, 8), (-2, 5, 6)), native.extract_patch(x, (8, 8, 8), (-2, 5, 6)))
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
# the device case cache ("auto" above trained from it): "on" and "off" train
# the same model; then one rank joins a gloo group as a launcher would have
# it and takes a cached data-parallel step
import dataclasses
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import make_mesh
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    free_port, initialize_distributed, rank_environment,
    shutdown_distributed)
from fetal_mri_segmentation_tpu_torch.pipeline import device_cache

finals = []
for knob in ("on", "off"):
    ccfg = dataclasses.replace(
        ecfg, device_case_cache=knob, overwrite=True,
        model_file=os.path.join(work, f"model_{knob}.ckpt"),
        training_log=os.path.join(work, f"training_{knob}.log"))
    cstate = train.main(ccfg, os.path.join(work, "cases"), verbose=False,
                        device="cpu")
    finals.append(torch.cat([p.detach().reshape(-1)
                             for p in cstate.model.parameters()]))
assert torch.equal(finals[0], finals[1])
launcher = rank_environment(0, 1, free_port())
os.environ.update(launcher)
initialize_distributed(device="cpu")
mesh = make_mesh(1, device="cpu")
assert mesh.group is not None and (mesh.rank, mesh.size) == (0, 1)
with open_data_file(ecfg.data_file) as f:
    cache, tgen, _ = device_cache.maybe_build_device_cache(
        f, ecfg, mesh=mesh, seed=0)
    rows, corners, n_valid = next(tgen)
dmodel = build_model(ecfg, "cpu")
dstep = device_cache.make_cached_dp_train_step(
    dmodel, ecfg, mesh, cache.margin_lo,
    generator=torch.Generator().manual_seed(0))
metrics = dstep(create_train_state(dmodel, ecfg), cache.data_stack,
                cache.truth_stack, torch.from_numpy(rows),
                torch.from_numpy(corners), n_valid)
assert torch.isfinite(metrics["loss"])
# multi-device inference and spatial sharding on the same one-rank group:
# a GSPMD step on a 1 x 1 hybrid mesh, the spatial predictor on it, and the
# patch-grid sharded predictor on the data mesh
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    make_sharded_predictor)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_gspmd_train_step, make_hybrid_mesh, make_spatial_predictor)

hmesh = make_hybrid_mesh(1, 1, device="cpu")
assert hmesh.group is not None and hmesh.spatial_group is None
smodel = build_model(ecfg, "cpu")
sstep = make_gspmd_train_step(smodel, ecfg, hmesh,
                              generator=torch.Generator().manual_seed(0))
metrics = sstep(create_train_state(smodel, ecfg),
                torch.from_numpy(data[:2, :, :8, :8, :8].copy()),
                torch.from_numpy(truth[:2, :, :8, :8, :8].astype(np.float32)))
assert torch.isfinite(metrics["loss"])
vol = np.random.default_rng(3).normal(size=(1, 16, 16, 16)).astype(
    np.float32)
for pred in (make_spatial_predictor(smodel, ecfg, hmesh),
             make_sharded_predictor(SlidingWindowPredictor(
                 smodel, ecfg, (16, 16, 16), overlap=2), mesh)):
    prob = pred(vol)
    assert prob.shape == (1, 16, 16, 16) and np.isfinite(prob).all()
shutdown_distributed()
for key in launcher:
    del os.environ[key]

# an HDF5 file cannot be read here (h5py is refused): the error names the
# converter
open(os.path.join(work, "data.h5"), "wb").close()
try:
    open_data_file(os.path.join(work, "data.h5"))
except ImportError as e:
    assert "--convert" in str(e)
else:
    raise AssertionError("an HDF5 dataset opened without h5py")

# interop where h5py and Keras are absent: the Keras mapping through a
# weight list (chip_smoke.py's stand-in), --from-keras refused with h5py
# named, a blosc dataset refused with the converter named, and the
# portable program exported and loaded on the CPU
from fetal_mri_segmentation_tpu_torch.utils.export import (
    export_predictor, load_predictor)
from fetal_mri_segmentation_tpu_torch.utils.keras_export import (
    export_keras_unet_weights)
from fetal_mri_segmentation_tpu_torch.utils.keras_import import (
    keras_state_dict, keras_weight_list_from_model)
from fetal_mri_segmentation_tpu_torch.utils.keras_migrate import (
    load_old_model)

icfg = Config(image_shape=(12, 12, 12), patch_shape=(8, 8, 8), depth=2,
              n_base_filters=8, deconvolution=True, compute_dtype="float32")
imodel = build_model(icfg, "cpu")
stand_in = chip_smoke.keras_stand_in(icfg)
export_keras_unet_weights(imodel, stand_in)
back = keras_state_dict(icfg, keras_weight_list_from_model(stand_in))
assert all(torch.equal(back[k], v) for k, v in imodel.state_dict().items())
try:
    load_old_model(os.path.join(work, "model.h5"), device="cpu")
except ImportError as e:
    assert "h5py" in str(e), e
else:
    raise AssertionError("--from-keras ran without h5py")
artifact = os.path.join(work, "model.fetal")
export_predictor(imodel, icfg, icfg.image_shape, artifact, overlap=2,
                 direct=True)
got = load_predictor(artifact, device="cpu")(x)
want = make_direct_predictor(imodel, icfg, device="cpu").predict_labels(x)
assert np.array_equal(got, want)

# Swin UNETR: the port's bf16 sliding window and the plain reference
# (reference/swin_unetr.py, which imports nothing of the port) on one 32^3
# patch
from reference import swin_unetr as swin_ref
from fetal_mri_segmentation_tpu_torch.ops import window_attention
scfg = Config(model_name="swin_unetr", n_base_filters=12,
              image_shape=(32, 32, 32), patch_shape=(32, 32, 32))
smodel = build_model(scfg, "cpu")
sx = np.random.default_rng(2).normal(size=(1, 32, 32, 32)).astype(np.float32)
sprob = SlidingWindowPredictor(smodel, scfg, scfg.image_shape, overlap=0)(sx)
with torch.no_grad():
    slogit = swin_ref.forward(
        {k: v.float() for k, v in smodel.state_dict().items()},
        torch.from_numpy(sx)[None], {"n_base_filters": 12, "n_labels": 1})
assert np.abs(sprob - torch.sigmoid(slogit)[0].numpy()).max() < 0.05
assert window_attention.window_attention.calls["composite"] == 8

# MedNeXt (L tables, kernel 5): the port's bf16 sliding window and the plain
# reference (reference/mednext.py) on one 32^3 patch
from reference import mednext as mednext_ref
mcfg = Config(model_name="mednext", n_base_filters=8, mednext_size="L",
              mednext_kernel=5, image_shape=(32, 32, 32),
              patch_shape=(32, 32, 32))
mmodel = build_model(mcfg, "cpu")
mprob = SlidingWindowPredictor(mmodel, mcfg, mcfg.image_shape, overlap=0)(sx)
with torch.no_grad():
    mlogit = mednext_ref.forward(
        {k: v.float() for k, v in mmodel.state_dict().items()},
        torch.from_numpy(sx)[None],
        {"n_base_filters": 8, "n_labels": 1, "mednext_size": "L",
         "mednext_kernel": 5})
assert np.abs(mprob - torch.sigmoid(mlogit)[0].numpy()).max() < 0.05

loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
assert not loaded, loaded
print("imported", len(names), "modules")
'''


TOOLS_SCRIPT = r'''
import sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "h5py",
           "fetal_mri_segmentation_tpu"}


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused in this test")
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, "tools")

import torch_multiclass_quality
import torch_multiclass_sweep
import torch_parity_dice
import torch_quality_common
import torch_quality_loops

configs = [torch_parity_dice.make_config("out", "out/data"),
           torch_multiclass_quality.make_config("out", 500),
           torch_multiclass_quality.make_config("out", 500, softmax=True),
           torch_quality_loops.make_config("unet", "out", 40),
           torch_quality_loops.make_config("isensee", "out", 100)]
assert all(c.use_pallas_conv and c.use_pallas_dec0 for c in configs)
torch_quality_common.zero_launches()
assert set(torch_quality_common.read_launches().values()) == {0}
assert torch_quality_common.card("cpu") == "cpu"
assert torch_multiclass_sweep.parse_runs(["on:0-1"]) == [("on", 0), ("on", 1)]
loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
assert not loaded, loaded
print("tools ok")
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


def test_quality_tools_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", TOOLS_SCRIPT], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "tools ok" in proc.stdout


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
