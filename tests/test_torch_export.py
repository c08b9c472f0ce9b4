"""The port's portable program (``utils/export.py``) on the CPU: the
artifact exported and loaded here against the live port predictor and
against the JAX package's ``export_predictor`` / ``load_predictor`` on the
same weights (fp32, fold off), for the sliding window, flips TTA and the
direct predictor; the loader in a subprocess that refuses the port's model
modules; the file's ``ValueError`` contract; ``platforms``; ``predict.main
--export``; and the ``["cuda"]`` program's graph, traced here on the meta
device with the kernel switches on: it holds the kernels as the
``fetal::`` custom ops, 6 / 4 / 3 of them per forward at the full width of
``configs/fetal_unet.json``, as the live path launches them.

Tolerance: the label maps equal the live port predictor's bit for bit (the
same program), and the JAX artifact's wherever the port's probability lies
further than ``PROB_MARGIN`` from the threshold (two fp32 programs that
sum in another order may put a voxel at the threshold on either side).
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.utils import export as jax_export  # noqa: E402
from fetal_mri_segmentation_tpu_torch import predict as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import conv3x3, dec0  # noqa: E402
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (  # noqa: E402
    make_direct_predictor)
from fetal_mri_segmentation_tpu_torch.utils import export  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PROB_MARGIN = 1e-4
KW = dict(image_shape=(12, 12, 12), patch_shape=(8, 8, 8), depth=2,
          n_base_filters=8, compute_dtype="float32", fold_level0="off",
          use_pallas_conv=True, use_pallas_dec0=True)
EXPORT_KW = dict(overlap=4, patch_batch_size=27)


def _volume(seed=3, shape=(12, 12, 12)):
    return np.random.default_rng(seed).normal(
        0, 1, (1,) + shape).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """The JAX model and variables, and the port's model on the same
    weights."""
    jcfg = JaxConfig(**KW)
    jmodel = jax_build(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            np.zeros((1, 8, 8, 8, 1), np.float32))
    cfg = Config(**KW)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(flatten_dict(variables["params"],
                                                 sep="/")))
    return jcfg, jmodel, variables, cfg, model


def _live(model, cfg, direct, tta):
    if direct:
        return make_direct_predictor(model, cfg, tta=tta, device="cpu")
    return SlidingWindowPredictor(model, cfg, cfg.image_shape, tta=tta,
                                  **EXPORT_KW)


@pytest.mark.parametrize("direct,tta", [(False, False), (False, "flips"),
                                        (True, False)], ids=str)
def test_artifact_equals_live_predictor_and_jax(weights, tmp_path, direct,
                                                tta):
    jcfg, jmodel, variables, cfg, model = weights
    path = str(tmp_path / "model.fetal")
    export.export_predictor(model, cfg, cfg.image_shape, path, tta=tta,
                            direct=direct, **EXPORT_KW)
    # the trace ran with the switches off and left them as configured
    assert model.enc0_conv2.use_kernel_conv and model.dec0_conv1.use_kernel_dec0
    predict = export.load_predictor(path, device="cpu")
    assert predict.meta["platforms"] == ["cuda", "cpu"]
    assert predict.meta["direct"] is direct and predict.meta["tta"] == tta
    vol = _volume()
    got = predict(vol)
    live = _live(model, cfg, direct, tta)
    assert got.dtype == np.uint8 and got.shape == cfg.image_shape
    np.testing.assert_array_equal(got, live.predict_labels(vol))

    jpath = str(tmp_path / "jax.fetal")
    jax_export.export_predictor(jmodel, jcfg, variables, jcfg.image_shape,
                                jpath, tta=tta, platforms=["cpu"],
                                direct=direct, **EXPORT_KW)
    want = jax_export.load_predictor(jpath)(vol)
    prob = live(vol)[0]
    far = np.abs(prob - 0.5) > PROB_MARGIN
    assert far.mean() > 0.5
    np.testing.assert_array_equal(got[far], want[far])


def test_multiclass_labels_widen_like_jax(tmp_path):
    """A softmax model whose labels do not fit uint8: the artifact's label
    map is uint16, as the JAX package's ``label_map_dtype`` chooses."""
    cfg = Config(**{**KW, "n_labels": 2, "labels": (1, 300),
                    "activation_name": "softmax"})
    model = build_model(cfg, "cpu")
    path = str(tmp_path / "multi.fetal")
    export.export_predictor(model, cfg, cfg.image_shape, path, direct=True)
    predict = export.load_predictor(path, device="cpu")
    vol = _volume(5)
    got = predict(vol)
    assert predict.meta["label_dtype"] == "uint16" and got.dtype == np.uint16
    np.testing.assert_array_equal(
        got, make_direct_predictor(model, cfg, device="cpu")
        .predict_labels(vol))


def test_isensee_artifact_equals_live_predictor(tmp_path):
    """Isensee2017's InstanceNorm modules carry flax's name "in", a Python
    keyword: the program is traced with them renamed and loads; the model
    keeps its names."""
    cfg = Config(**{**KW, "model_name": "isensee", "depth": 3,
                    "n_segmentation_levels": 2})
    model = build_model(cfg, "cpu")
    names = list(model.state_dict())
    path = str(tmp_path / "isensee.fetal")
    export.export_predictor(model, cfg, cfg.image_shape, path, **EXPORT_KW)
    assert list(model.state_dict()) == names
    vol = _volume(6)
    np.testing.assert_array_equal(
        export.load_predictor(path, device="cpu")(vol),
        _live(model, cfg, False, False).predict_labels(vol))


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    _, _, _, cfg, model = weights
    path = str(tmp_path_factory.mktemp("export") / "model.fetal")
    export.export_predictor(model, cfg, cfg.image_shape, path, direct=True)
    return path, cfg, model


@pytest.mark.parametrize("damage", ["magic", "meta", "program"])
def test_bad_or_truncated_file_raises_value_error(artifact, tmp_path,
                                                  damage):
    path = artifact[0]
    with open(path, "rb") as f:
        raw = f.read()
    head = len(export._MAGIC) + 4
    (meta_len,) = struct.unpack("<I", raw[len(export._MAGIC):head])
    cut = {"magic": b"NOTANEXPORT" + raw[11:],
           "meta": raw[:head + meta_len // 2],
           "program": raw[:head + meta_len + (len(raw) - head - meta_len)
                          // 2]}[damage]
    bad = str(tmp_path / "bad.fetal")
    with open(bad, "wb") as f:
        f.write(cut)
    match = "not a fetal export" if damage == "magic" else "truncated"
    with pytest.raises(ValueError, match=match):
        export.load_predictor(bad, device="cpu")


def test_platforms_cuda_raises_without_the_card(artifact, tmp_path):
    """``["cuda"]`` keeps the kernels in the program: with the model on the
    CPU it raises, and never writes a portable artifact in its place. An
    unknown platform raises too, and a CUDA-only artifact refuses a CPU
    device at load."""
    _, cfg, model = artifact
    path = str(tmp_path / "cuda.fetal")
    with pytest.raises(RuntimeError, match="CUDA device"):
        export.export_predictor(model, cfg, cfg.image_shape, path,
                                platforms=["cuda"])
    assert not os.path.exists(path)
    with pytest.raises(ValueError, match="at most once"):
        export.export_predictor(model, cfg, cfg.image_shape, path,
                                platforms=["tpu"])
    with open(artifact[0], "rb") as f:
        raw = f.read()
    head = len(export._MAGIC) + 4
    (meta_len,) = struct.unpack("<I", raw[len(export._MAGIC):head])
    meta = json.loads(raw[head:head + meta_len])
    meta["platforms"] = ["cuda"]
    blob = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(export._MAGIC + struct.pack("<I", len(blob)) + blob
                + raw[head + meta_len:])
    with pytest.raises(ValueError, match=r"exported for \['cuda'\]"):
        export.load_predictor(path, device="cpu")


LOADER = r'''
import sys

BLOCKED = ("jax", "flax", "fetal_mri_segmentation_tpu.",
           "fetal_mri_segmentation_tpu_torch.models",
           "fetal_mri_segmentation_tpu_torch.inference",
           "fetal_mri_segmentation_tpu_torch.parallel",
           "fetal_mri_segmentation_tpu_torch.training")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.startswith(BLOCKED) or name == "fetal_mri_segmentation_tpu":
            raise ImportError(f"{name} is refused in this test")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch

torch.set_num_threads(1)
from fetal_mri_segmentation_tpu_torch.utils.export import load_predictor

predict = load_predictor(sys.argv[1], device="cpu")
np.save(sys.argv[3], predict(np.load(sys.argv[2])))
loaded = [m for m in sys.modules if m.startswith(
    "fetal_mri_segmentation_tpu_torch.")]
print(sorted(loaded))
'''


def test_loader_needs_no_model_modules(artifact, tmp_path):
    path, cfg, model = artifact
    vol = _volume(9)
    np.save(tmp_path / "vol.npy", vol)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-c", LOADER, path, str(tmp_path / "vol.npy"),
         str(tmp_path / "labels.npy")], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "models" not in out.stdout and "inference" not in out.stdout
    np.testing.assert_array_equal(
        np.load(tmp_path / "labels.npy"),
        make_direct_predictor(model, cfg, device="cpu").predict_labels(vol))


def test_predict_main_exports(weights, tmp_path):
    """``predict.main(export_path=...)`` writes the artifact of the
    config's image shape from the port's checkpoint and predicts nothing."""
    _, _, _, cfg, model = weights
    from fetal_mri_segmentation_tpu_torch.training.checkpoint import (
        CheckpointIO)
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)

    cfg = dataclasses.replace(cfg, model_file=str(tmp_path / "model.ckpt"),
                              validation_patch_overlap=4)
    CheckpointIO(cfg.model_file).save(create_train_state(model, cfg),
                                      epoch=1, best_val=-0.5)
    path = str(tmp_path / "main.fetal")
    assert entry.main(cfg, export_path=path, device="cpu", direct=True,
                      verbose=False) is None
    vol = _volume(4)
    np.testing.assert_array_equal(
        export.load_predictor(path, device="cpu")(vol),
        make_direct_predictor(model, cfg, device="cpu").predict_labels(vol))
    with pytest.raises(ValueError, match="not exportable"):
        entry.main(cfg, export_path=path, prob_map=True, device="cpu")


def test_kernel_ops_fake_shapes_equal_the_plain_versions():
    """The ops' fake implementations on meta tensors give the plain
    versions' shapes and dtypes (the kernels store bf16)."""
    x = torch.zeros(2, 4, 6, 8, 16, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 16, 24, dtype=torch.bfloat16)
    b = torch.zeros(24)
    want = conv3x3.conv3x3_reference(x, w, b, "relu")
    got = torch.ops.fetal.conv3x3(x.to("meta"), w.to("meta"), b.to("meta"),
                                  "relu", 0.01, "conv3x3")
    assert (got.shape, got.dtype, got.stride()) == (
        want.shape, want.dtype, want.contiguous().stride())
    xd = torch.zeros(1, 2, 3, 4, 16, dtype=torch.bfloat16)
    skip = torch.zeros(1, 4, 6, 8, 8, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 3, 24, 8, dtype=torch.bfloat16)
    want = dec0.up_concat_conv3x3_reference(xd, skip, k, torch.zeros(8))
    got = torch.ops.fetal.up_concat_conv3x3(
        xd.to("meta"), skip.to("meta"), k.to("meta"),
        torch.zeros(8, device="meta"), "none", 0.3)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    # no CPU implementation: the op reached with a CPU tensor raises
    with pytest.raises(NotImplementedError):
        torch.ops.fetal.conv3x3(x, w, b, "relu", 0.01, "conv3x3")


@pytest.mark.parametrize("name", ["fetal_unet", "fetal_isensee"])
def test_cuda_program_holds_the_kernel_ops(name):
    """The ``["cuda"]`` program's graph, traced on the meta device at the
    config's full width with the kernel switches on: the sliding window's
    one batch of 27 patches holds one forward's worth of ``fetal::`` ops
    (U-Net 6 / 4 / 3, Isensee 6 / 8 / 0) and no stock convolution where
    the live path launches a kernel."""
    cfg = Config.load(str(ROOT / "configs" / f"{name}.json"))
    cfg = dataclasses.replace(cfg, use_pallas_conv=True, use_pallas_dec0=True,
                              image_shape=(128, 128, 128))
    model = build_model(cfg, "cpu").to("meta")
    predictor = SlidingWindowPredictor(model, cfg, cfg.image_shape,
                                       overlap=16, patch_batch_size=27)
    assert predictor.n_batches == 1
    program = export.LabelProgram(predictor, 0.5, direct=False)
    with torch.no_grad():
        ep = torch.export.export(program, (torch.zeros(
            (1,) + cfg.image_shape, device="meta"),))
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    counts = {"conv3x3": 0, "conv3x3_flat": 0, "dec0": 0}
    for n in calls:
        if n.target == torch.ops.fetal.conv3x3.default:
            counts[n.args[5]] += 1
        elif n.target == torch.ops.fetal.up_concat_conv3x3.default:
            counts["dec0"] += 1
    want = ({"conv3x3": 6, "conv3x3_flat": 4, "dec0": 3}
            if name == "fetal_unet" else
            {"conv3x3": 6, "conv3x3_flat": 8, "dec0": 0})
    assert counts == want
    stock = sum(1 for n in calls if n.target == torch.ops.aten.conv3d.default)
    # U-Net: the stem and the head. Isensee: the stem, 4 strided convs, 4
    # 1^3 localization convs, 3 heads and the 4 fused up-sampling modules'
    # 8 parity convs each (no kernel on that path)
    assert stock == {"fetal_unet": 2, "fetal_isensee": 1 + 4 + 4 + 3 + 32}[
        name]
