"""The port's depth-axis spatial sharding (``parallel/spatial.py``,
``parallel/collectives.py::halo_exchange``, the conv blocks and
InstanceNorm on slabs) on the CPU: gloo ranks started once per mesh as
subprocesses (``tests/test_torch_spatial_worker.py``), two for a 1 x 2 mesh
and four for a 2 x 2 one, both at once, against the port's single-device
step on the same global batch and against the JAX package's
``make_gspmd_train_step`` / ``make_spatial_predictor`` on
``make_hybrid_mesh`` over conftest's virtual devices (fp32, fold off,
augmentation off, plain SGD at learning rate 1 as in
``tests/test_torch_parallel.py``: the parameter change is minus the
gradient).

Tolerances: without a norm the loss atol 1e-6 and every parameter atol
1e-5, the JAX package's own (``tests/test_spatial.py::
test_gspmd_step_matches_single_device``); with BatchNorm or InstanceNorm
the parameters atol 1e-4 (the conv in front of a norm has the largest
gradients and the moments are summed in another order) and BatchNorm's
buffers atol 1e-5; probabilities atol 1e-5; label maps bit for bit. The
halo exchange and each conv block on a slab are held to the whole tensor
within 1e-6 (forward, absolute) and 1e-5 (gradients, relative to the
largest entry over the block's parameters). ``train.main`` with
``spatial_devices=2`` starts its own two ranks and trains like one device.
The ``reshard`` scenarios and predictions take a depth of 12 at depth 3:
a 2-rank slab goes 6 -> 3, a 4-rank one is 3 rows, and the models gather
the level that cannot be halved (``models/layers.py::gather_level``), as
XLA reshards it; they are held to the same tolerances.
"""

import csv
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.parallel import (  # noqa: E402
    make_gspmd_eval_step as jax_eval, make_gspmd_train_step as jax_step,
    make_hybrid_mesh as jax_mesh, make_spatial_predictor as jax_predictor,
    shard_batch_spatial as jax_shard)
from fetal_mri_segmentation_tpu.training import (  # noqa: E402
    create_train_state as jax_state)
from fetal_mri_segmentation_tpu_torch import train as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.layers import (  # noqa: E402
    gather_level)
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (  # noqa: E402
    free_port)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (  # noqa: E402
    HybridMesh, SpatialPredictor, make_hybrid_mesh, shard_batch_spatial)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402
from tests import test_torch_spatial_worker as W  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300
NORMS = ("batchnorm", "isensee")
# the spatial predictor's cases held to the JAX one too
JAX_PREDICTIONS = (("unet", False), ("unet", "flips"), ("isensee", False))


def _flat(variables):
    flat = {f"params/{k}": v for k, v in flatten_dict(
        variables["params"], sep="/").items()}
    flat.update({f"batch_stats/{k}": v for k, v in flatten_dict(
        variables.get("batch_stats") or {}, sep="/").items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _start_ranks(world, work):
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "test_torch_spatial_worker.py"),
         str(rank), str(world), str(port), work], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, one, ranks)``: per mesh and scenario the JAX GSPMD step, the
    port's single-device step, and what each gloo rank saved (keyed by
    world size). The ranks of both meshes run while the JAX side
    compiles."""
    work = str(tmp_path_factory.mktemp("torch_spatial"))
    states = {}
    for name, (kw, _) in W.SCENARIOS.items():
        jcfg = W.scenario_config(JaxConfig, **kw)
        jmodel = jax_build(jcfg)
        js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0),
                       tx=optax.sgd(1.0))
        torch.save(from_flax(_flat({"params": js.params,
                                    "batch_stats": js.batch_stats})),
                   os.path.join(work, f"{name}.init.pt"))
        states[name] = (jcfg, jmodel)
    predictors = {}
    for name, kw in W.PREDICTORS.items():
        jcfg = W.scenario_config(JaxConfig, **kw)
        jmodel = jax_build(jcfg)
        params = jax_state(jmodel, jcfg, jax.random.PRNGKey(1)).params
        torch.save(from_flax(_flat({"params": params})),
                   os.path.join(work, f"predict_{name}.init.pt"))
        predictors[name] = (jcfg, jmodel, {"params": params})
    procs = {world: _start_ranks(world, work) for world in W.MESHES}
    try:
        reference = {}
        for world, shape in W.MESHES.items():
            mesh = jax_mesh(*shape)
            for name in W.JAX_SCENARIOS:
                jcfg, jmodel = states[name]
                x, y, n_valid = W.scenario_batch(name)
                # a fresh state each time: the step donates it
                js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0),
                               tx=optax.sgd(1.0))
                new, m = jax_step(jmodel, jcfg, mesh)(
                    js, *jax_shard(mesh, x, y), jax.random.PRNGKey(0),
                    jnp.asarray(n_valid))
                ref = dict(loss=float(m["loss"]), dice=float(m["dice"]),
                           state_dict=from_flax(_flat({
                               "params": new.params,
                               "batch_stats": new.batch_stats})))
                if world == 4 and name in ("plain", "isensee_partial"):
                    ev = jax_eval(jmodel, jcfg, mesh)
                    xs, ys = jax_shard(mesh, x, y)
                    ref["eval_loss"] = float(ev(new, xs, ys)["loss"])
                    ref["eval_loss_valid"] = float(
                        ev(new, xs, ys, jnp.asarray(n_valid))["loss"])
                reference[(world, name)] = ref
        for (name, tta) in JAX_PREDICTIONS:
            jcfg, jmodel, variables = predictors[name]
            reference[("predict", name, tta)] = jax_predictor(
                jmodel, jcfg, jax_mesh(1, 2), tta=tta)(variables, W.volume())
        one = W.run_scenarios(None, work)
        outputs = {world: [p.communicate(timeout=RANK_TIMEOUT_S)[0]
                           for p in ps] for world, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for world, ps in procs.items():
        for p, o in zip(ps, outputs[world]):
            assert p.returncode == 0, f"rank of {world} failed:\n{o[-3000:]}"
    ranks = {world: [torch.load(os.path.join(work, f"rank{r}_of{world}.pt"),
                                weights_only=False) for r in range(world)]
             for world in W.MESHES}
    return reference, one, ranks


def _close(a, b, what, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("world", sorted(W.MESHES))
@pytest.mark.parametrize("name", sorted(W.SCENARIOS))
def test_hybrid_step_equals_one_device_and_jax(runs, world, name):
    """Loss, dice and every updated parameter and buffer of the GSPMD step
    on every rank, identical on all of them, against the single-device
    step and (without dropout) the JAX GSPMD step on the same mesh."""
    reference, one, ranks = runs
    single = one[name]
    got = [r["scenarios"][name] for r in ranks[world]]
    assert [r["coords"] for r in ranks[world]] == [
        divmod(rank, W.MESHES[world][1]) for rank in range(world)]
    param_atol = 1e-4 if name.startswith(NORMS) else 1e-5
    refs = [single] + ([reference[(world, name)]]
                       if name in W.JAX_SCENARIOS else [])
    for ref in refs:
        for key in ("loss", "dice"):
            _close(got[0][key], ref[key], key, 1e-6)
        assert set(got[0]["state_dict"]) == set(ref["state_dict"])
        for k, v in got[0]["state_dict"].items():
            buffer = k.endswith((".mean", ".var"))
            _close(v, ref["state_dict"][k], k, 1e-5 if buffer else param_atol)
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"] and r["dice"] == got[0]["dice"]
        for k, v in r["state_dict"].items():
            assert torch.equal(v, got[0]["state_dict"][k]), f"{k} by rank"


@pytest.mark.parametrize("world", sorted(W.MESHES))
@pytest.mark.parametrize("name", sorted(W.SCENARIOS))
def test_eval_step_with_and_without_n_valid(runs, world, name):
    """The GSPMD eval step's global loss after the train step, over the
    whole batch and over its first ``n_valid`` samples, against one device
    (and the JAX GSPMD eval step where the fixture ran it)."""
    reference, one, ranks = runs
    ref = reference.get((world, name), {})
    for r in ranks[world]:
        got = r["scenarios"][name]
        for key in ("eval_loss", "eval_loss_valid", "eval_dice"):
            _close(got[key], one[name][key], key, 1e-6)
            if key in ref:
                _close(got[key], ref[key], f"{key} against JAX", 1e-6)
    assert ("eval_loss" in ref) == (
        world == 4 and name in ("plain", "isensee_partial"))


@pytest.mark.parametrize("halo", [(1, 1), (2, 2), (0, 1)], ids=str)
def test_halo_exchange_and_its_gradient(runs, halo):
    """Each rank's halo'd slab equals its window of the zero-padded whole
    tensor, and the gradient of a loss over every rank's halo'd slab,
    gathered, equals autograd's through the padded whole tensor."""
    _, _, ranks = runs
    for r in ranks[2]:
        assert r["halo"][halo] == {"forward": 0.0, "grad": 0.0}, r["halo"]


@pytest.mark.parametrize("block", sorted(W.BLOCKS) + ["instance norm"])
def test_conv_block_on_a_slab_equals_the_whole_tensor(runs, block):
    """A stride-1 conv (kernel route and plain), the stride-2 SAME conv with
    InstanceNorm, a 1^3 conv, the fused decoder with and without a skip and
    InstanceNorm alone: this rank's output rows and the parameters'
    gradients summed over the ranks."""
    _, _, ranks = runs
    for r in ranks[2]:
        got = r["blocks"][block]
        assert got["forward"] <= 1e-6 and got["grad"] <= 1e-5, (block, got)


@pytest.mark.parametrize("name,tta", [("unet", False), ("unet", "flips"),
                                      ("isensee", False),
                                      ("isensee", "flips")], ids=str)
def test_spatial_predictor_on_two_ranks(runs, name, tta):
    """Probabilities on both ranks (the whole volume) against the
    single-device direct predictor and the JAX spatial predictor on a 1 x 2
    mesh within 1e-5; the label map bit for bit against the direct one."""
    reference, _, ranks = runs
    for r in ranks[2]:
        got = r["predictor"][(name, tta)]
        assert got["spatial"].shape == (1,) + W.VOLUME
        _close(got["spatial"], got["direct"], "direct", 1e-5)
        np.testing.assert_array_equal(got["labels"], got["direct_labels"])
        if (name, tta) in JAX_PREDICTIONS:
            _close(got["spatial"], reference[("predict", name, tta)], "JAX",
                   1e-5)
    np.testing.assert_array_equal(ranks[2][0]["predictor"][(name, tta)][
        "spatial"], ranks[2][1]["predictor"][(name, tta)]["spatial"])


@pytest.mark.parametrize("world", sorted(W.RESHARD_MESHES))
@pytest.mark.parametrize("name", sorted(W.PREDICTORS))
def test_spatial_predictor_reshards_an_odd_slab(runs, world, name):
    """A (12, 8, 8) volume at depth 3, which the JAX package accepts: on 2
    ranks (slabs of 6 -> 3 rows) and on a 1 x 4 mesh (slabs of 3 rows)
    the probabilities on every rank equal the direct predictor's within
    1e-5, the label maps bit for bit."""
    _, _, ranks = runs
    for r in ranks[world]:
        got = r["reshard_predictor"][(name, False)]
        assert got["spatial"].shape == (1,) + W.RESHARD
        _close(got["spatial"], got["direct"], "direct", 1e-5)
        np.testing.assert_array_equal(got["labels"], got["direct_labels"])


def test_slab_guard_and_divisibility_errors():
    """Where a slab goes odd the forward gathers that level instead of
    refusing (``gather_level``); what is refused is JAX's: a batch or depth
    that does not split over the mesh, a mesh that asks for more ranks than
    there are, and the spatial predictor's volume depth."""
    assert gather_level(6, 2) == 1
    assert gather_level(3, 2) == 0
    assert gather_level(8, 2) is None
    assert gather_level(60, 3) == 2      # (120, 128, 128) at depth 4, 2 ranks
    assert gather_level(56, 4) == 3      # 112^3 at depth 5, 2 ranks
    cfg = W.scenario_config()
    model = build_model(cfg, "cpu")
    two = HybridMesh(None, None, None, 0, 1, 2, torch.device("cpu"))
    SpatialPredictor(model, cfg, two)._check_shape((12, 8, 8))
    mesh = HybridMesh(None, None, None, 3, 2, 2, torch.device("cpu"))
    assert (mesh.data_rank, mesh.spatial_rank, mesh.size) == (1, 1, 4)
    with pytest.raises(ValueError, match=r"array dim 0 \(size 3\) not "
                       r"divisible by mesh axis 'data' \(2 shards\)"):
        shard_batch_spatial(mesh, np.zeros((3, 1, 8, 4, 4)))
    with pytest.raises(ValueError, match=r"array dim 2 \(size 5\) not "
                       r"divisible by mesh axis 'spatial' \(2 shards\)"):
        shard_batch_spatial(mesh, np.zeros((2, 1, 5, 4, 4)))
    x, y = shard_batch_spatial(mesh, np.arange(4 * 8).reshape(4, 1, 8, 1, 1),
                               torch.arange(4 * 8).reshape(4, 1, 8, 1, 1))
    assert x.ravel().tolist() == [20, 21, 22, 23, 28, 29, 30, 31]
    assert y.reshape(-1).tolist() == x.ravel().tolist()
    assert mesh.row_range(4) == (2, 4)
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_hybrid_mesh(2, 2, device="cpu")
    one = make_hybrid_mesh(1, 1, device="cpu")
    assert (one.group, one.spatial_group, one.size) == (None, None, 1)
    three = HybridMesh(None, None, None, 0, 1, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="volume depth 16 not divisible by "
                       "the mesh's 3 spatial shards"):
        SpatialPredictor(model, cfg, three)._check_shape(W.VOLUME)


@pytest.fixture(scope="module")
def spatial_training(tmp_path_factory):
    """``train.main`` with ``spatial_devices=2`` on the CPU (it starts its
    two ranks itself), and the same run on one device."""
    d = tmp_path_factory.mktemp("torch_spatial_entry")
    write_synthetic_dataset(str(d / "cases"), n_cases=5, shape=(20, 20, 20))
    base = Config(image_shape=(16, 16, 16), patch_shape=(8, 8, 8), depth=2,
                  n_base_filters=4, batch_size=4, n_epochs=2,
                  compute_dtype="float32", validation_patch_overlap=2,
                  training_patch_start_offset=(2, 2, 2), flip=True,
                  contrast=0.1, initial_learning_rate=1e-2,
                  batch_normalization=True, device_case_cache="off",
                  data_file=str(d / "data"), training_file=str(d / "t.pkl"),
                  validation_file=str(d / "v.pkl"))
    runs = {}
    os.environ.setdefault("OMP_NUM_THREADS", "1")  # the ranks inherit it
    for tag, kw in (("one", {}), ("spatial", dict(num_devices=2,
                                                  spatial_devices=2))):
        cfg = dataclasses.replace(
            base, model_file=str(d / f"{tag}.ckpt"),
            training_log=str(d / f"{tag}.log"), **kw)
        out = entry.main(cfg, str(d / "cases"), seed=3, device="cpu",
                         verbose=False, rank_timeout_s=RANK_TIMEOUT_S)
        with open(cfg.training_log) as f:
            runs[tag] = (cfg, out, list(csv.DictReader(f)))
    return runs


def test_train_main_on_a_spatial_mesh_trains_like_one_device(
        spatial_training):
    """Two ranks that split every patch's depth: one log row per epoch
    (rank 0 alone writes), a checkpoint, and the per-epoch losses and dice
    of the single-device run on the same seed (the GSPMD steps augment the
    whole batch alike on every rank)."""
    (cfg, out, rows), (_, one_out, want) = (spatial_training["spatial"],
                                            spatial_training["one"])
    assert out is None and one_out is not None
    assert [r["epoch"] for r in rows] == ["0", "1"]
    for key in ("loss", "dice_coefficient", "val_loss"):
        _close([float(r[key]) for r in rows], [float(r[key]) for r in want],
               key, 1e-4)
    assert float(rows[1]["loss"]) < float(rows[0]["loss"])
    assert CheckpointIO(cfg.model_file).peek_epoch() in (1, 2)
    assert not [p for p in os.listdir(os.path.dirname(cfg.model_file))
                if p.endswith(".tmp")]


def test_train_main_refuses_an_indivisible_spatial_mesh(tmp_path):
    """JAX's message, before the dataset is built."""
    cfg = Config(num_devices=3, spatial_devices=2,
                 data_file=str(tmp_path / "data"))
    with pytest.raises(SystemExit, match=r"spatial_devices=2 must divide "
                       r"the device count \(3\)"):
        entry.main(cfg, str(tmp_path), device="cpu")
    assert not os.path.exists(cfg.data_file)
