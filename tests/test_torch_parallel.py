"""The port's data-parallel training (``parallel/data_parallel.py``,
``parallel/distributed.py``, the collective dice, sync BatchNorm) on the
CPU: two ranks over gloo, started once as two subprocesses
(``tests/test_torch_parallel_worker.py``) that run every scenario, against the
port's single-device step on the same global batch and against the JAX
package's ``make_dp_train_step`` over 2 of conftest's virtual devices
(fp32, fold off, augmentation off).

Every step uses plain SGD at learning rate 1, as ``tests/test_parallel.py``
does: the parameter change is minus the gradient, so the comparison is
linear in the gradient (Adam's first step is about lr * sign(g), which
turns reduction-order noise in near-zero entries into lr-sized steps).
Tolerance: loss and dice atol 1e-5; parameters, gradients and BatchNorm's
buffers atol 1e-5 (two ranks sum in another order than one device), and
the BatchNorm scenarios' parameters against JAX atol 1e-4, the tolerance of
``tests/test_parallel.py::test_dp_batchnorm_matches_single_device`` (the
conv in front of a norm has the largest gradients, and the two packages
take the moments in another order); the cached data-parallel step against
the host one bit for bit.
"""

import csv
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
    make_dp_train_step as jax_dp_step, make_mesh as jax_mesh,
    replicate_state as jax_replicate, shard_batch as jax_shard)
from fetal_mri_segmentation_tpu.training import (  # noqa: E402
    create_train_state as jax_state)
from fetal_mri_segmentation_tpu_torch import train as entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (  # noqa: E402
    DataMesh, local_valid_count, make_mesh, shard_batch)
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (  # noqa: E402
    default_backend, free_port, initialize_distributed, local_device,
    rank_environment)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.training.loop import epoch_seed  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402
from tests import test_torch_parallel_worker as W  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
RANK_TIMEOUT_S = 300


def _flat(variables):
    flat = {f"params/{k}": v for k, v in flatten_dict(
        variables["params"], sep="/").items()}
    flat.update({f"batch_stats/{k}": v for k, v in flatten_dict(
        variables.get("batch_stats") or {}, sep="/").items()})
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, one, ranks)``: per scenario the JAX data-parallel step over
    2 virtual devices, the port's single-device step, and what each of the
    two gloo ranks saved."""
    work = str(tmp_path_factory.mktemp("torch_parallel"))
    reference = {}
    for name, (kw, n_valid) in W.SCENARIOS.items():
        jcfg = W.scenario_config(JaxConfig, **kw)
        jmodel = jax_build(jcfg)
        js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0),
                       tx=optax.sgd(1.0))
        torch.save(from_flax(_flat({"params": js.params,
                                    "batch_stats": js.batch_stats})),
                   os.path.join(work, f"{name}.init.pt"))
        x, y, _ = W.scenario_batch(name)
        mesh = jax_mesh(2)
        new, m = jax_dp_step(jmodel, jcfg, mesh)(
            jax_replicate(mesh, js), *jax_shard(mesh, x, y),
            jax.random.PRNGKey(0), jnp.asarray(n_valid))
        reference[name] = dict(
            loss=float(m["loss"]), dice=float(m["dice"]),
            state_dict=from_flax(_flat({"params": new.params,
                                        "batch_stats": new.batch_stats})))
    # the two ranks, started together; each has a time limit
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "test_torch_parallel_worker.py"),
         str(rank), "2", str(port), work], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outputs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, f"rank failed:\n{o[-3000:]}"
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(2)]
    one = W.run_scenarios(None, work)
    return reference, one, ranks


def _close(a, b, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("name", sorted(W.SCENARIOS))
def test_two_rank_step_equals_one_rank_and_jax(runs, name):
    """Loss, dice, every updated parameter and BatchNorm's buffers; the
    eval step's global metrics; identical on both ranks."""
    reference, one, ranks = runs
    jref, single, r0, r1 = (reference[name], one[name],
                            ranks[0]["scenarios"][name],
                            ranks[1]["scenarios"][name])
    for key in ("loss", "dice"):
        _close(r0[key], single[key], key)
        _close(r0[key], jref[key], f"{key} against JAX")
        assert r0[key] == r1[key], f"{key} differs between the ranks"
    for key in ("eval_loss", "eval_dice"):
        _close(r0[key], single[key], key)
        assert r0[key] == r1[key]
    assert set(r0["state_dict"]) == set(single["state_dict"]) == set(
        jref["state_dict"])
    moved = False
    for k, v in r0["state_dict"].items():
        _close(v, single["state_dict"][k], k)
        _close(v, jref["state_dict"][k], f"{k} against JAX",
               atol=1e-4 if "batchnorm" in name else ATOL)
        assert torch.equal(v, r1["state_dict"][k]), f"{k} differs by rank"
        if k.endswith((".mean", ".var")):
            moved = True
    assert moved == ("batchnorm" in name)


@pytest.mark.parametrize("name", sorted(W.SCENARIOS))
def test_gradients_are_summed_not_averaged(runs, name):
    """Each rank ends the step holding the SUM of the ranks' shares, which
    is the single-device gradient; the mean over ranks (what
    ``DistributedDataParallel`` leaves) is half of it and must not pass."""
    _, one, ranks = runs
    single = one[name]["grads"]
    summed = ranks[0]["scenarios"][name]["grads"]
    worst = 0.0
    for k, g in summed.items():
        _close(g, single[k], k)
        assert torch.equal(g, ranks[1]["scenarios"][name]["grads"][k])
        worst = max(worst, float((g / 2 - single[k]).abs().max()))
    assert worst > 100 * ATOL, (
        f"averaged gradients would pass within {ATOL}: the check has no "
        f"teeth (largest difference {worst})")


def test_augmented_shards_differ_and_repeat(runs):
    """The same sample in every row: the ranks, seeded from (seed, epoch,
    rank), augment it differently, and the same seed repeats the run."""
    _, _, ranks = runs
    a0, a1 = ranks[0]["augmented"], ranks[1]["augmented"]
    for first, again in (a0, a1):
        assert torch.equal(first["x"], again["x"])
        assert first["loss"] == again["loss"]
    assert a0[0]["x"].shape == (2, 1, 8, 8, 8)  # this rank's rows
    rows = torch.cat([a0[0]["x"], a1[0]["x"]])
    assert len({r.numpy().tobytes() for r in rows}) >= 3
    assert not torch.equal(a0[0]["x"], a1[0]["x"])
    assert a0[0]["loss"] == a1[0]["loss"]  # the global loss, on both ranks
    assert len({epoch_seed(1, 0, r) for r in (None, 0, 1)}) == 3
    assert epoch_seed(1, 0) == epoch_seed(1, 0, None)


def test_cached_dp_step_equals_host_dp_step(runs):
    """Index batches gathered on each rank against host-staged batches
    sharded by rank: the same losses and state, bit for bit, over a full
    and a ragged global batch and an eval step."""
    _, _, ranks = runs
    for r in ranks:
        c = r["cached"]
        assert c["losses"]["cached"] == c["losses"]["host"]
        assert len(c["losses"]["host"]) == 3
        for k, v in c["state_dicts"]["cached"].items():
            assert torch.equal(v, c["state_dicts"]["host"][k]), k
    assert ranks[0]["cached"]["losses"] == ranks[1]["cached"]["losses"]


def test_indivisible_batch_and_overasked_mesh_raise(runs):
    """JAX's messages (``tests/test_parallel.py``)."""
    _, _, ranks = runs
    mesh = DataMesh(None, 1, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="global batch size 3 is not "
                       "divisible by the 2-device data mesh"):
        shard_batch(mesh, np.zeros((3, 1, 4, 4, 4), np.float32))
    x, y = shard_batch(mesh, np.arange(4), torch.arange(8))
    assert list(x) == [2, 3] and y.tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="requested 9 devices, have 1"):
        make_mesh(9, device="cpu")
    assert ranks[0]["overask"] == ranks[1]["overask"] == (
        "requested 9 devices, have 2")
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    assert [local_valid_count(DataMesh(None, r, 2, None), n, 3)
            for r, n in ((0, 5), (1, 5), (1, 2), (0, None))] == [3, 2, 0, 3]


def test_one_process_needs_no_group(monkeypatch):
    """``initialize_distributed`` is a no-op for a single process, and the
    mesh of one device has no group; the backend and the device follow the
    launcher's environment."""
    import torch.distributed as dist

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    initialize_distributed(device="cpu")
    initialize_distributed(num_processes=1, device="cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.axis_names) == (
        None, 0, 1, ("data",))
    assert make_mesh(1, device="cpu").device == torch.device("cpu")
    assert default_backend("cpu") == "gloo"
    assert local_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        # a rank that finds no CUDA device raises: no quiet move to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            local_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(device="cuda")


@pytest.fixture(scope="module")
def two_rank_training(tmp_path_factory):
    """``train.main`` with ``num_devices=2`` on the CPU: it starts the two
    ranks itself."""
    d = tmp_path_factory.mktemp("torch_parallel_entry")
    write_synthetic_dataset(str(d / "cases"), n_cases=5, shape=(20, 20, 20))
    cfg = Config(image_shape=(16, 16, 16), patch_shape=(8, 8, 8), depth=2,
                 n_base_filters=4, batch_size=4, n_epochs=2,
                 compute_dtype="float32", validation_patch_overlap=2,
                 training_patch_start_offset=(2, 2, 2), contrast=0.1,
                 batch_normalization=True, num_devices=2,
                 device_case_cache="on", data_file=str(d / "data"),
                 model_file=str(d / "model.ckpt"),
                 training_file=str(d / "t.pkl"),
                 validation_file=str(d / "v.pkl"),
                 training_log=str(d / "training.log"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")  # the ranks inherit it
    out = entry.main(cfg, str(d / "cases"), seed=3, device="cpu",
                     rank_timeout_s=RANK_TIMEOUT_S)
    return cfg, out


def test_train_main_two_ranks_trains_and_only_rank0_writes(two_rank_training,
                                                           capfd):
    cfg, out = two_rank_training
    assert out is None  # the ranks trained; this process only started them
    with open(cfg.training_log) as f:
        rows = list(csv.DictReader(f))
    # one row per epoch: a second writer would double them
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(r["loss"])) and
               np.isfinite(float(r["val_loss"])) for r in rows)
    io = CheckpointIO(cfg.model_file)
    assert io.exists() and io.peek_epoch() in (1, 2)
    assert io.peek_data_order() == {"mode": "lockstep"}
    leftovers = [p for p in os.listdir(os.path.dirname(cfg.model_file))
                 if p.endswith(".tmp")]
    assert not leftovers


def test_train_entry_as_two_ranks_under_a_launcher(two_rank_training,
                                                   tmp_path):
    """``python -m ...train`` started twice with a launcher's environment
    (what ``torchrun`` sets): each process is one rank, rank 0 builds the
    dataset and writes; the log equals the self-started run's."""
    import dataclasses

    ref, _ = two_rank_training
    cfg = dataclasses.replace(
        ref, n_epochs=2, overwrite=False, data_file=str(tmp_path / "data"),
        model_file=str(tmp_path / "model.ckpt"),
        training_file=str(tmp_path / "t.pkl"),
        validation_file=str(tmp_path / "v.pkl"),
        training_log=str(tmp_path / "training.log"))
    cfg.save(str(tmp_path / "config.json"))
    cases = str(Path(ref.data_file).parent / "cases")
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in [os.environ.get(
                           "PYTHONPATH")] if p]),
                   **rank_environment(rank, 2, port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fetal_mri_segmentation_tpu_torch.train",
             "--config", str(tmp_path / "config.json"), "--data-dir", cases,
             "--device", "cpu", "--seed", "3"], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outputs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, f"rank failed:\n{o[-3000:]}"
    assert "building" in outputs[0] and "building" not in outputs[1]
    assert "epoch 1:" in outputs[0] and "epoch 1:" not in outputs[1]
    with open(cfg.training_log) as f, open(ref.training_log) as g:
        rows, want = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    for key in ("loss", "val_loss", "dice_coefficient"):
        assert [r[key] for r in rows] == [r[key] for r in want[:2]], key


def test_train_main_resumes_on_two_ranks_and_refuses_a_wrong_world(
        two_rank_training, monkeypatch):
    """Every rank restores rank 0's checkpoint and the run goes on; under a
    launcher the config's ``num_devices`` must be the launcher's."""
    import dataclasses

    cfg, _ = two_rank_training
    epoch = CheckpointIO(cfg.model_file).peek_epoch()
    cfg3 = dataclasses.replace(cfg, n_epochs=3)
    entry.main(cfg3, "unused: the dataset exists", seed=3, device="cpu",
               verbose=False, rank_timeout_s=RANK_TIMEOUT_S)
    with open(cfg.training_log) as f:
        epochs = [r["epoch"] for r in csv.DictReader(f)]
    assert epochs[-1] == "2" and len(epochs) == 2 + (3 - epoch)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="launcher started 4 processes"):
        entry.main(cfg3, "unused", device="cpu")
