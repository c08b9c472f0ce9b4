"""One rank of ``tests/test_torch_parallel.py``'s two-rank run (gloo, CPU),
and the same scenarios on one device when imported and called with no mesh.

    python tests/test_torch_parallel_worker.py RANK WORLD PORT WORK_DIR

Each scenario starts from the parameters that the test wrote to
``WORK_DIR/<name>.init.pt``, takes one train step with plain SGD at
learning rate 1 (the parameter change is minus the gradient, so the
comparison is linear in it) and one eval step, and keeps the loss, the
dice, the state dict and the gradients. Rank r writes
``WORK_DIR/rank<r>.pt``. Imports nothing of JAX. It holds no test of its
own: ``tests/test_torch_parallel.py`` runs it and reads what it wrote.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.ops.patches import (
    get_patch_from_3d_data)
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
    make_dp_eval_step, make_dp_train_step, make_mesh)
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    initialize_distributed, rank_environment, shutdown_distributed)
from fetal_mri_segmentation_tpu_torch.pipeline import device_cache as TC
from fetal_mri_segmentation_tpu_torch.pipeline.generator import convert_data
from fetal_mri_segmentation_tpu_torch.training.loop import epoch_seed
from fetal_mri_segmentation_tpu_torch.training.state import TrainState
from fetal_mri_segmentation_tpu_torch.training.train_step import (
    make_eval_step, make_train_step)

GLOBAL_BATCH = 4

# name -> (config keys, n_valid of the global batch)
SCENARIOS = {
    "plain_dice": ({}, 4),
    "weighted_dice": ({"model_name": "isensee", "n_segmentation_levels": 1,
                       "dropout_rate": 0.0}, 4),
    "partial_batch": ({}, 3),
    "batchnorm": ({"batch_normalization": True}, 4),
    "batchnorm_partial": ({"batch_normalization": True}, 3),
    # level 0 folded on W (ops/fold.py), explicit: each rank folds its rows
    "with_fold": ({"fold_level0": (1, 1, 2), "fold_formulation": "dense"},
                  4),
}


def scenario_config(cls=Config, **kw):
    defaults = dict(model_name="unet", depth=2, n_base_filters=8,
                    patch_shape=(8, 8, 8), batch_size=GLOBAL_BATCH,
                    compute_dtype="float32", fold_level0="off",
                    augment=False, initial_learning_rate=1e-2)
    defaults.update(kw)
    return cls(**defaults)


def scenario_batch(name):
    """The global batch of a scenario, from a numpy seed; the padded tail
    of a partial batch is zero, as ``pad_batch`` leaves it. Sample means
    differ, so per-rank BatchNorm statistics would differ from the global
    ones."""
    seed = sorted(SCENARIOS).index(name)
    n_valid = SCENARIOS[name][1]
    rng = np.random.default_rng(seed)
    shape = (GLOBAL_BATCH, 1, 8, 8, 8)
    y = np.zeros(shape, np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    y[1, :, 1:3] = 1.0
    x = (y * 2 + rng.normal(0, 0.3, shape)).astype(np.float32)
    x += np.arange(GLOBAL_BATCH, dtype=np.float32).reshape(-1, 1, 1, 1, 1)
    x[n_valid:] = 0
    y[n_valid:] = 0
    return x, y, n_valid


def _sgd_state(model):
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))


def _tensors(d):
    return {k: v.detach().clone() for k, v in d.items()}


def run_scenarios(mesh, work):
    """Every scenario over ``mesh`` (None: the plain single-device steps on
    the whole global batch)."""
    out = {}
    for name, (kw, n_valid) in SCENARIOS.items():
        cfg = scenario_config(use_pallas_conv=True, use_pallas_dec0=True,
                              **kw)
        x, y, _ = scenario_batch(name)
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        model = build_model(cfg, "cpu")
        model.load_state_dict(torch.load(os.path.join(work,
                                                      f"{name}.init.pt")))
        state = _sgd_state(model)
        if mesh is None:
            step, ev = make_train_step(model, cfg), make_eval_step(model, cfg)
        else:
            step = make_dp_train_step(model, cfg, mesh)
            ev = make_dp_eval_step(model, cfg, mesh)
        m = step(state, x, y, n_valid)
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        e = ev(state, x, y, n_valid)
        out[name] = dict(loss=float(m["loss"]), dice=float(m["dice"]),
                         eval_loss=float(e["loss"]),
                         eval_dice=float(e["dice"]), grads=grads,
                         state_dict=_tensors(model.state_dict()))
    return out


def run_augmented(mesh):
    """The SAME sample in every row of the global batch, through the
    augmenting step with the loop's per-rank seed: the batch as trained
    on, twice from the same seed."""
    cfg = scenario_config(augment=True, flip=True, permute=True,
                          contrast=0.5)
    x1, y1, _ = scenario_batch("plain_dice")
    x = torch.from_numpy(np.tile(x1[:1], (GLOBAL_BATCH, 1, 1, 1, 1)))
    y = torch.from_numpy(np.tile(y1[:1], (GLOBAL_BATCH, 1, 1, 1, 1)))
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        model = build_model(cfg, "cpu")
        gen = torch.Generator().manual_seed(epoch_seed(1, 0, mesh.rank))
        step = make_dp_train_step(model, cfg, mesh, generator=gen,
                                  debug_return_batch=True)
        m, (xa, ya) = step(_sgd_state(model), x, y, GLOBAL_BATCH)
        runs.append(dict(loss=float(m["loss"]), x=xa.clone(), y=ya.clone()))
    return runs


def synthetic_cases(n=3, seed=5):
    rng = np.random.default_rng(seed)
    truth = np.zeros((n, 1, 16, 16, 16), np.uint8)
    truth[:, :, 4:12, 4:12, 4:12] = 1
    data = (truth * 2.0 + rng.normal(0, 0.3, truth.shape)).astype(np.float32)
    return SimpleNamespace(root=SimpleNamespace(data=data, truth=truth))


def run_cached(mesh):
    """Two steps of the cached data-parallel step and of the host
    data-parallel step on the same batches, from the same parameters and
    generator seeds, BatchNorm and augmentation on."""
    cfg = scenario_config(batch_normalization=True, augment=True, flip=True,
                          permute=True, contrast=0.1,
                          training_patch_start_offset=(4, 4, 4))
    f = synthetic_cases()
    lo, hi = TC.plan_margins((16, 16, 16), cfg.patch_shape, 0, (4, 4, 4))
    cache = TC.DeviceCaseCache.build(
        f, [0, 1, 2], patch_shape=cfg.patch_shape, margin_lo=lo,
        margin_hi=hi, dtype=torch.float32, device="cpu")
    idx = TC.index_batch_generator(
        f, [0, 1, 2], cache.row_of, batch_size=GLOBAL_BATCH,
        patch_shape=cfg.patch_shape, patch_start_offset=(4, 4, 4), seed=2)
    results = {}
    models = {}
    for kind in ("cached", "host"):
        torch.manual_seed(0)
        models[kind] = build_model(cfg, "cpu")
    models["host"].load_state_dict(models["cached"].state_dict())
    gens = {k: torch.Generator().manual_seed(epoch_seed(3, 0, mesh.rank))
            for k in models}
    cached = TC.make_cached_dp_train_step(models["cached"], cfg, mesh, lo,
                                          generator=gens["cached"])
    cached_ev = TC.make_cached_dp_eval_step(models["cached"], cfg, mesh, lo)
    host = make_dp_train_step(models["host"], cfg, mesh,
                              generator=gens["host"])
    host_ev = make_dp_eval_step(models["host"], cfg, mesh)
    states = {k: _sgd_state(m) for k, m in models.items()}
    losses = {"cached": [], "host": []}
    for i in range(2):
        rows, corners, n_valid = next(idx)
        if i == 1:
            n_valid = 3  # a ragged global batch: rank 1 keeps one real row
        xs = [get_patch_from_3d_data(f.root.data[r], cfg.patch_shape, c)
              for r, c in zip(rows, corners)]
        ys = [get_patch_from_3d_data(f.root.truth[r], cfg.patch_shape, c)
              for r, c in zip(rows, corners)]
        x, y = convert_data(xs, ys)
        x[n_valid:], y[n_valid:] = 0, 0
        rows, corners = torch.from_numpy(rows), torch.from_numpy(corners)
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        losses["cached"].append(float(cached(
            states["cached"], cache.data_stack, cache.truth_stack, rows,
            corners, n_valid)["loss"]))
        losses["host"].append(float(host(states["host"], x, y,
                                         n_valid)["loss"]))
    losses["cached"].append(float(cached_ev(
        states["cached"], cache.data_stack, cache.truth_stack, rows, corners,
        n_valid)["loss"]))
    losses["host"].append(float(host_ev(states["host"], x, y,
                                        n_valid)["loss"]))
    results["losses"] = losses
    results["state_dicts"] = {k: _tensors(m.state_dict())
                              for k, m in models.items()}
    return results


def main(rank, world, port, work):
    torch.set_num_threads(1)
    os.environ.update(rank_environment(rank, world, port))
    initialize_distributed(device="cpu", timeout_s=120)
    try:
        mesh = make_mesh(world, device="cpu")
        assert (mesh.rank, mesh.size, mesh.axis_names) == (rank, world,
                                                          ("data",))
        out = dict(scenarios=run_scenarios(mesh, work),
                   augmented=run_augmented(mesh), cached=run_cached(mesh))
        # asking for more devices than there are ranks raises, as in JAX
        try:
            make_mesh(world + 7, device="cpu")
        except ValueError as e:
            out["overask"] = str(e)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
