"""One rank of ``tests/test_torch_spatial.py``'s runs (gloo, CPU), and the
same train-step scenarios on one device when imported and called with no
mesh.

    python tests/test_torch_spatial_worker.py RANK WORLD PORT WORK_DIR

WORLD 2 is a 1 x 2 hybrid mesh, WORLD 4 a 2 x 2 one. Each scenario starts
from the parameters that the test wrote to ``WORK_DIR/<name>.init.pt``,
takes one GSPMD train step on the global batch with plain SGD at learning
rate 1 (the parameter change is minus the gradient, so the comparison is
linear in it) and two eval steps (all samples, and the first
``n_valid``). On 2 ranks the worker also checks ``halo_exchange`` and the
conv blocks on slabs against whole tensors, and predicts with the spatial
predictor. Every world also predicts a ``RESHARD`` volume whose slabs go
odd before the last halving. Rank r writes ``WORK_DIR/rank<r>_of<WORLD>.pt``. Imports nothing
of JAX. It holds no test of its own: ``tests/test_torch_spatial.py`` runs it
and reads what it wrote.
"""

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.models.layers import (
    ConvBlock, InstanceNorm, set_spatial_group)
from fetal_mri_segmentation_tpu_torch.parallel.collectives import (
    all_gather_cat, halo_exchange)
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    initialize_distributed, rank_environment, shutdown_distributed)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_direct_predictor, make_gspmd_eval_step, make_gspmd_train_step,
    make_hybrid_mesh, make_spatial_predictor)
from fetal_mri_segmentation_tpu_torch.training.state import TrainState
from fetal_mri_segmentation_tpu_torch.training.train_step import (
    make_eval_step, make_train_step)

GLOBAL_BATCH = 4
PATCH = (16, 8, 8)

# a patch depth whose slab goes odd on 2 ranks at depth 3 (6 -> 3 rows):
# the models gather level 1 whole (models/layers.py::gather_level)
RESHARD = (12, 8, 8)
# name -> (config keys, n_valid of the global batch); all but dropout are
# held to the JAX GSPMD step too (dropout draws other masks there)
SCENARIOS = {
    "plain": ({}, 4),
    "partial_batch": ({}, 3),
    "batchnorm": ({"batch_normalization": True}, 4),
    "isensee": ({"model_name": "isensee", "n_segmentation_levels": 2,
                 "dropout_rate": 0.0}, 4),
    "isensee_partial": ({"model_name": "isensee", "n_segmentation_levels": 2,
                         "dropout_rate": 0.0}, 3),
    "isensee_dropout": ({"model_name": "isensee", "n_segmentation_levels": 2,
                         "dropout_rate": 0.3}, 4),
    "reshard": ({"patch_shape": RESHARD}, 4),
    "reshard_batchnorm": ({"patch_shape": RESHARD,
                           "batch_normalization": True}, 4),
    "reshard_isensee": ({"patch_shape": RESHARD, "model_name": "isensee",
                         "n_segmentation_levels": 2, "dropout_rate": 0.0}, 3),
}
JAX_SCENARIOS = [n for n, (kw, _) in SCENARIOS.items()
                 if not kw.get("dropout_rate")]
MESHES = {2: (1, 2), 4: (2, 2)}
# the spatial predictor's volume and models (weights from the test:
# WORK_DIR/predict_<name>.init.pt)
VOLUME = (16, 8, 8)
PREDICTORS = {"unet": {}, "isensee": {"model_name": "isensee",
                                      "n_segmentation_levels": 2}}
# the spatial predictor on a RESHARD volume: on 2 ranks (slabs of 6 -> 3,
# level 1 gathered) and on a 1 x 4 mesh of the 4 ranks (slabs of 3, level 0
# gathered, Isensee's level-1 head summed whole and cut)
RESHARD_MESHES = {2: (1, 2), 4: (1, 4)}


def scenario_config(cls=Config, **kw):
    defaults = dict(model_name="unet", depth=3, n_base_filters=4,
                    patch_shape=PATCH, image_shape=VOLUME,
                    batch_size=GLOBAL_BATCH, compute_dtype="float32",
                    fold_level0="off", augment=False,
                    initial_learning_rate=1e-2)
    defaults.update(kw)
    return cls(**defaults)


def scenario_batch(name):
    """The global batch of a scenario, from a numpy seed; a partial batch's
    padded tail is zero. The truth differs along the depth, so every slab
    holds some of it."""
    seed = sorted(SCENARIOS).index(name)
    kw, n_valid = SCENARIOS[name]
    rng = np.random.default_rng(seed)
    shape = (GLOBAL_BATCH, 1) + kw.get("patch_shape", PATCH)
    y = np.zeros(shape, np.float32)
    y[:, :, 3:13, 2:6, 2:6] = 1.0
    y[1, :, 1:3] = 1.0
    x = (y * 2 + rng.normal(0, 0.3, shape)).astype(np.float32)
    x += np.arange(GLOBAL_BATCH, dtype=np.float32).reshape(-1, 1, 1, 1, 1)
    x[n_valid:] = 0
    y[n_valid:] = 0
    return x, y, n_valid


def volume(seed=7, shape=VOLUME):
    return np.random.default_rng(seed).normal(
        size=(1,) + shape).astype(np.float32)


def _sgd_state(model):
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))


def _tensors(d):
    return {k: v.detach().clone() for k, v in d.items()}


def run_scenarios(mesh, work):
    """Every scenario over ``mesh`` (None: the single-device steps on the
    global batch). The dropout scenario's generator is seeded alike on
    every rank and on one device."""
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
        gen = torch.Generator().manual_seed(11)
        if mesh is None:
            step = make_train_step(model, cfg, generator=gen)
            ev = make_eval_step(model, cfg)
        else:
            step = make_gspmd_train_step(model, cfg, mesh, generator=gen)
            ev = make_gspmd_eval_step(model, cfg, mesh)
        m = step(state, x, y, n_valid)
        e_all, e_valid = ev(state, x, y), ev(state, x, y, n_valid)
        out[name] = dict(loss=float(m["loss"]), dice=float(m["dice"]),
                         eval_loss=float(e_all["loss"]),
                         eval_dice=float(e_all["dice"]),
                         eval_loss_valid=float(e_valid["loss"]),
                         state_dict=_tensors(model.state_dict()))
    return out


def _slab(t, mesh, axis=1):
    d = t.shape[axis] // mesh.n_spatial
    return t.narrow(axis, mesh.spatial_rank * d, d)


def run_halo(mesh):
    """``halo_exchange`` on every rank's slab against the zero-padded whole
    tensor: the forward's rows, and the gradient of sum(w * halo'd slab)
    over the ranks against autograd through the padded tensor."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 8, 3, 2, 3)).astype(np.float32))
    out = {}
    for lo, hi in ((1, 1), (2, 2), (0, 1)):
        d = x.shape[1] // mesh.n_spatial
        w = torch.from_numpy(rng.normal(size=(2, mesh.n_spatial, d + lo + hi,
                                              3, 2, 3)).astype(np.float32))
        padded = F.pad(x, (0, 0, 0, 0, 0, 0, lo, hi))
        views = [padded[:, r * d:r * d + d + lo + hi]
                 for r in range(mesh.n_spatial)]
        xr = x.clone().requires_grad_()
        ref = F.pad(xr, (0, 0, 0, 0, 0, 0, lo, hi))
        sum((ref[:, r * d:r * d + d + lo + hi] * w[:, r]).sum()
            for r in range(mesh.n_spatial)).backward()
        slab = _slab(x, mesh).clone().requires_grad_()
        y = halo_exchange(slab, mesh.spatial_group, lo, hi)
        (y * w[:, mesh.spatial_rank]).sum().backward()
        out[(lo, hi)] = dict(
            forward=float((y.detach() - views[mesh.spatial_rank]
                           ).abs().max()),
            grad=float((all_gather_cat(slab.grad, mesh.spatial_group)
                        - xr.grad).abs().max()))
    return out


BLOCKS = {
    "kernel conv": dict(in_features=8, features=8, use_kernel_conv=True),
    "plain conv": dict(in_features=3, features=8),
    "stride 2": dict(in_features=8, features=8, stride=2,
                     instance_normalization=True,
                     activation="leaky_relu"),
    "1x1": dict(in_features=8, features=8, kernel_size=1),
    "fused decoder": dict(in_features=16, features=8, use_kernel_dec0=True),
    "fused decoder, no skip": dict(in_features=8, features=8,
                                   instance_normalization=True),
}


def run_blocks(mesh):
    """Each kind of conv block on this rank's slab with the spatial group
    set, against the same block on the whole tensor: this rank's output
    rows, and every parameter's gradient summed over the ranks."""
    out = {}
    for name, kw in BLOCKS.items():
        torch.manual_seed(0)
        block = ConvBlock(dtype=torch.float32, **kw)
        rng = np.random.default_rng(5)
        fused = name.startswith("fused")
        cin = 8 if fused else kw["in_features"]
        x = torch.from_numpy(rng.normal(size=(2, 8, 4, 4, cin)).astype(
            np.float32))
        skip = (torch.from_numpy(rng.normal(size=(2, 16, 8, 8, 8)).astype(
            np.float32)) if name == "fused decoder" else None)
        args = (x, skip) if fused else x
        want = block(args)
        g = torch.from_numpy(rng.normal(size=tuple(want.shape)).astype(
            np.float32))
        grads = torch.autograd.grad((want * g).sum(),
                                    list(block.parameters()))
        set_spatial_group(block, mesh.spatial_group)
        sx = _slab(x, mesh)
        sargs = (sx, None if skip is None else _slab(skip, mesh)) \
            if fused else sx
        got = block(sargs)
        got_grads = torch.autograd.grad((got * _slab(g, mesh)).sum(),
                                        list(block.parameters()))
        summed = [gg.clone() for gg in got_grads]
        for t in summed:
            torch.distributed.all_reduce(t, group=mesh.spatial_group)
        out[name] = dict(
            forward=float((got.detach() - _slab(want.detach(), mesh)
                           ).abs().max()),
            # against the block's largest gradient: a conv bias before a
            # norm has a gradient of rounding size only
            grad=max(float((a - b).abs().max()) for a, b in
                     zip(summed, grads)) / max(float(b.abs().max())
                                               for b in grads))
    norm = InstanceNorm(8, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        3.0, 2.0, size=(2, 8, 4, 4, 8)).astype(np.float32))
    with torch.no_grad():
        want = norm(x)
        norm.group = mesh.spatial_group
        got = norm(_slab(x, mesh))
    out["instance norm"] = dict(
        forward=float((got - _slab(want, mesh)).abs().max()), grad=0.0)
    return out


def run_predictor(mesh, work, shape=VOLUME, ttas=(False, "flips")):
    """The spatial predictor on this mesh: probabilities plain and with
    flips TTA, and the label map, for the U-Net and Isensee2017 (its eval
    decoder is the fused form with no skip); the direct predictor's on the
    same weights, on one device in this process."""
    out = {}
    vol = volume(shape=shape)
    for name, kw in PREDICTORS.items():
        cfg = scenario_config(use_pallas_conv=True, use_pallas_dec0=True,
                              image_shape=shape, **kw)
        model = build_model(cfg, "cpu")
        model.load_state_dict(torch.load(os.path.join(
            work, f"predict_{name}.init.pt")))
        for tta in ttas:
            spatial = make_spatial_predictor(model, cfg, mesh, tta=tta)
            direct = make_direct_predictor(model, cfg, tta=tta, device="cpu")
            out[(name, tta)] = dict(
                spatial=spatial(vol), direct=direct(vol),
                labels=spatial.predict_labels(vol),
                direct_labels=direct.predict_labels(vol))
    return out


def main(rank, world, port, work):
    torch.set_num_threads(1)
    os.environ.update(rank_environment(rank, world, port))
    initialize_distributed(device="cpu", timeout_s=120)
    try:
        mesh = make_hybrid_mesh(*MESHES[world], device="cpu")
        assert (mesh.rank, mesh.size) == (rank, world)
        out = dict(coords=(mesh.data_rank, mesh.spatial_rank),
                   scenarios=run_scenarios(mesh, work))
        if world == 2:
            out.update(halo=run_halo(mesh), blocks=run_blocks(mesh),
                       predictor=run_predictor(mesh, work))
        out["reshard_predictor"] = run_predictor(
            make_hybrid_mesh(*RESHARD_MESHES[world], device="cpu"), work,
            RESHARD, ttas=(False,))
        torch.save(out, os.path.join(work, f"rank{rank}_of{world}.pt"))
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
