"""The epoch loop, on one device or on one rank of a data mesh (port of
``fetal_mri_segmentation_tpu/training/loop.py::train_model``).

Epochs over the training generator with validation after each; the best
checkpoint, the learning-rate plateau or step decay, early stopping, the
Keras-schema CSV log, the dice-collapse warning and resume from the port's
own checkpoint. Batches are padded to the static batch size (the padded
tail masked out of the loss), staged as bf16 x and uint8 y where that is
exact enough (see :func:`train_model`), and moved to the device by the
prefetch thread. Step metrics stay on the device and are read once per
epoch.

With a ``device_cache`` (``pipeline/device_cache.py``) the generators yield
indices, the prefetch thread uploads one (B, 4) int32 tensor per step and
the step gathers its patches on the device; a partial cache mixes such
steps with host-staged ones. With a ``mesh``
(``parallel/data_parallel.py``) every rank runs this loop on the same
batches, trains on its own rows of each, and rank 0 alone writes the
checkpoint and the log and prints. On a hybrid mesh
(``parallel/spatial.py``: a "spatial" axis) every rank uploads the whole
batch and the GSPMD steps keep its rows and depth slab after augmenting
it, with one generator seed on every rank.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.pipeline.prefetch import (
    prefetch, to_device)
from fetal_mri_segmentation_tpu_torch.training.callbacks import (
    CSVLogger, EarlyStopping, ReduceLROnPlateau, ThroughputMeter, step_decay)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import CheckpointIO
from fetal_mri_segmentation_tpu_torch.training.state import TrainState
from fetal_mri_segmentation_tpu_torch.training.train_step import (
    make_eval_step, make_train_step, pad_batch)


def detect_dice_collapse(dice_history, *, patience: int = 3,
                         threshold: float = 0.01) -> bool:
    """True when the training dice has been ~0 for ``patience`` epochs in a
    row: the sigmoid saturated and the soft-Dice gradient vanished (a too
    large learning rate)."""
    if len(dice_history) < patience:
        return False
    return all(d < threshold for d in dice_history[-patience:])


def epoch_seed(seed: int, epoch: int, rank: Optional[int] = None) -> int:
    """The step generator's seed for ``epoch`` (it draws the augmentation
    and Isensee2017's dropout masks): a pure function of (seed, epoch), so
    a resumed run draws what an uninterrupted one drew. On a data mesh the
    ``rank`` enters too: shards augment differently, and a fixed (seed,
    world size) repeats."""
    # rank + 1: SeedSequence pads its entropy with zeros, so a trailing 0
    # would give rank 0 the single-device seed
    key = (seed, epoch) if rank is None else (seed, epoch, rank + 1)
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def _weighted_means(metrics: list, weights: list) -> dict:
    """Per key, the mean over steps weighted by the real samples of each
    step; one device-to-host copy for the whole epoch."""
    if not metrics:
        return {}
    # sorted: the JAX step's metrics come out of jit as a key-sorted dict,
    # and the log's columns follow this order
    keys = sorted(metrics[0])
    values = torch.stack([torch.stack([m[k].float() for k in keys])
                          for m in metrics]).cpu().double().numpy()
    w = np.asarray(weights, np.float64)
    means = (values * w[:, None]).sum(0) / max(w.sum(), 1e-12)
    return dict(zip(keys, means.tolist()))


def train_model(model, state: TrainState, config,
                training_generator: Iterator, validation_generator: Iterator,
                steps_per_epoch: int, validation_steps: int,
                *, mesh=None, seed: int = 0,
                n_epochs: Optional[int] = None,
                device_cache=None,
                verbose: bool = True) -> TrainState:
    """Train until ``n_epochs`` or early stopping; returns ``state``.

    The generators yield channels-first ``(x, y)`` numpy batches (see
    ``pipeline/generator.py``). x is staged as bf16 for a bf16 model (the
    model's first op is that cast; augmentation then sees the bf16-rounded
    intensities, as in the JAX package) and y as uint8 when it is
    integral.

    ``device_cache``: a ``pipeline/device_cache.py::DeviceCaseCache``; the
    generators must then be its index generators (``maybe_build_device_
    cache`` returns all three). ``mesh``: a ``parallel/data_parallel.py::
    DataMesh`` or a ``parallel/spatial.py::HybridMesh`` of more than one
    rank; every rank calls this with identically seeded generators. A data
    mesh and the cache together train from the cache on every rank; a
    partial cache is single-device only, and a hybrid mesh host-stages."""
    n_epochs = n_epochs if n_epochs is not None else config.n_epochs
    batch_size = config.batch_size
    val_batch_size = config.validation_batch_size or batch_size
    dp = mesh is not None and mesh.size > 1
    spatial = dp and "spatial" in mesh.axis_names
    # on a mesh every rank computes the same metrics and takes the same
    # decisions; rank 0 alone writes and prints
    is_main = not dp or mesh.rank == 0
    verbose = verbose and is_main
    if steps_per_epoch <= 0:
        raise ValueError(
            f"steps_per_epoch={steps_per_epoch}: the training split "
            "produced no (non-blank) patches — check validation_split "
            "(a tiny dataset can round the training share to 0 cases), "
            "skip_blank, and the patch geometry")
    has_validation = validation_steps is not None and validation_steps > 0
    if not has_validation and verbose:
        print("[warning] validation_steps == 0 — no validation will run; "
              "best-checkpoint, LR plateau and early stopping monitor the "
              "TRAINING loss for this run")

    ckpt = CheckpointIO(config.model_file)
    start_epoch, best_val, sched = 0, float("inf"), {}
    if ckpt.exists() and not config.overwrite:
        state, start_epoch, best_val, sched = ckpt.restore(state)
        if verbose:
            print(f"[resume] epoch {start_epoch}, best val {best_val:.4f}")
        peeked = ckpt.peek_epoch()
        if peeked is not None and peeked != start_epoch and is_main:
            print(f"[resume] warning: checkpoint epoch {start_epoch} != "
                  f"sidecar epoch {peeked} — the data order of this resumed "
                  "run will not exactly match an uninterrupted run")

    if device_cache is not None and spatial:
        raise ValueError(
            "device_cache is not supported on spatial/hybrid meshes (a "
            "depth-sharded volume axis would need halo-aware gathers) — "
            "pass device_cache=None and (x, y) generators; "
            "maybe_build_device_cache makes this decision automatically")
    use_cache = device_cache is not None
    partial_cache = use_cache and getattr(device_cache, "partial", False)
    if partial_cache and dp:
        raise ValueError(
            "a partial device cache is single-device only (per-shard host "
            "routing is not implemented) — maybe_build_device_cache makes "
            "this decision automatically")

    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    # steps[kind] = (train step, eval step) for the two kinds of batch:
    # "host" staged (x, y) patches, "idx" the cached gather's (rows,
    # corners), the stacks passed along at every call
    if dp:
        from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
            make_dp_eval_step, make_dp_train_step, replicate_state,
            shard_batch)
        state = replicate_state(mesh, state)
    if spatial:
        from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
            make_gspmd_eval_step, make_gspmd_train_step)
        steps = {"host": (
            make_gspmd_train_step(model, config, mesh, generator=generator),
            make_gspmd_eval_step(model, config, mesh))}
    elif dp:
        steps = {"host": (
            make_dp_train_step(model, config, mesh, generator=generator,
                               sharded=True),
            make_dp_eval_step(model, config, mesh, sharded=True))}
    else:
        steps = {"host": (
            make_train_step(model, config, generator=generator),
            make_eval_step(model, config))}
    if use_cache:
        from fetal_mri_segmentation_tpu_torch.pipeline import device_cache as dc
        lo = device_cache.margin_lo
        if dp:
            cached = (dc.make_cached_dp_train_step(model, config, mesh, lo,
                                                   generator=generator),
                      dc.make_cached_dp_eval_step(model, config, mesh, lo))
        else:
            cached = (dc.make_cached_train_step(model, config, lo,
                                                generator=generator),
                      dc.make_cached_eval_step(model, config, lo))
        stacks = (device_cache.data_stack, device_cache.truth_stack)
        steps["idx"] = tuple(
            (lambda st, rows, corners, n_valid, fn=fn:
             fn(st, *stacks, rows, corners, n_valid)) for fn in cached)

    csv = CSVLogger(config.training_log, append=True) if is_main else None
    meter = ThroughputMeter(config.patch_shape, config.image_shape)

    # schedulers built after the restore keep the resumed LR, bests and
    # patience counters
    plateau = ReduceLROnPlateau(state.learning_rate,
                                factor=config.learning_rate_drop,
                                patience=config.patience)
    early = EarlyStopping(patience=config.early_stop)
    plateau.best = sched.get("plateau_best", best_val)
    plateau.wait = int(sched.get("plateau_wait", 0))
    early.best = sched.get("early_best", best_val)
    early.wait = int(sched.get("early_wait", 0))

    x_bf16 = getattr(model, "dtype", None) == torch.bfloat16

    def stage_host(x, y, bs):
        """Pad to the static batch, compress, keep this rank's rows (the
        GSPMD steps take the whole batch) and start the upload."""
        x, y, n_valid = pad_batch(x, y, bs)
        x = torch.from_numpy(np.ascontiguousarray(x))
        if x_bf16:
            x = x.to(torch.bfloat16)
        yb = y.astype(np.uint8)
        if np.array_equal(y, yb):
            y = yb
        if dp and not spatial:
            x, y = shard_batch(mesh, x, y)
        return "host", to_device(x, device), to_device(y, device), n_valid

    def stage_idx(rows, corners, n_valid):
        """Rows and corners as one (B, 4) int32 tensor: one small upload,
        split again on the device."""
        idx = to_device(np.concatenate([rows[:, None], corners], axis=1),
                        device)
        return "idx", idx[:, 0], idx[:, 1:], n_valid

    def stage(batch, bs):
        """Every batch becomes ``(kind, a, b, n_valid)``: kind "idx" is the
        cached gather's (rows, corners), kind "host" staged (x, y) patches.
        Only a partial cache's generators tag their batches themselves."""
        if partial_cache:
            kind, a, b, n_valid = batch
            return (stage_idx(a, b, n_valid) if kind == "idx"
                    else stage_host(a, b, bs))
        return stage_idx(*batch) if use_cache else stage_host(*batch, bs)

    def batches(gen, n_steps, bs):
        return prefetch((next(gen) for _ in range(n_steps)), size=2,
                        device_put=lambda b: stage(b, bs))

    dice_history: list = []
    collapse_warned = False
    for epoch in range(start_epoch, n_epochs):
        # a hybrid mesh augments the whole batch alike on every rank
        generator.manual_seed(epoch_seed(
            seed, epoch, mesh.rank if dp and not spatial else None))
        meter.reset()
        t0 = time.perf_counter()
        train_metrics, weights = [], []
        for kind, a, b, n_valid in batches(training_generator,
                                           steps_per_epoch, batch_size):
            train_metrics.append(steps[kind][0](state, a, b, n_valid))
            weights.append(n_valid)
            meter.add(n_valid)
        train = _weighted_means(train_metrics, weights)  # synchronizes
        train_time = time.perf_counter() - t0
        rates = meter.rates()

        val = {}
        if has_validation:
            val_metrics, vweights = [], []
            for kind, a, b, n_valid in batches(validation_generator,
                                               validation_steps,
                                               val_batch_size):
                val_metrics.append(steps[kind][1](state, a, b, n_valid))
                vweights.append(n_valid)
            val = _weighted_means(val_metrics, vweights)

        row = {}
        for key, value in train.items():
            name = "dice_coefficient" if key == "dice" else key
            row[name] = value
            if has_validation:
                row[f"val_{name}"] = val[key]
        row.update({"lr": state.learning_rate, **rates,
                    "epoch_time_sec": train_time})
        if is_main:
            csv.log(epoch, row)
        if verbose:
            val_part = (f"val_loss={row['val_loss']:.4f} "
                        if has_validation else "")
            print(f"epoch {epoch}: loss={row['loss']:.4f} "
                  f"{val_part}lr={row['lr']:.2e} "
                  f"{row['patches_per_sec']:.1f} patches/s", flush=True)

        dice_history.append(row.get("dice_coefficient", 1.0))
        if not collapse_warned and detect_dice_collapse(dice_history):
            collapse_warned = True
            if is_main:
                print(f"[warning] training dice < 0.01 for the last 3 "
                      f"epochs — the sigmoid has likely saturated and the "
                      f"soft-Dice gradient vanished. Lower "
                      f"initial_learning_rate (current "
                      f"{config.initial_learning_rate:g}) and restart with "
                      f"overwrite.")

        # without validation the monitored quantity is the training loss
        val_loss = row["val_loss"] if has_validation else row["loss"]
        improved = val_loss < best_val
        if improved:
            best_val = val_loss
        if config.learning_rate_epochs:
            new_lr = step_decay(epoch, config.initial_learning_rate,
                                config.learning_rate_drop,
                                config.learning_rate_epochs)
        else:
            new_lr = plateau.update(val_loss)
        if abs(new_lr - state.learning_rate) > 1e-12:
            state.set_learning_rate(new_lr)
        stop = bool(config.early_stop) and early.update(val_loss)
        if stop and verbose:
            print(f"[early stop] epoch {epoch}")
        # checkpoint after the scheduler updates, so the saved patience
        # counters and a coincident LR drop are this epoch's final state
        if improved and is_main:
            # the run's data-order mode goes into the sidecar, so a resume
            # reproduces the batch boundaries (a partial cache's grouping
            # depends on WHICH cases are resident)
            data_order = (
                {"mode": "partial",
                 "resident": sorted(device_cache.resident_cases)}
                if partial_cache else {"mode": "lockstep"})
            ckpt.save(state, epoch=epoch + 1, best_val=best_val,
                      sched={"plateau_best": plateau.best,
                             "plateau_wait": plateau.wait,
                             "early_best": early.best,
                             "early_wait": early.wait},
                      data_order=data_order)
        if stop:
            break
    return state
