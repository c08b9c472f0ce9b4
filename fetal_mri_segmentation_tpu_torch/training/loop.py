"""The epoch loop on one device (port of
``fetal_mri_segmentation_tpu/training/loop.py::train_model``).

Epochs over the training generator with validation after each; the best
checkpoint, the learning-rate plateau or step decay, early stopping, the
Keras-schema CSV log, the dice-collapse warning and resume from the port's
own checkpoint. Batches are padded to the static batch size (the padded
tail masked out of the loss), staged as bf16 x and uint8 y where that is
exact enough (see :func:`train_model`), and moved to the device by the
prefetch thread. Step metrics stay on the device and are read once per
epoch.
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


def epoch_seed(seed: int, epoch: int) -> int:
    """The step generator's seed for ``epoch`` (it draws the augmentation
    and Isensee2017's dropout masks): a pure function of (seed, epoch), so
    a resumed run draws what an uninterrupted one drew."""
    return int(np.random.SeedSequence((seed, epoch)).generate_state(1)[0])


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
    integral. ``mesh`` (DDP) and ``device_cache`` are not ported yet and
    raise."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: multi-device training needs DDP, not ported yet "
            "(ROADMAP.md queue 1, DDP)")
    if device_cache is not None:
        raise NotImplementedError(
            "device_cache: the device-resident case cache is not ported yet "
            "(ROADMAP.md queue 1, the device case cache)")
    n_epochs = n_epochs if n_epochs is not None else config.n_epochs
    batch_size = config.batch_size
    val_batch_size = config.validation_batch_size or batch_size
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
        if peeked is not None and peeked != start_epoch:
            print(f"[resume] warning: checkpoint epoch {start_epoch} != "
                  f"sidecar epoch {peeked} — the data order of this resumed "
                  "run will not exactly match an uninterrupted run")

    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    train_step = make_train_step(model, config, generator=generator)
    eval_step = make_eval_step(model, config)
    csv = CSVLogger(config.training_log, append=True)
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

    def stage(x, y, bs):
        x, y, n_valid = pad_batch(x, y, bs)
        x = torch.from_numpy(np.ascontiguousarray(x))
        if x_bf16:
            x = x.to(torch.bfloat16)
        yb = y.astype(np.uint8)
        if np.array_equal(y, yb):
            y = yb
        return (to_device(x, device), to_device(y, device), n_valid)

    def batches(gen, n_steps, bs):
        return prefetch((next(gen) for _ in range(n_steps)), size=2,
                        device_put=lambda b: stage(*b, bs))

    dice_history: list = []
    collapse_warned = False
    for epoch in range(start_epoch, n_epochs):
        generator.manual_seed(epoch_seed(seed, epoch))
        meter.reset()
        t0 = time.perf_counter()
        train_metrics, weights = [], []
        for x, y, n_valid in batches(training_generator, steps_per_epoch,
                                     batch_size):
            train_metrics.append(train_step(state, x, y, n_valid))
            weights.append(n_valid)
            meter.add(n_valid)
        train = _weighted_means(train_metrics, weights)  # synchronizes
        train_time = time.perf_counter() - t0
        rates = meter.rates()

        val = {}
        if has_validation:
            val_metrics, vweights = [], []
            for x, y, n_valid in batches(validation_generator,
                                         validation_steps, val_batch_size):
                val_metrics.append(eval_step(state, x, y, n_valid))
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
            print(f"[warning] training dice < 0.01 for the last 3 epochs — "
                  f"the sigmoid has likely saturated and the soft-Dice "
                  f"gradient vanished. Lower initial_learning_rate (current "
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
        if improved:
            ckpt.save(state, epoch=epoch + 1, best_val=best_val,
                      sched={"plateau_best": plateau.best,
                             "plateau_wait": plateau.wait,
                             "early_best": early.best,
                             "early_wait": early.wait})
        if stop:
            break
    return state
