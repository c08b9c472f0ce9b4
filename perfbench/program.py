"""The system under test, as the traffic modules reach it: the port's
configuration and model with the benchmark's weights, and the faults the
correctness tests plant in it.

Only ``fetal_mri_segmentation_tpu_torch`` is imported here, and only when
a function runs."""

from __future__ import annotations

import contextlib

import numpy as np


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (weights, cases, draws) of a run's seed."""
    words = [int(seed) % (2 ** 64)] + [ord(c) for c in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def config(cfg: dict):
    """The port's ``Config`` of a configuration file (its ``_`` keys are
    notes)."""
    from fetal_mri_segmentation_tpu_torch.config import Config

    return Config.from_dict({k: v for k, v in cfg.items()
                             if not k.startswith("_")})


def model(conf, weights: dict, device):
    """The configured model on ``device``, holding ``weights``."""
    from fetal_mri_segmentation_tpu_torch.models import build_model

    m = build_model(conf, device)
    m.load_state_dict(weights, strict=True)
    return m


def serving_predictor(m, conf, params: dict):
    """The predictor the ``predict`` CLI builds, with the cell's overlap
    and patch batch."""
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        build_serving_predictor)

    return build_serving_predictor(m, conf, overlap=int(params["overlap"]),
                                   patch_batch_size=int(params["patch_batch"]))


# ---------------------------------------------------------------- faults
# Each is a context manager that breaks the timed path underneath, for the
# tests and the fault readings that must make ``correct`` false.


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def altered_labels():
    """Serving: the label map altered where it is produced (two depth
    rows of every case inverted)."""
    from fetal_mri_segmentation_tpu_torch.inference import sliding_window

    original = sliding_window.device_label_map

    def altered(*args, **kwargs):
        out = original(*args, **kwargs).clone()
        out[:2] = 1 - out[:2]
        return out

    return _patched(sliding_window, "device_label_map", altered)


def unchanged_state():
    """Training: the optimizer's step leaves the state as it was."""
    from fetal_mri_segmentation_tpu_torch.training import state

    return _patched(state.KerasAdam, "step", lambda self, closure=None: None)


def half_batch():
    """Training: half of the batch left out, the mean taken over the
    rest."""
    from fetal_mri_segmentation_tpu_torch.training import train_step

    original = train_step._entry

    def half(model, x, y):
        x, y = original(model, x, y)
        n = x.shape[0] // 2
        return x[:n], y[:n]

    return _patched(train_step, "_entry", half)


FAULTS = {"altered_labels": altered_labels,
          "unchanged_state": unchanged_state, "half_batch": half_batch}
