"""Epoch-level training callbacks: CSV logging, LR schedules, early stopping
and the throughput meter.

A copy of ``fetal_mri_segmentation_tpu/training/callbacks.py``, which is
plain Python: the port cannot import it, because the JAX package's
``training/__init__.py`` imports jax. Tests hold the copy equal to the
original.
"""

from __future__ import annotations

import csv
import math
import os
import time
from typing import Dict, Optional


def step_decay(epoch: int, initial_lrate: float, drop: float,
               epochs_drop: int) -> float:
    """lr = init * drop^floor((1+epoch)/epochs_drop).

    Reference: training.py::step_decay.
    """
    return initial_lrate * math.pow(drop,
                                    math.floor((1 + epoch) / float(epochs_drop)))


class ReduceLROnPlateau:
    """Multiply lr by `factor` after `patience` epochs without val improvement.

    Keras-semantics subset the reference uses (monitor val_loss, mode min).
    """

    def __init__(self, initial_lr: float, factor: float = 0.5,
                 patience: int = 10, min_delta: float = 1e-4,
                 min_lr: float = 0.0):
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.min_delta = min_delta
        self.min_lr = min_lr
        self.best = float("inf")
        self.wait = 0

    def update(self, val_loss: float) -> float:
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.wait = 0
        return self.lr


class EarlyStopping:
    """Stop after `patience` epochs without val improvement (mode min)."""

    def __init__(self, patience: int = 50, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.wait = 0

    def update(self, val_loss: float) -> bool:
        """Returns True when training should stop."""
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.wait = 0
            return False
        self.wait += 1
        return self.wait >= self.patience


class CSVLogger:
    """Append-mode per-epoch CSV, Keras CSVLogger surface (training.log).

    Adds step-level throughput columns (patches/sec, volumes-equivalent/sec)
    — the observability the reference lacked (SURVEY.md section 5.1/5.5).
    """

    def __init__(self, filename: str, append: bool = True):
        self.filename = filename
        self._fieldnames = None
        if not append and os.path.exists(filename):
            os.remove(filename)

    def _read_header(self):
        """Just the header line of the current file, or None (cheap — no
        row materialization; a resumed 500-epoch log is read fully only on
        the rare header-widening rewrite)."""
        if not os.path.exists(self.filename):
            return None
        with open(self.filename, newline="") as f:
            return next(csv.reader(f), None)

    def _read_existing(self):
        """(header, rows) of the current file, or (None, [])."""
        if not os.path.exists(self.filename):
            return None, []
        with open(self.filename, newline="") as f:
            reader = csv.reader(f)
            try:
                header = next(reader)
            except StopIteration:
                return None, []
            return header, [dict(zip(header, r)) for r in reader]

    def log(self, epoch: int, row: Dict[str, float]) -> None:
        row = {"epoch": epoch, **{k: float(v) for k, v in row.items()}}
        if self._fieldnames is None:
            # resume-append: adopt the existing file's header, don't assume
            # this run logs the same columns the original run did
            self._fieldnames = self._read_header()
        new_keys = [k for k in row if k not in (self._fieldnames or ())]
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
            with open(self.filename, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writeheader()
        elif new_keys:
            # a resumed run added metrics (e.g. label-wise dice toggled on):
            # widen the header and rewrite history instead of silently
            # dropping the new columns
            rows = self._read_existing()[1]
            self._fieldnames = list(self._fieldnames) + new_keys
            with open(self.filename, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames, restval="")
                w.writeheader()
                w.writerows(rows)
        with open(self.filename, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fieldnames, restval="",
                           extrasaction="ignore").writerow(row)


class ThroughputMeter:
    """Patches/sec + volumes/sec meter for the BASELINE metric."""

    def __init__(self, patch_shape, image_shape):
        patch_vox = 1
        for s in patch_shape or image_shape:
            patch_vox *= s
        image_vox = 1
        for s in image_shape:
            image_vox *= s
        self.vox_ratio = patch_vox / image_vox
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._patches = 0

    def add(self, n_patches: int):
        self._patches += n_patches

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        pps = self._patches / dt
        return {"patches_per_sec": pps,
                "volumes_per_sec": pps * self.vox_ratio}
