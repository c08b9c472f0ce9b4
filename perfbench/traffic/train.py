"""Back-to-back train steps of ``training/train_step.py::make_train_step``.

Parameters (the cell's workload file): ``cases`` synthetic volumes of the
configuration's ``image_shape`` are made on the device in set-up
(``inputs.ellipsoid_cases``, z-scored per volume, held in the model's
compute dtype with uint8 truths, as the loop stages them); every step cuts
``batch_size`` patches of ``patch_shape`` on the card at corners drawn from
the seed, all different. The step's generator is seeded by the benchmark
and handed to ``make_train_step``; the configuration's augmentation runs on
the device. The step's metrics stay on the device and are read once, at
the end of the window, as ``training/loop.py`` reads them once an epoch.

Set-up drives the step through its first ``compared_steps`` steps, the
same call and feed as the window's; they are the warm-up, and what the
reference follows. Recorded from them: the first step's loss, each leaf's
first gradient as the optimizer got it (its first moment after one step
over 1 - beta1) and each leaf's change after the compared steps.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from perfbench import flops, inputs, profiling, program
from perfbench.families import family
from perfbench.reference import models
from perfbench.reference import train as ref_train

BETA1 = 0.9
# the faults (``program.FAULTS``) this kind's cells can have: each
# must make ``correct`` false (``tests/test_pb_cells.py``)
FAULTS = ["unchanged_state", "half_batch"]


def leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """Each leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keys))


# the numbers a train cell can compare; a cell compares those its
# ``limits`` name
NUMBERS = ("first_loss_gap", "grad_gap", "change_gap", "median_grad_gap")


def readings(losses, grads, changes, ref) -> dict:
    """The numbers compared (``NUMBERS``), from one side's losses and
    per-leaf gradient and change norms against the reference's ``ref``
    (``reference/train.py::run_steps``). ``median_grad_gap``: the median
    leaf's first-gradient gap, over the leaves that move, which the
    rounding of one leaf does not swing as it swings the worst leaf's."""
    gr = {k: float(g.norm()) for k, g in ref["first_grad"].items()}
    med = statistics.median(gr.values())
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone under Adam: left out of the change by this rule
    moving = [k for k in gr if gr[k] >= 1e-3 * med]
    cr = {k: float((ref["params"][k] - ref["start"][k]).norm())
          for k in moving}
    # the first step's loss: later losses follow Adam's first, sign-like
    # update, which turns rounding-sized gradient differences into whole
    # learning-rate steps on the leaves' near-zero elements
    return {"first_loss_gap": abs(losses[0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap": leaf_gap(grads, gr, list(gr)),
            "change_gap": leaf_gap(changes, cr, moving),
            "median_grad_gap": statistics.median(leaf_gaps(grads, gr,
                                                           moving))}


class Run:
    def __init__(self, cell, seed, device):
        self.cfg, self.seed, self.device = cell["config"], seed, device
        self.params = cell["spec"]["params"]
        self.limits = cell["spec"]["limits"]
        self.attempted = self.failed = 0
        self.batch = int(self.cfg["batch_size"])

    def _feed(self):
        """One batch: (B, 1) + patch from the cases, at corners drawn from
        the seed."""
        patch = self.cfg["patch_shape"]
        size = self.cfg["image_shape"]
        which = self.feed_rng.integers(0, self.xs.shape[0], self.batch)
        at = [self.feed_rng.integers(0, s - p + 1, self.batch)
              for s, p in zip(size, patch)]
        win = [(c, slice(a, a + patch[0]), slice(b, b + patch[1]),
                slice(d, d + patch[2]))
               for c, a, b, d in zip(which.tolist(), at[0].tolist(),
                                     at[1].tolist(), at[2].tolist())]
        x = torch.stack([self.xs[c, :, a, b, d] for c, a, b, d in win])
        y = torch.stack([self.ys[c, :, a, b, d] for c, a, b, d in win])
        return x, y

    def setup(self):
        self.conf = program.config(self.cfg)
        self.weights = inputs.make_weights(
            self.cfg, program.subseed(self.seed, "weights"), self.device)
        from fetal_mri_segmentation_tpu_torch.training.state import (
            create_train_state)
        from fetal_mri_segmentation_tpu_torch.training.train_step import (
            make_train_step)

        self.model = program.model(self.conf, self.weights, self.device)
        self.state = create_train_state(self.model, self.conf)
        self.step = make_train_step(
            self.model, self.conf, generator=inputs.generator(
                program.subseed(self.seed, "augment"), self.device))
        x, y = inputs.ellipsoid_cases(
            int(self.params["cases"]), self.cfg["image_shape"],
            program.subseed(self.seed, "cases"), self.device)
        self.xs = inputs.normalize(x).to(self.model.dtype)
        self.ys = y
        self.feed_rng = np.random.default_rng(
            program.subseed(self.seed, "feed"))
        self.batches, losses = [], []
        names = [k for k, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        for t in range(int(self.params["compared_steps"])):
            x, y = self._feed()
            self.batches.append((x, y))
            losses.append(self.step(self.state, x, y)["loss"])
            self.attempted += 1
            if t == 0:
                opt = self.state.optimizer.state
                self.grads = {k: float(opt[params[k]]["mu"].norm()) / (
                    1 - BETA1) if params[k] in opt else 0.0 for k in names}
        with torch.no_grad():
            self.changes = {k: float((params[k] - self.weights[k]).norm())
                            for k in names}
        self.losses = [float(v) for v in losses]

    def _steps(self, seconds=None, steps=None, trace=False):
        metrics, n = [], 0
        t0 = time.perf_counter()
        while ((seconds is None or time.perf_counter() - t0 < seconds)
               and (steps is None or n < steps)):
            with profiling.ranged("feed", trace):
                x, y = self._feed()
            with profiling.ranged("step", trace):
                metrics.append(self.step(self.state, x, y))
            n += 1
            self.attempted += 1
        with profiling.ranged("read_metrics", trace):
            losses = torch.stack([m["loss"] for m in metrics]).cpu()
        if not bool(torch.isfinite(losses).all()):
            self.failed += int((~torch.isfinite(losses)).sum())
        return time.perf_counter() - t0, n

    def window(self, seconds):
        span, n = self._steps(seconds=seconds)
        return {"train_patches_per_s": n * self.batch / span}

    def traced(self):
        k = int(self.params["trace_steps"])
        rec = profiling.two_stretches(
            lambda n: self._steps(steps=n, trace=True), k, self.model,
            family(self.cfg).ranges())
        patch = self.cfg["patch_shape"]
        rec.update(kind="train", items=k, ranged_items=k,
                   flops_per_item=flops.train_step_flops(self.cfg, patch,
                                                         self.batch),
                   conv_bound_s_per_item=self.batch * flops.block_bound_ms(
                       self.cfg, patch) / 1e3,
                   bound_s_per_item={
                       g: self.batch * ms / 1e3 for g, ms in
                       flops.group_bound_ms(self.cfg, patch).items()})
        return rec

    def release(self):
        del self.model, self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, quant=None):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        gen = inputs.generator(program.subseed(self.seed, "augment"),
                               self.device)
        ref = ref_train.run_steps(self.weights, self.batches, self.cfg, gen,
                                  quant)
        ref["start"] = self.weights
        return ref

    def _checks(self, values):
        return [{"name": k, "value": float(values[k]),
                 "limit": float(self.limits[k])}
                for k in NUMBERS if k in self.limits]

    def check(self):
        return self._checks(readings(self.losses, self.grads, self.changes,
                                     self._reference()))

    def control(self):
        """The control's readings: the reference at float8 in the
        program's place."""
        ref = self._reference()
        low = self._reference(models.quantize_fp8)
        grads = {k: float(g.norm()) for k, g in low["first_grad"].items()}
        changes = {k: float((low["params"][k] - self.weights[k]).norm())
                   for k in low["params"]}
        return self._checks(readings(low["losses"], grads, changes, ref))

