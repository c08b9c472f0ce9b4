"""Closed-loop sliding-window serving of normalized 128^3 volumes.

Parameters (the cell's workload file): ``pool`` synthetic volumes are made
on the device in set-up (``inputs.ellipsoid_cases``, z-scored per volume)
and handed to the predictor as host float32 arrays, as ``preprocess_case``
hands them; ``overlap`` and ``patch_batch`` shape the predictor that
``inference/predict.py::build_serving_predictor`` builds; ``threshold``
cuts the label map; ``warm`` whole cases warm up every shape; each pool
slot keeps one finished case, drawn from the seed among the slot's, and
``checked`` of those slots, drawn from the seed, are held to the reference;
``trace_cases`` cases go through each profiled stretch.

The loop is ``inference/predict.py::_drive_pipeline``'s two-stage order:
case i+1 is dispatched (``predict_labels_async``) before case i's labels
are fetched (``unpack_labels``). A case's latency runs from its dispatch
call to the return of its label map on the host.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from perfbench import flops, inputs, profiling, program
from perfbench.families import family
from perfbench.reference import models, window

# the faults (``program.FAULTS``) this kind's cells can have: each
# must make ``correct`` false (``tests/test_pb_cells.py``)
FAULTS = ["altered_labels"]


def reference_margin(weights, cfg, volume, labels, patch, overlap, batch,
                     quant=None, control=False):
    """``window.flip_margin`` of ``labels`` against the float32 reference's
    probabilities of ``volume`` (1, D, H, W). With ``control``, the labels
    judged are the reference's own at ``quant`` precision instead."""
    with torch.no_grad():
        prob = window.probabilities(
            volume, lambda x: models.forward(weights, x, cfg), patch,
            overlap, batch)
        if control:
            low = window.probabilities(
                volume, lambda x: models.forward(weights, x, cfg, quant),
                patch, overlap, batch)
            labels = (low[0] > 0.5).to(torch.uint8)
            del low
    return window.flip_margin(torch.as_tensor(labels), prob)


def central_patch(volume: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The patch at the centre of ``volume`` (C, D, H, W), as (1, C, ...)."""
    at = [(n - p) // 2 for n, p in zip(volume.shape[1:], cfg["patch_shape"])]
    return volume[(slice(None),) + tuple(
        slice(a, a + p) for a, p in zip(at, cfg["patch_shape"]))][None]


def margin_checks(margins: list, limits: dict) -> list:
    """The widest ``flip_margin`` over the checked cases, with its limit.
    (The share of voxels whose label differs swings from seed to seed with
    the share of voxels near the threshold, and is not compared.)"""
    return [{"name": "flip_margin", "value": max(margins),
             "limit": float(limits["flip_margin"])}]


class Run:
    def __init__(self, cell, seed, device):
        self.cfg, self.seed, self.device = cell["config"], seed, device
        self.params = cell["spec"]["params"]
        self.limits = cell["spec"]["limits"]
        self.attempted = self.failed = 0
        self.next = 0
        self.kept, self.seen = {}, {}

    def setup(self):
        p = self.params
        self.conf = program.config(self.cfg)
        self.weights = inputs.make_weights(
            self.cfg, program.subseed(self.seed, "weights"), self.device)
        x, _ = inputs.ellipsoid_cases(
            int(p["pool"]), self.cfg["image_shape"],
            program.subseed(self.seed, "cases"), self.device)
        self.pool = inputs.normalize(x)
        self.host = [v.cpu().numpy() for v in self.pool]
        inputs.center_head(self.weights, self.cfg,
                           central_patch(self.pool[0], self.cfg))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.model = program.model(self.conf, self.weights, self.device)
        self.predictor = program.serving_predictor(self.model, self.conf, p)
        self.rng = random.Random(program.subseed(self.seed, "sample"))
        for i in range(int(p["warm"])):
            self.predictor.predict_labels(self.host[i % len(self.host)],
                                          float(p["threshold"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _finish(self, pending, trace):
        out, t, i = pending
        with profiling.ranged("fetch", trace):
            labels = self.predictor.unpack_labels(out)
        latency = time.perf_counter() - t
        # one finished case per pool slot, uniform over the slot's cases
        slot = i % len(self.host)
        self.seen[slot] = self.seen.get(slot, 0) + 1
        if self.rng.random() * self.seen[slot] < 1.0:
            self.kept[slot] = labels
        return latency

    def _serve(self, seconds=None, cases=None, trace=False):
        thr = float(self.params["threshold"])
        latencies, pending, n = [], None, 0
        t0 = time.perf_counter()
        while ((seconds is None or time.perf_counter() - t0 < seconds)
               and (cases is None or n < cases)):
            i, n = self.next, n + 1
            self.next += 1
            t = time.perf_counter()
            with profiling.ranged("dispatch", trace):
                out = self.predictor.predict_labels_async(
                    self.host[i % len(self.host)], thr)
            self.attempted += 1
            if pending is not None:
                latencies.append(self._finish(pending, trace))
            pending = (out, t, i)
        if pending is not None:
            latencies.append(self._finish(pending, trace))
        return time.perf_counter() - t0, latencies

    def window(self, seconds):
        span, lat = self._serve(seconds=seconds)
        return {"serve_cases_per_s": len(lat) / span,
                "serve_case_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def patches(self) -> int:
        return len(window.corners(self.cfg["image_shape"],
                                  self.cfg["patch_shape"],
                                  int(self.params["overlap"])))

    def traced(self):
        k = int(self.params["trace_cases"])
        rec = profiling.two_stretches(
            lambda n: self._serve(cases=n, trace=True), k, self.model,
            family(self.cfg).ranges())
        n, patch = self.patches(), self.cfg["patch_shape"]
        rec.update(kind="serve", items=k, ranged_items=k,
                   flops_per_item=n * flops.forward_flops(self.cfg, patch),
                   conv_bound_s_per_item=n * flops.block_bound_ms(
                       self.cfg, patch) / 1e3,
                   bound_s_per_item={
                       g: n * ms / 1e3 for g, ms in flops.group_bound_ms(
                           self.cfg, patch).items()})
        return rec

    def release(self):
        del self.model, self.predictor
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _margins(self, control=False):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        p = self.params
        slots = random.Random(program.subseed(self.seed, "check")).sample(
            sorted(self.kept), min(int(p["checked"]), len(self.kept)))
        return [reference_margin(self.weights, self.cfg, self.pool[slot],
                               self.kept[slot], self.cfg["patch_shape"],
                               int(p["overlap"]), int(p["reference_batch"]),
                               models.quantize_fp8, control)
                for slot in sorted(slots)]

    def check(self):
        return margin_checks(self._margins(), self.limits)

    def control(self):
        """The control's readings: the reference at float8 in the
        program's place."""
        return margin_checks(self._margins(control=True), self.limits)
