"""Closed-loop ingest of NIfTI cases on disk into label-map NIfTI files on
disk, through ``inference/predict.py::predict_cases_pipelined`` as the
``predict`` CLI runs it (host preprocessing, crop on, ``save_inputs``
off).

Parameters (the cell's workload file): ``pool`` raw volumes of
``raw_shape`` (``inputs.croppable``: foreground in a zero background, so
the crop shrinks it), with voxel ``spacing``, are written as gzipped
NIfTI under ``TMPDIR`` in set-up and cycled; each case's output directory
is its pool slot's, reused, so a run writes a few hundred MB at most.
``overlap``, ``patch_batch`` and ``threshold`` as for the window traffic;
``warm`` cases warm up; ``checked`` of the slots that were written,
drawn from the seed, are held to the reference through the label file
their last case wrote, read back;
``trace_cases`` cases go through each profiled stretch.
"""

from __future__ import annotations

import atexit
import os
import random
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench import inputs, profiling, program
from perfbench.reference import ingest, models
from perfbench.traffic.window import (central_patch, margin_checks,
                                      reference_margin)

# the faults (``program.FAULTS``) this kind's cells can have: each
# must make ``correct`` false (``tests/test_pb_cells.py``)
FAULTS = ["altered_labels"]


class Run:
    def __init__(self, cell, seed, device):
        self.cfg, self.seed, self.device = cell["config"], seed, device
        self.params = cell["spec"]["params"]
        self.limits = cell["spec"]["limits"]
        self.attempted = self.failed = 0
        self.next = 0

    def setup(self):
        p = self.params
        self.conf = program.config(self.cfg)
        self.weights = inputs.make_weights(
            self.cfg, program.subseed(self.seed, "weights"), self.device)
        self.dir = tempfile.mkdtemp(prefix="perfbench-nifti-")
        atexit.register(shutil.rmtree, self.dir, True)
        rng = np.random.default_rng(program.subseed(self.seed, "cases"))
        vols = [inputs.croppable(rng, p["raw_shape"])
                for _ in range(int(p["pool"]))]
        affine = np.diag(list(p["spacing"]) + [1.0])
        self.inputs = [os.path.join(self.dir, f"case_{i}.nii.gz")
                       for i in range(len(vols))]
        self.outputs = [os.path.join(self.dir, f"out_{i}")
                        for i in range(len(vols))]
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(lambda a: inputs.write_nifti(a[0], a[1], affine),
                          zip(vols, self.inputs)))
        inputs.center_head(self.weights, self.cfg, central_patch(
            ingest.prepare(self.inputs[0], self.cfg["image_shape"],
                           self.device), self.cfg))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.model = program.model(self.conf, self.weights, self.device)
        self.predictor = program.serving_predictor(self.model, self.conf, p)
        self.done = set()
        self._ingest(cases=int(p["warm"]))

    def _ingest(self, seconds=None, cases=None):
        from fetal_mri_segmentation_tpu_torch.inference.predict import (
            predict_cases_pipelined)

        t0 = time.perf_counter()

        def stream():
            n = 0
            while ((seconds is None or time.perf_counter() - t0 < seconds)
                   and (cases is None or n < cases)):
                i, n = self.next, n + 1
                self.next += 1
                self.attempted += 1
                slot = i % len(self.inputs)
                self.done.add(slot)
                yield self.inputs[slot], self.outputs[slot]

        n = predict_cases_pipelined(
            stream(), self.predictor, self.conf,
            threshold=float(self.params["threshold"]), save_inputs=False,
            verbose=False)
        return time.perf_counter() - t0, n

    def window(self, seconds):
        span, n = self._ingest(seconds=seconds)
        return {"ingest_cases_per_s": n / span}

    def traced(self):
        from fetal_mri_segmentation_tpu_torch.inference import predict

        host, original = [], predict.preprocess_case

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                with profiling.ranged("preprocess_case", True):
                    return original(*args, **kwargs)
            finally:
                host.append((time.perf_counter() - t) * 1e3)

        k = int(self.params["trace_cases"])
        predict.preprocess_case = timed
        try:
            rec = profiling.two_stretches(lambda n: self._ingest(cases=n), k)
        finally:
            predict.preprocess_case = original
        rec.update(kind="ingest", items=k, host_ms={"preprocess_case": host})
        return rec

    def release(self):
        del self.model, self.predictor
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _margins(self, control=False):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        p, margins = self.params, []
        slots = random.Random(program.subseed(self.seed, "check")).sample(
            sorted(self.done), min(int(p["checked"]), len(self.done)))
        for slot in sorted(slots):
            labels, _ = ingest.read_nifti(
                os.path.join(self.outputs[slot], "prediction.nii.gz"))
            volume = ingest.prepare(self.inputs[slot],
                                    self.cfg["image_shape"], self.device)
            margins.append(reference_margin(
                self.weights, self.cfg, volume, labels,
                self.cfg["patch_shape"], int(p["overlap"]),
                int(p["reference_batch"]), models.quantize_fp8, control))
        return margins

    def check(self):
        return margin_checks(self._margins(), self.limits)

    def control(self):
        """The control's readings: the reference at float8 in the
        program's place."""
        return margin_checks(self._margins(control=True), self.limits)
