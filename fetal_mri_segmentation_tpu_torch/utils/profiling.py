"""Tracing hook (port of ``fetal_mri_segmentation_tpu/utils/profiling.py::
trace`` on ``torch.profiler``).

``trace(logdir)`` profiles everything inside the context, host and device,
and writes one Chrome-trace JSON file under ``logdir`` (loadable in
Perfetto, ``chrome://tracing`` or TensorBoard's profile plugin): what
``python -m fetal_mri_segmentation_tpu_torch.train --profile LOGDIR``
needs. A profiled run is slower and its trace grows with the steps, so
profile a short run.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context into ``logdir``; yields the
    path of the trace file, which is written when the context ends."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        yield path
    finally:
        profiler.stop()
        profiler.export_chrome_trace(path)
