#!/usr/bin/env python
"""Where one 128^3 case's device time goes in the PyTorch port's serving.

    python tools/profile_torch_serving.py [--config configs/fetal_unet.json]
        [--trace-dir DIR]

Needs a CUDA device. Builds the config's model (UNet3D or Isensee2017)
with random weights (seed 0), once with both kernel switches on and once
with both off, and predicts one synthetic preprocessed volume with
``SlidingWindowPredictor.
predict_labels`` (one warm-up, then three timed runs, then one run under
``torch.profiler``). Prints, for each: host seconds per case (ending in a
synchronize); the port's spans of the profiled case
(``fetal_mri_segmentation_tpu_torch/utils/profiling.py``: per span name
its count, its host ms and the device ms of the operations launched
inside it, summed); the kernels with the most device time, and the host
ops that launched them. ``--trace-dir`` also
writes the Chrome traces.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def print_spans(records, device: dict, label: str, unit: str) -> None:
    """Per span name of ``records`` (``utils/profiling.py::span_records``):
    the count, the host ms summed, and the device ms of the operations
    launched inside (``device``, from ``span_device_ms``), in the order
    the names first ended; then the device ms launched outside every
    span."""
    rows = {}
    for r in records:
        count, host = rows.get(r["name"], (0, 0.0))
        rows[r["name"]] = (count + 1, host + r["host_ms"])
    print(f"{label}: the port's spans of the profiled {unit} "
          "(count, host ms, device ms launched inside)")
    for name, (count, host) in rows.items():
        print(f"  {name:24s} {count:6d} {host:10.3f} "
              f"{device.get(name, 0.0):10.3f}")
    print(f"  {'(outside every span)':24s} {'':6s} {'':10s} "
          f"{device.get(None, 0.0):10.3f}")


def profile(run, label: str, trace_dir=None, top: int = 12,
            unit: str = "case"):
    """Time ``run()`` (one warm-up, three timed calls ending in a
    synchronize), then profile one call and print the port's spans of it
    and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act, instance_norm_act_backward)
    from fetal_mri_segmentation_tpu_torch.utils.profiling import (
        reset_spans, span_device_ms, span_records)

    run()
    torch.cuda.synchronize()
    instance_norm_act.launches = instance_norm_act_backward.launches = 0
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    norm_launches = instance_norm_act.launches / 3
    backward_launches = instance_norm_act_backward.launches / 3
    reset_spans()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    print(f"{label}: {wall:.4f} s/{unit} (host clock, 3 runs)")
    print(f"{label}: fused norm launches per {unit}: {norm_launches:g} "
          f"forward, {backward_launches:g} backward")
    print_spans(span_records(),
                span_device_ms(prof.profiler.kineto_results.events()),
                label, unit)
    events = prof.key_averages()
    # device kernels; a user annotation (a span's range) spans kernels
    # already counted
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    print(f"{label}: kernels by device time")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d} calls  {e.key[:120]}")
    # the host ops that launched them (the kernels' device time by op)
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    print(f"{label}: device time by launching op")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d} calls  {e.key[:120]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))


def main(config_path: str, trace_dir=None) -> None:
    import subprocess

    import torch

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        build_serving_predictor)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    base = Config.load(config_path)
    state = from_flax(init_flax_like(base, seed=0))
    data = np.random.default_rng(0).normal(
        size=(base.nb_channels,) + tuple(base.image_shape)).astype(np.float32)
    for label, on in (("kernels_on", True), ("kernels_off", False)):
        config = dataclasses.replace(base, use_pallas_conv=on,
                                     use_pallas_dec0=on)
        model = build_model(config, "cuda")
        model.load_state_dict(state)
        predictor = build_serving_predictor(
            model, config, overlap=config.validation_patch_overlap,
            device="cuda")
        profile(lambda: predictor.predict_labels(data), label, trace_dir)
        del model, predictor
        torch.cuda.empty_cache()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "fetal_unet.json"))
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    main(args.config, args.trace_dir)
