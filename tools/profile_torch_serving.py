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
synchronize), device-busy seconds from the profiler's CUDA kernel times, the
idle share, and the kernels with the most device time. ``--trace-dir``
also writes the Chrome traces.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile(run, label: str, trace_dir=None, top: int = 12,
            unit: str = "case"):
    """Time ``run()`` (one warm-up, three timed calls ending in a
    synchronize), then profile one call and print the device-busy time,
    the idle share and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device kernels; a user annotation (the optimizer's step range) spans
    # kernels already counted
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"{label}: {wall:.4f} s/{unit} (host clock, 3 runs); device busy "
          f"{busy_us / 1e6:.4f} s in the profiled run; idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
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
