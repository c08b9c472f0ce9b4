#!/usr/bin/env python
"""Where one train step's device time goes in the PyTorch port.

    python tools/profile_torch_training.py [--config configs/fetal_unet.json]
        [--trace-dir DIR]

Needs a CUDA device. Builds the config's model (UNet3D or Isensee2017)
with random weights (seed 0), once with both kernel switches on and once
with both off, and runs the port's train step (augmentation, dropout,
forward, dice loss, backward, Adam) on one synthetic batch of the config's
patches: one warm-up step, three timed steps, then one step under
``torch.profiler``. Prints, for each: host
seconds per step (ending in a synchronize); the port's spans of the
profiled step (``train.step`` and its phases ``train.augment``,
``train.forward``, ``train.backward``, ``train.update``: count, host ms
and the device ms launched inside); the kernels with the most device
time, and the host ops that launched them. ``--trace-dir`` also writes the Chrome traces.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from profile_torch_serving import profile  # noqa: E402


def main(config_path: str, trace_dir=None) -> None:
    import subprocess

    import torch

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_training: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    base = Config.load(config_path)
    weights = from_flax(init_flax_like(base, seed=0))
    rng = np.random.default_rng(0)
    shape = (base.batch_size, base.nb_channels) + tuple(base.patch_shape)
    y = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    x = x + 2 * y
    for label, on in (("kernels_on", True), ("kernels_off", False)):
        config = dataclasses.replace(base, use_pallas_conv=on,
                                     use_pallas_dec0=on)
        model = build_model(config, "cuda")
        model.load_state_dict(weights)
        state = create_train_state(model, config)
        step = make_train_step(
            model, config,
            generator=torch.Generator(device="cuda").manual_seed(0))
        profile(lambda: step(state, x, y), label, trace_dir, top=16,
                unit="step")
        del model, state, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(
        ROOT, "configs", "fetal_unet.json"))
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    main(args.config, args.trace_dir)
