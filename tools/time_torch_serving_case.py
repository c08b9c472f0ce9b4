"""Time one serving case and one kernel launch of the PyTorch port on the GPU.

    python tools/time_torch_serving_case.py [--repeats N]

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line: the seconds of ``SlidingWindowPredictor.predict_labels`` on one 128^3
volume of ``configs/fetal_unet.json`` (27 patches of 64^3 in batches of 8,
weights from seed 0) with the Hopper kernels on and off (host clock around
``N`` calls that end in a synchronize, after one warm-up call, in turns:
on, off, on, off), and the host microseconds of one call of the public
conv wrapper ``ops/conv3x3.py::conv3x3_flat`` on a shape whose device time
is small (1 x 8^3 x 64 -> 64), over 500 calls with no synchronize between
them. It uses only entry points that every version of the port has, so
two checkouts can be compared in one run of the card:
``python tools/time_torch_serving_case.py`` in each, in turns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(repeats: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
        SlidingWindowPredictor)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    base = Config.load(str(ROOT / "configs" / "fetal_unet.json"))
    weights = from_flax(init_flax_like(base, seed=0))
    volume = np.random.default_rng(0).normal(
        size=(1,) + tuple(base.image_shape)).astype(np.float32)
    predictors = {}
    for tag, on in (("on", True), ("off", False)):
        cfg = dataclasses.replace(base, use_pallas_conv=on,
                                  use_pallas_dec0=on)
        model = build_model(cfg, "cuda")
        model.load_state_dict(weights)
        predictors[tag] = SlidingWindowPredictor(
            model, cfg, cfg.image_shape,
            overlap=cfg.validation_patch_overlap)
        predictors[tag].predict_labels(volume)
    case_s = {"on": [], "off": []}
    for tag in ("on", "off", "on", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            predictors[tag].predict_labels(volume)
        torch.cuda.synchronize()
        case_s[tag].append((time.perf_counter() - t0) / repeats)

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 8, 8, 8, 64, device="cuda", generator=gen).to(
        torch.bfloat16)
    w = (torch.randn(3, 3, 3, 64, 64, device="cuda", generator=gen)
         * 0.03).to(torch.bfloat16)
    b = torch.zeros(64, device="cuda")
    with torch.inference_mode():
        for _ in range(20):
            conv_ops.conv3x3_flat(x, w, b, "relu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            conv_ops.conv3x3_flat(x, w, b, "relu")
        host_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    return {"case_s_on": case_s["on"], "case_s_off": case_s["off"],
            "launch_host_us": host_us, "device": torch.cuda.get_device_name(0)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=10)
    print(json.dumps(main(ap.parse_args().repeats)))
