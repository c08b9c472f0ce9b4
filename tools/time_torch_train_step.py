#!/usr/bin/env python
"""Milliseconds per train step of the PyTorch port, for comparing two trees.

    python tools/time_torch_train_step.py [LABEL]

Needs a CUDA device. Run it from the root of a checkout (copy it into an
older checkout to time that one: it uses only the port's public training
API). For ``configs/fetal_unet.json`` and ``configs/fetal_isensee.json``,
both kernel switches on, random weights from seed 0 and one synthetic batch
of the config's patches, it takes one warm-up step and then prints three
means of 20 steps each (CUDA events), after ``LABEL``. To compare two
commits, run both trees in turns inside one session on one card (parent,
change, change, parent): the host's load moves these numbers by several
per cent from one process to the next.
"""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.getcwd()
sys.path.insert(0, ROOT)


def main(label: str) -> None:
    import torch

    import chip_smoke
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for name in ("fetal_unet", "fetal_isensee"):
        cfg = Config.load(os.path.join(ROOT, "configs", f"{name}.json"))
        cfg = dataclasses.replace(cfg, use_pallas_conv=True,
                                  use_pallas_dec0=True)
        x_np, y_np = chip_smoke.train_batch(cfg)
        x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
        model = build_model(cfg, "cuda")
        model.load_state_dict(from_flax(init_flax_like(cfg, seed=0)))
        state = create_train_state(model, cfg)
        step = make_train_step(
            model, cfg, generator=torch.Generator(device="cuda").manual_seed(0))
        step(state, x, y)
        torch.cuda.synchronize()
        ms = [chip_smoke.time_ms(torch, lambda: step(state, x, y), iters=20)
              for _ in range(3)]
        out.append(f"{name} step ms " + " ".join(f"{m:.3f}" for m in ms))
        del model, state, step
        torch.cuda.empty_cache()
    print(label, "; ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.basename(ROOT))
