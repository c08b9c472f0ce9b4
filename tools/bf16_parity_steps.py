#!/usr/bin/env python
"""The first bf16 train steps of the multi-class recipe's model in the JAX
package and in the port, beside their fp32 steps, on the CPU: the
measurement ``chip_smoke.py``'s parity phase derives its bound from.

    JAX_PLATFORMS=cpu python tools/bf16_parity_steps.py [--steps 10]
        [--size 40] [--batch 3]

The model, the batches and the weights are the parity phase's: depth 3, 8
base filters, sigmoid over labels 1, 2, 4, weighted dice, Keras Adam at lr
5e-4, augmentation off; ``chip_smoke.py::_multiclass_batches`` (batches of
3 drawn from 6 normalized ``make_multiclass_case`` volumes of 40^3); the
weights ``utils/params.py::init_flax_like`` draws from seed 0, loaded into
both packages. Prints each step's loss for JAX fp32, JAX bf16, the port's
bf16 and fp32 (kernel switches on: their plain versions run on the CPU),
then the largest relative distance of each bf16 trajectory from JAX's
fp32 one, as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(steps: int = 10, size: int = 40, batch: int = 3) -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from flax.traverse_util import unflatten_dict

    import chip_smoke
    from fetal_mri_segmentation_tpu.config import Config as JaxConfig
    from fetal_mri_segmentation_tpu.models import build_model as jax_build
    from fetal_mri_segmentation_tpu.training import (
        create_train_state as jax_state, make_train_step as jax_step)
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    batches = chip_smoke._multiclass_batches(steps, size, batch)
    settings = dict(model_name="unet", depth=3, n_base_filters=8,
                    patch_shape=(size,) * 3, image_shape=(size,) * 3,
                    n_labels=3, labels=chip_smoke.PARITY_LABELS,
                    activation_name="sigmoid", batch_size=batch,
                    augment=False, include_label_wise_dice_coefficients=True,
                    initial_learning_rate=5e-4, fold_level0="off")
    flat = init_flax_like(Config(**settings), seed=0)

    def jax_losses(dtype):
        cfg = JaxConfig(**settings, compute_dtype=dtype)
        model = jax_build(cfg)
        state = jax_state(model, cfg, jax.random.PRNGKey(0))
        state = state.replace(params=jax.tree_util.tree_map(
            jnp.asarray, unflatten_dict(dict(flat), sep="/")))
        step = jax_step(model, cfg)
        out = []
        for i, (x, y) in enumerate(batches):
            state, m = step(state, jnp.asarray(x), jnp.asarray(y),
                            jax.random.PRNGKey(i), None)
            out.append(float(m["loss"]))
        return out

    def port_losses(dtype):
        cfg = Config(**settings, compute_dtype=dtype, use_pallas_conv=True,
                     use_pallas_dec0=True)
        model = build_model(cfg, "cpu")
        model.load_state_dict(from_flax(flat))
        state = create_train_state(model, cfg)
        step = make_train_step(model, cfg)
        return [float(step(state, torch.from_numpy(x),
                           torch.from_numpy(y))["loss"])
                for x, y in batches]

    losses = {"jax fp32": jax_losses("float32"),
              "jax bf16": jax_losses("bfloat16"),
              "port bf16": port_losses("bfloat16"),
              "port fp32": port_losses("float32")}
    ref = np.asarray(losses["jax fp32"])
    for i in range(steps):
        print(f"step {i}: " + ", ".join(f"{k} {v[i]:.6g}"
                                        for k, v in losses.items()))
    worst = {k: float(np.max(np.abs(np.asarray(v) - ref) / np.abs(ref)))
             for k, v in losses.items() if k != "jax fp32"}
    record = {"steps": steps, "size": size, "batch": batch,
              "largest_relative_distance_from_jax_fp32": worst,
              "losses": losses}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=40)
    ap.add_argument("--batch", type=int, default=3)
    args = ap.parse_args()
    main(args.steps, args.size, args.batch)
