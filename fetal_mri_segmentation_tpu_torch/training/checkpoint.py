"""Best-only checkpointing and resume (port of
``fetal_mri_segmentation_tpu/training/checkpoint.py`` on ``torch.save``).

``model_file`` is one file holding the best-validation state: the model's
``state_dict`` (parameters and BatchNorm's running statistics), the
optimizer's (Adam moments, step counts, learning rate),
the step, the resume epoch, the best value and the epoch schedulers'
state, so a resumed run continues exactly. Beside it, ``<model_file>
.meta.json`` records the epoch and the run's data order ("lockstep": the
host pipeline's batch boundaries, which a full device cache shares; or
"partial" with the resident cases of a partial device cache), so the
generators can be fast-forwarded (:meth:`CheckpointIO.peek_epoch`) and the
cache's mode pinned (:meth:`CheckpointIO.peek_data_order`) before the state
is restored. Both are written to a temporary name and renamed.
The JAX package's orbax checkpoints are not read (orbax is absent where
the port runs): ``tools/export_params_npz.py`` writes their params,
``batch_stats`` and Adam moments as an ``.npz`` that ``train
--init-params`` and ``predict --params`` load.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from fetal_mri_segmentation_tpu_torch.utils.io_utils import atomic_json_dump
from fetal_mri_segmentation_tpu_torch.training.state import TrainState

# epoch-level scheduler state, persisted so a resumed run keeps its
# plateau / early-stop patience windows
_SCHED_KEYS = ("plateau_best", "plateau_wait", "early_best", "early_wait")


class CheckpointIO:
    """Best-only checkpointing into ``model_file`` (one file)."""

    def __init__(self, model_file: str):
        self.path = os.path.abspath(model_file)

    def exists(self) -> bool:
        return os.path.isfile(self.path)

    def peek_epoch(self) -> Optional[int]:
        """The checkpoint's resume epoch from the sidecar, without loading
        the state; None without a readable sidecar."""
        if not self.exists():
            return None
        try:
            with open(self.path + ".meta.json") as f:
                epoch = int(json.load(f)["epoch"])
        except (OSError, ValueError, KeyError, TypeError):
            return None
        # a negative epoch must not reach the generators' skip_batches
        return epoch if epoch >= 0 else None

    def peek_data_order(self) -> Optional[dict]:
        """The sidecar's recorded data-order mode, without loading the
        state: ``{"mode": "lockstep"}`` or ``{"mode": "partial",
        "resident": [case ids]}``. A resumed run's ``skip_batches``
        fast-forward lands on the interrupted run's batch sequence only if
        the cache mode is reproduced, so ``maybe_build_device_cache`` pins
        its decision to this record instead of reading the live free
        memory again. None without a readable record."""
        if not self.exists():
            return None
        try:
            with open(self.path + ".meta.json") as f:
                order = json.load(f).get("data_order")
        except (OSError, ValueError, AttributeError):
            return None
        return order if isinstance(order, dict) and "mode" in order else None

    def save(self, state: TrainState, *, epoch: int, best_val: float,
             sched: Optional[dict] = None,
             data_order: Optional[dict] = None) -> None:
        # without sched, seed the schedulers' bests with best_val and their
        # waits with 0 (an unbeatable best of 0.0 would drop the LR every
        # `patience` epochs)
        sched = sched or {"plateau_best": best_val, "plateau_wait": 0,
                          "early_best": best_val, "early_wait": 0}
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "epoch": int(epoch),
            "best_val": float(best_val),
            "sched": {k: float(sched.get(k, 0.0)) for k in _SCHED_KEYS},
        }
        tmp = f"{self.path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path)
        atomic_json_dump({"epoch": int(epoch), "best_val": float(best_val),
                          "data_order": data_order or {"mode": "lockstep"}},
                         self.path + ".meta.json")

    def restore(self, state: TrainState
                ) -> Tuple[TrainState, int, float, dict]:
        """Load the checkpoint into ``state``'s model and optimizer (in
        place, on their devices); returns ``(state, epoch, best_val,
        sched)``."""
        device = next(state.model.parameters()).device
        payload = torch.load(self.path, map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return (state, int(payload["epoch"]), float(payload["best_val"]),
                dict(payload["sched"]))
