"""One rank of ``tests/test_torch_sharded_predict.py``'s two-rank run (gloo,
CPU).

    python tests/test_torch_sharded_predict_worker.py RANK WORLD PORT WORK_DIR

Reads the config and the weights the test wrote to ``WORK_DIR`` and runs,
on a data mesh of all ranks: the patch-grid sharded predictor at each
overlap of ``OVERLAPS`` (probabilities, the label map, the probability map
through ``predict_prob_async``); then ``run_validation_cases`` over the
test's dataset with the data mesh and with a 1 x WORLD spatial mesh, each
rank into ``WORK_DIR/<mesh>_rank<r>`` (rank 0 alone may write). Rank r
saves ``WORK_DIR/rank<r>.pt``. Imports nothing of JAX. It holds no test of
its own.
"""

import os
import sys

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
from fetal_mri_segmentation_tpu_torch.inference.predict import (
    run_validation_cases)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import make_mesh
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    initialize_distributed, make_sharded_predictor, rank_environment,
    shutdown_distributed)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_hybrid_mesh)

OVERLAPS = (4, 5)
VOLUME = (20, 20, 20)
PATCH_BATCH = 2


def volume(seed=5):
    return np.random.default_rng(seed).random((1,) + VOLUME).astype(
        np.float32)


def load(work):
    cfg = Config.load(os.path.join(work, "config.json"))
    model = build_model(cfg, "cpu")
    model.load_state_dict(torch.load(os.path.join(work, "weights.pt")))
    return cfg, model


def predict(cfg, model, mesh=None, tta=False):
    """Per overlap: probabilities, labels and the float16 probability map
    of the sliding window, sharded over ``mesh`` when one is given."""
    out = {}
    vol = volume()
    for overlap in OVERLAPS:
        pred = SlidingWindowPredictor(model, cfg, VOLUME, overlap=overlap,
                                      patch_batch_size=PATCH_BATCH,
                                      device="cpu", tta=tta)
        if mesh is not None:
            pred = make_sharded_predictor(pred, mesh)
        out[overlap] = dict(
            prob=pred(vol), labels=pred.predict_labels(vol),
            prob16=pred.unpack_prob(pred.predict_prob_async(vol, "float16")),
            batches=(list(pred.share) if mesh is not None
                     else list(range(pred.n_batches))))
    return out


def main(rank, world, port, work):
    torch.set_num_threads(1)
    os.environ.update(rank_environment(rank, world, port))
    initialize_distributed(device="cpu", timeout_s=120)
    try:
        cfg, model = load(work)
        mesh = make_mesh(world, device="cpu")
        spatial = make_hybrid_mesh(1, world, device="cpu")
        out = dict(sharded=predict(cfg, model, mesh),
                   flips=predict(cfg, model, mesh, tta="flips"))
        with open_data_file(cfg.data_file) as data_file:
            for tag, kw in (("mesh", dict(mesh=mesh)),
                            ("spatial", dict(spatial_mesh=spatial))):
                out[f"{tag} cases"] = run_validation_cases(
                    cfg.validation_file, model, data_file, cfg,
                    output_dir=os.path.join(work, f"{tag}_rank{rank}"),
                    overlap=4, device="cpu", **kw)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
