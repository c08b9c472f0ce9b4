"""The plain reference against the port at small sizes on the CPU, both in
float32: each family's forward, the sliding window, the train step and
the NIfTI ingest. These hold the reference to the program's semantics; on
the card the cells hold the program (bf16) to the reference."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from perfbench import families, harness, inputs, program
from perfbench.reference import ingest, models, train, window

SMALL = {"image_shape": [24, 24, 24], "patch_shape": [16, 16, 16],
         "n_base_filters": 4, "compute_dtype": "float32"}


def _cfg(config_name, **over):
    cell = harness.load_cell({"unet3d-fetal": "unet-window",
                              "isensee2017-fetal": "isensee-window"}
                             [config_name])
    return {**cell["config"], **SMALL, **over}


@pytest.mark.parametrize("name", ["unet3d-fetal", "isensee2017-fetal"])
def test_forward(name):
    cfg = _cfg(name)
    w = inputs.make_weights(cfg, 7, "cpu")
    model = program.model(program.config(cfg), w, "cpu")
    x = torch.randn((2, 1, 16, 16, 16), generator=inputs.generator(1, "cpu"))
    with torch.no_grad():
        got = model(x.permute(0, 2, 3, 4, 1), logits=True).permute(
            0, 4, 1, 2, 3)
        ref = models.forward(w, x, cfg)
    assert torch.allclose(got, ref, atol=1e-4, rtol=1e-4), (
        (got - ref).abs().max())


@pytest.mark.parametrize("name", ["unet3d-fetal", "isensee2017-fetal"])
def test_sliding_window(name):
    cfg = _cfg(name)
    w = inputs.make_weights(cfg, 8, "cpu")
    conf = program.config(cfg)
    pred = program.serving_predictor(program.model(conf, w, "cpu"), conf,
                                     {"overlap": 4, "patch_batch": 3})
    x, _ = inputs.ellipsoid_cases(1, cfg["image_shape"], 2, "cpu")
    vol = inputs.normalize(x)[0]
    got = pred.predict_probabilities(vol.numpy())
    with torch.no_grad():
        ref = window.probabilities(vol, lambda p: models.forward(w, p, cfg),
                                   cfg["patch_shape"], 4)
    assert torch.allclose(got.double(), ref, atol=1e-5), (
        (got.double() - ref).abs().max())
    labels = pred.predict_labels(vol.numpy())
    assert window.flip_margin(torch.from_numpy(labels), ref) <= 1e-5


def _train_both(cfg, batches, reference=None):
    """The program's steps and the reference's on ``batches`` from the
    same weights and draws: (program losses, model, weights, reference)."""
    w = inputs.make_weights(cfg, 9, "cpu")
    conf = program.config(cfg)
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)

    model = program.model(conf, w, "cpu")
    state = create_train_state(model, conf)
    step = make_train_step(model, conf, generator=inputs.generator(5, "cpu"))
    losses = [float(step(state, x, y)["loss"]) for x, y in batches]
    ref = (reference or train.run_steps)(w, batches, cfg,
                                         inputs.generator(5, "cpu"))
    return losses, model, w, ref


def _agree(losses, model, w, ref) -> bool:
    return np.allclose(losses, ref["losses"], rtol=1e-4, atol=1e-6) and all(
        torch.allclose(p.detach() - w[k], ref["params"][k] - w[k], atol=1e-6,
                       rtol=1e-3) for k, p in model.named_parameters())


def test_train_steps():
    cfg = _cfg("unet3d-fetal", batch_size=3)
    batches = [inputs.make_batch(s, 3, cfg["patch_shape"], "cpu")
               for s in range(3)]
    losses, model, w, ref = _train_both(cfg, batches)
    assert np.allclose(losses, ref["losses"], rtol=1e-4, atol=1e-6)
    for k, p in model.named_parameters():
        moved = ref["params"][k] - w[k]
        assert torch.allclose(p.detach() - w[k], moved, atol=1e-6,
                              rtol=1e-3), k


def _isensee_train():
    cfg = _cfg("isensee2017-fetal", batch_size=3)
    assert cfg["dropout_rate"] > 0 and cfg["augment"]
    return cfg, [inputs.make_batch(s, 3, cfg["patch_shape"], "cpu")
                 for s in range(3)]


def test_train_steps_with_dropout():
    """Isensee2017's steps, its SpatialDropout masks drawn by the
    reference right after the augmentation's draws, as the program draws
    them; its loss the weighted Dice."""
    cfg, batches = _isensee_train()
    assert _agree(*_train_both(cfg, batches))


def test_masks_drawn_before_augmentation_fail(monkeypatch):
    """A planted fault in the reference: the masks drawn before the
    augmentation. The comparison then fails."""
    cfg, batches = _isensee_train()
    fam = families.family(cfg)
    drawn = []
    augment, masks = train.augment, fam.dropout_masks

    def early(generator, x, y, *args):
        drawn.append(masks(generator, x.shape[0], cfg))
        return augment(generator, x, y, *args)

    monkeypatch.setattr(train, "augment", early)
    monkeypatch.setattr(fam, "dropout_masks", lambda *a: drawn.pop())
    assert not _agree(*_train_both(cfg, batches))


def test_symmetry_table():
    """The 48 keys are distinct symmetries, each a bijection of voxels."""
    probe = torch.arange(4 * 4 * 4).reshape(1, 4, 4, 4)
    seen = {tuple(train.symmetry(probe, k).reshape(-1).tolist())
            for k in train.KEYS}
    assert len(train.KEYS) == 48 and len(seen) == 48


def test_ingest(tmp_path):
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        preprocess_case)

    cfg = _cfg("unet3d-fetal")
    vol = inputs.croppable(np.random.default_rng(4), (30, 30, 20))
    path = os.path.join(tmp_path, "case.nii.gz")
    inputs.write_nifti(vol, path, np.diag([1.0, 1.0, 2.0, 1.0]))
    read, affine = ingest.read_nifti(path)
    assert np.array_equal(read, vol) and affine[2, 2] == 2.0
    got, _, _ = preprocess_case(path, program.config(cfg))
    ref = ingest.prepare(path, cfg["image_shape"], "cpu")
    assert got.shape == tuple(ref.shape)
    assert np.allclose(got, ref.numpy(), atol=2e-5)
