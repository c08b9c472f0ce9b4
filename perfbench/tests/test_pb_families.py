"""The family registry (``perfbench/families/``): the two families read as
before they moved there, and a family added as one file in a directory of
its own runs through the benchmark's weights, FLOP count and reference
without an edit to any other file.

``parent_constants.json`` holds what the code gave before it moved into
the families: per leaf the sum and the sum of squares of ``make_weights``
at the rehearsal's sizes (seed 7), the reference's logits on a fixed input
(sum, sum of squares, the first 8; Isensee2017 with and without dropout
masks), and the FLOP and bound counts at the configurations' own sizes."""

from __future__ import annotations

import json
import os
import textwrap

import pytest
import torch

from perfbench import families, flops, harness, inputs
from perfbench.reference import models
from perfbench.tests.conftest import ROOT
from perfbench.traffic import window

with open(os.path.join(ROOT, "perfbench", "tests",
                       "parent_constants.json")) as _f:
    PARENT = json.load(_f)
CELL_OF = {"unet3d-fetal": "unet-window", "isensee2017-fetal": "isensee-window"}


def _configs(name):
    cell = harness.load_cell(CELL_OF[name])
    return cell["config"], harness.rehearsed(cell)["config"]


def _summary(z):
    z = z.double()
    return [float(z.sum()), float((z ** 2).sum()), z.reshape(-1)[:8].tolist()]


def _close(got, want, rel=1e-9):
    assert got[0] == pytest.approx(want[0], rel=rel, abs=1e-9)
    assert got[1] == pytest.approx(want[1], rel=rel)
    assert got[2] == pytest.approx(want[2], rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("name", sorted(CELL_OF))
def test_weights_as_before(name):
    _, small = _configs(name)
    w = inputs.make_weights(small, 7, "cpu")
    want = PARENT["weights"][name]
    assert list(w) == list(want)
    for k, v in w.items():
        v = v.double()
        assert float(v.sum()) == pytest.approx(want[k][0], rel=1e-9,
                                               abs=1e-9), k
        assert float((v ** 2).sum()) == pytest.approx(want[k][1],
                                                      rel=1e-9), k


@pytest.mark.parametrize("name", sorted(CELL_OF))
def test_logits_as_before(name):
    full, small = _configs(name)
    w = inputs.make_weights(small, 7, "cpu")
    x = torch.randn((2, 1, 16, 16, 16), generator=inputs.generator(1, "cpu"))
    want = PARENT["logits"][name]
    with torch.no_grad():
        _close(_summary(models.forward(w, x, small)), want["plain"], 1e-6)
    if "dropout" in want:
        g = inputs.generator(3, "cpu")
        masks = [torch.rand((2, int(small["n_base_filters"]) * 2 ** level),
                            generator=g) < 0.7 for level in range(5)]
        with torch.no_grad():
            _close(_summary(models.forward(w, x, small, dropout_masks=masks)),
                   want["dropout"], 1e-6)


@pytest.mark.parametrize("name", sorted(CELL_OF))
def test_counts_as_before(name):
    full, _ = _configs(name)
    patch = full["patch_shape"]
    want = PARENT["counts"][name]
    assert flops.forward_flops(full, patch) == want["forward_flops"]
    assert flops.train_step_flops(full, patch, int(full["batch_size"])) == (
        want["train_step_flops"])
    assert flops.block_bound_ms(full, patch) == pytest.approx(
        want["block_bound_ms"], rel=1e-12)
    assert [[c.name, c.flops, c.bytes, c.block]
            for c in flops.convs(full, patch)] == want["convs"]
    # the conv group's bound is the conv blocks' bound
    assert flops.group_bound_ms(full, patch) == {
        "conv": pytest.approx(want["block_bound_ms"], rel=1e-12)}


def test_unknown_model_name_names_the_file():
    with pytest.raises(LookupError, match="no_such_family.py"):
        families.family({"model_name": "no_such_family"})
    with pytest.raises(LookupError, match="no_such_family.py"):
        inputs.make_weights({"model_name": "no_such_family"}, 1, "cpu")


TOY = '''
"""A toy family: one 1^3 conv head and a "mix" op of its own group."""
import math

import torch

from perfbench.flops import Op, conv_op, itemsize, voxels
from perfbench.reference.models import conv
from perfbench.reference.train import dice_loss


def param_spec(cfg, in_channels=1):
    return [("head.weight", (1, in_channels, 1, 1, 1)), ("head.bias", (1,))]


def init(name, shape, z):
    return 0.05 * z if len(shape) == 1 else z * math.sqrt(2.0 / shape[1])


def head_key(cfg):
    return "head.bias"


def forward(p, x, cfg, quant=None, dropout_masks=None):
    return conv(torch.tanh(x), p["head.weight"], p["head.bias"],
                quant=quant)


def ops(cfg, patch, in_channels=1):
    v = voxels(patch, 0)
    return [Op("mix", 1.0 * v, 4.0 * v, "mix"),
            conv_op("head", v, 1, [(in_channels, 1)], [v], itemsize(cfg),
                    None)]


def ranges():
    return {"Toy": "mix"}


def dropout_masks(generator, batch, cfg):
    return None


def loss(y, pred, cfg):
    return dice_loss(y, pred)
'''


@pytest.fixture
def toy_dir(tmp_path, monkeypatch):
    (tmp_path / "toy.py").write_text(textwrap.dedent(TOY))
    monkeypatch.setattr(families, "DIR", str(tmp_path))
    return tmp_path


def test_toy_family_added_as_a_file(toy_dir):
    cfg = {"model_name": "toy", "n_labels": 1, "n_base_filters": 4,
           "compute_dtype": "float32", "patch_shape": [8, 8, 8]}
    w = inputs.make_weights(cfg, 3, "cpu")
    assert sorted(w) == ["head.bias", "head.weight"]
    assert flops.forward_flops(cfg, [8, 8, 8]) == 512 + 2 * 512
    assert set(flops.group_bound_ms(cfg, [8, 8, 8])) == {"mix"}
    assert flops.block_bound_ms(cfg, [8, 8, 8]) == 0
    x, _ = inputs.ellipsoid_cases(1, (12, 12, 12), 2, "cpu")
    vol = inputs.normalize(x)[0]
    inputs.center_head(w, cfg, vol[None, :, 2:10, 2:10, 2:10])
    with torch.no_grad():
        from perfbench.reference import window as ref_window

        prob = ref_window.probabilities(
            vol, lambda v: models.forward(w, v, cfg), (8, 8, 8), 2)
    labels = (prob[0] > 0.5).to(torch.uint8)
    assert window.reference_margin(w, cfg, vol, labels, (8, 8, 8), 2,
                                   4) == 0.0
    flipped = labels.clone()
    flipped[:2] = 1 - flipped[:2]
    assert window.reference_margin(w, cfg, vol, flipped, (8, 8, 8), 2,
                                   4) > 0.0
