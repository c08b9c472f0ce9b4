"""The FLOP and byte counter (``perfbench/flops.py``), pinned to the
repository's own sizes."""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench import flops
from perfbench.tests.conftest import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)


def _nominal_unet(depth=4, nbf=32, p=64):
    """Every 3^3 conv at 27 taps on its whole (up-sampled) input."""
    total, cin = 0.0, 1
    for level in range(depth):
        v, f = (p // 2 ** level) ** 3, nbf * 2 ** level
        total += 2 * v * 27 * (cin * f + f * 2 * f)
        cin = 2 * f
    for level in range(depth - 2, -1, -1):
        v, skip = (p // 2 ** level) ** 3, 2 * nbf * 2 ** level
        total += 2 * v * 27 * ((cin + skip) * skip + skip * skip)
        cin = skip
    return total + 2 * p ** 3 * cin


def test_unet_patch_count():
    cfg = _cfg("unet3d-fetal")
    least = flops.forward_flops(cfg, [64, 64, 64])
    assert round(least / 1e9, 1) == 330.6
    assert round(_nominal_unet() / 1e9, 1) == 473.4
    # a 128^3 case is 27 patches
    assert round(27 * least / 1e12, 2) == 8.93
    # a train step of 6 patches: 3x the forward, less the stem's input grad
    stem = flops.convs(cfg, [64] * 3)[0].flops
    assert flops.train_step_flops(cfg, [64] * 3, 6) == 6 * (3 * least - stem)


@pytest.mark.parametrize("name", ["unet3d-fetal", "isensee2017-fetal"])
def test_bytes_and_blocks(name):
    cfg = _cfg(name)
    cs = flops.convs(cfg, [64, 64, 64])
    assert all(c.bytes > 0 and c.flops > 0 for c in cs)
    heads = [c.name for c in cs if not c.block]
    assert heads == (["head"] if name.startswith("unet")
                     else ["seg2", "seg1", "seg0"])
    # the least count never exceeds the nominal one, and the bound is
    # taken over the conv blocks only
    assert flops.block_bound_ms(cfg, [64] * 3) > 0


def test_counter_against_flop_counter_mode():
    """The port's plain route, counted by PyTorch at 32^3 x 8 (the same
    voxels as one 64^3 patch), lies within 1 % of the least count: its
    decoder computes the 8-tap form."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench import program
    from perfbench.inputs import make_weights

    cfg = dict(_cfg("unet3d-fetal"), compute_dtype="float32")
    conf = program.config(cfg)
    model = program.model(conf, make_weights(cfg, 0, "cpu"), "cpu")
    x = torch.zeros((8, 32, 32, 32, 1))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    counted = counter.get_total_flops()
    least = flops.forward_flops(cfg, [64, 64, 64])
    assert abs(counted - least) / least < 0.01, (counted, least)
