"""Inputs and weights made from a run's seed, the same for the program and
the reference.

- ``make_weights``: every parameter of the family's ``param_spec``
  (``perfbench/families/<model_name>.py``) from one normal draw of a
  generator on the device, each scaled by the family's ``init``: conv
  weights He-normal (std sqrt(2 / fan_in)), so activations keep their
  scale through the ReLU / LeakyReLU stacks; the 1^3 heads a tenth of
  that, so the logits lie within about +-1 of 0 whatever the seed and
  every case has voxels near the 0.5 threshold, where a label map shows a
  precision fault (at full He scale some seeds push a U-Net's logits to
  +5 and leave no voxel near it); biases N(0, 0.05^2); InstanceNorm
  scales 1 + N(0, 0.1^2) and biases N(0, 0.1^2). Float32, as the program
  keeps its parameters.
- ``ellipsoid_cases``: the synthetic case maker of
  ``fetal_mri_segmentation_tpu_torch/data/synthetic.py::
  make_ellipsoid_case`` (itself a copy of the JAX package's test helper),
  made on the device in one batch: a random ellipsoid as truth and a noisy
  bright copy of it as the image.
- ``make_batch``: ``bench.py::_make_batch`` of the repository's root (a
  thresholded-uniform truth and a noisy bright copy), on the device.
- ``croppable``: after ``fetal_mri_segmentation_tpu_torch/bench.py::
  _croppable`` (the root ``bench.py``'s scanner-like volume, foreground in
  a zero background, so the serving crop shrinks it), from a numpy
  generator, with an ellipsoid case as the foreground.
- ``write_nifti``: a NIfTI-1 writer (little-endian, sform, gzip level 1),
  after ``fetal_mri_segmentation_tpu_torch/utils/nifti.py::save_nifti``.
"""

from __future__ import annotations

import gzip
import math
import struct

import numpy as np
import torch

from perfbench.families import family
from perfbench.reference import models


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make_weights(cfg: dict, seed: int, device) -> dict:
    fam = family(cfg)
    spec = fam.param_spec(cfg)
    total = sum(math.prod(s) for _, s in spec)
    z = torch.randn(total, generator=generator(seed, device), device=device)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        out[name] = fam.init(name, shape, z[at:at + n].view(shape))
        at += n
    return out


def center_head(weights: dict, cfg: dict, x: torch.Tensor) -> None:
    """Shift the bias of the finest head so that the reference's median
    logit over ``x`` (B, C, d, h, w) is 0: every case then has voxels near
    the 0.5 threshold, where a label map shows a precision fault. Without
    it the logits of some seeds sit wholly on one side of 0 over a case's
    volume (background and foreground alike), and a label map shows no
    rounding at all."""
    with torch.no_grad():
        z = models.forward(weights, x.float(), cfg)
    key = family(cfg).head_key(cfg)
    weights[key] = weights[key] - z.median()


def ellipsoid_cases(n: int, shape, seed: int, device, noise: float = 0.3):
    """(x, truth): (n, 1) + shape float32 images and uint8 truths."""
    g = generator(seed, device)
    size = torch.tensor(shape, dtype=torch.float32, device=device)
    u = torch.rand((n, 6), generator=g, device=device)
    centre = size / 2 + (-3 + 6 * u[:, :3])
    radii = size * (0.2 + 0.15 * u[:, 3:])
    grids = [torch.arange(s, dtype=torch.float32, device=device)
             for s in shape]
    d = ((grids[0].view(1, -1, 1, 1) - centre[:, 0, None, None, None])
         / radii[:, 0, None, None, None]) ** 2
    d = d + ((grids[1].view(1, 1, -1, 1) - centre[:, 1, None, None, None])
             / radii[:, 1, None, None, None]) ** 2
    d = d + ((grids[2].view(1, 1, 1, -1) - centre[:, 2, None, None, None])
             / radii[:, 2, None, None, None]) ** 2
    truth = (d < 1).to(torch.uint8)
    x = truth * 2.0 + noise * torch.randn(truth.shape, generator=g,
                                          device=device)
    return x[:, None].float(), truth[:, None]


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-volume z-score of (N, C, D, H, W)."""
    dims = tuple(range(1, x.dim()))
    return (x - x.mean(dim=dims, keepdim=True)) / x.std(
        dim=dims, correction=0, keepdim=True)


def make_batch(seed: int, batch: int, patch, device):
    g = generator(seed, device)
    y = (torch.rand((batch, 1) + tuple(patch), generator=g, device=device)
         > 0.7).float()
    x = y * 2 + 0.3 * torch.randn(y.shape, generator=g, device=device)
    return x, y


def croppable(rng: np.random.Generator, raw_shape) -> np.ndarray:
    """``_croppable``'s layout (the box [0.17 n, 0.80 n) per axis in a
    zero background), the box holding an ellipsoid case at 100 + 50 x
    instead of N(200, 50) noise: noise gives a nearly uniform prediction,
    on some seeds far from the threshold everywhere."""
    vol = np.zeros(raw_shape, np.float32)
    box = tuple(slice(int(0.17 * n), int(0.80 * n)) for n in raw_shape)
    shape = np.array([s.stop - s.start for s in box])
    centre = shape / 2 + rng.uniform(-3, 3, 3)
    radii = shape * rng.uniform(0.2, 0.35, 3)
    grids = np.ogrid[:shape[0], :shape[1], :shape[2]]
    d = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, centre, radii))
    image = (d < 1) * 2.0 + rng.normal(0, 0.3, tuple(shape))
    vol[box] = 100 + 50 * image
    return vol


def write_nifti(data: np.ndarray, path: str, affine: np.ndarray) -> None:
    data = np.asarray(data, np.float32)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<hh", hdr, 70, 16, 32)  # float32
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1, 1, 1, 1)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3].reshape(-1))
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(payload)
