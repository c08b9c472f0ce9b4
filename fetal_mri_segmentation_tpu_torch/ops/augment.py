"""On-device augmentation: flips, the 48 cube symmetries and contrast
(port of the flip / permute / contrast part of
``fetal_mri_segmentation_tpu/ops/augment.py``).

Each random transform is a draw (per example, on the generator's device,
from a ``torch.Generator``) and a deterministic apply that takes the drawn
parameters, so the applies can be held to the JAX functions with chosen
parameters. Flips and symmetries are one ``gather`` over the batch: output
spatial axis ``a`` of example ``b`` reads source axis ``axes[b, a]``,
reversed where ``rev[b, a]``, so every example takes its own draw with no
host round trip. Batches are channels-first ``(B, C, D, H, W)``.

``random_scale`` and ``random_rotation`` (``map_coordinates``) are not
ported yet (ROADMAP.md queue 1, item 7); ``training/train_step.py::
make_train_step`` refuses ``distort`` and ``rotate``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# The 48-element cube-symmetry group (copies of the JAX package's table and
# numpy oracle: its module imports jax)
# ---------------------------------------------------------------------------


def generate_permutation_keys() -> Tuple[tuple, ...]:
    """The 48 cube symmetries as ((rot_y, rot_z), flip_x, flip_y, flip_z,
    transpose) keys, sorted: index i is the same symmetry in both
    packages."""
    keys = set(itertools.product(
        itertools.combinations_with_replacement(range(2), 2),
        range(2), range(2), range(2), range(2)))
    return tuple(sorted(keys))


PERMUTATION_KEYS: Tuple[tuple, ...] = generate_permutation_keys()


def permute_data_np(data: np.ndarray, key: tuple) -> np.ndarray:
    """Numpy oracle for one cube symmetry on a (C, D, H, W) array: rot_y in
    the (D, W) plane, rot_z in the (H, W) plane, per-axis flips, then the
    transpose reverses the spatial axes."""
    (rot_y, rot_z), flip_x, flip_y, flip_z, transpose = key
    data = np.asarray(data)
    if rot_y != 0:
        data = np.rot90(data, rot_y, axes=(1, 3))
    if rot_z != 0:
        data = np.rot90(data, rot_z, axes=(2, 3))
    if flip_x:
        data = data[:, ::-1]
    if flip_y:
        data = data[:, :, ::-1]
    if flip_z:
        data = data[:, :, :, ::-1]
    if transpose:
        data = np.transpose(data, (0, 3, 2, 1))
    return np.ascontiguousarray(data)


def _inverse_key(key: tuple) -> tuple:
    probe = np.arange(2 * 4 * 4 * 4, dtype=np.int64).reshape(2, 4, 4, 4)
    forward = permute_data_np(probe, key)
    for cand in PERMUTATION_KEYS:
        if np.array_equal(permute_data_np(forward, cand), probe):
            return cand
    raise RuntimeError(f"no inverse for permutation key {key}")


INVERSE_KEY_INDEX: Tuple[int, ...] = tuple(
    PERMUTATION_KEYS.index(_inverse_key(k)) for k in PERMUTATION_KEYS)


def _key_axes(key: tuple):
    """(axes, rev) of one symmetry: output spatial axis a reads source axis
    axes[a], reversed where rev[a]. Read off the numpy oracle on a probe
    cube of coordinates."""
    n = 4
    probe = np.arange(n ** 3).reshape(1, n, n, n)
    src = np.stack(np.unravel_index(permute_data_np(probe, key)[0],
                                    (n, n, n)))         # (3, n, n, n)
    grid = np.indices((n, n, n))
    axes, rev = [None] * 3, [None] * 3
    for s in range(3):
        for a in range(3):
            for r in (False, True):
                if np.array_equal(src[s], n - 1 - grid[a] if r else grid[a]):
                    axes[a], rev[a] = s, r
    if None in axes:
        raise RuntimeError(f"key {key} is not an axis permutation with flips")
    return tuple(axes), tuple(rev)


_SYMMETRIES = tuple(_key_axes(k) for k in PERMUTATION_KEYS)


@functools.cache
def _symmetry_tables(device: torch.device):
    # kept per device; made outside inference mode, so a table first made
    # while serving is a normal tensor when training uses it
    with torch.inference_mode(False):
        axes = torch.tensor([a for a, _ in _SYMMETRIES], device=device)
        rev = torch.tensor([r for _, r in _SYMMETRIES], device=device)
        inverse = torch.tensor(INVERSE_KEY_INDEX, device=device)
    return axes, rev, inverse


def apply_symmetry(x: torch.Tensor, axes: torch.Tensor,
                   rev: torch.Tensor) -> torch.Tensor:
    """Per-example axis permutation with flips of x (B, C, D, H, W):
    ``axes``, ``rev`` (B, 3). A permutation other than the identity needs
    a cubic volume."""
    B, C = x.shape[:2]
    spatial = x.shape[2:]
    idx = torch.zeros((B, 1, 1, 1), dtype=torch.long, device=x.device)
    for a, n in enumerate(spatial):
        g = torch.arange(n, device=x.device).view(
            [1] + [n if i == a else 1 for i in range(3)])
        c = torch.where(rev[:, a].view(B, 1, 1, 1), n - 1 - g, g)
        # the source axis's stride, from scalars: a host-to-device copy of a
        # stride table would wait for the stream to drain
        src = axes[:, a].view(B, 1, 1, 1)
        stride = torch.where(src == 0, spatial[1] * spatial[2],
                             torch.where(src == 1, spatial[2], 1))
        idx = idx + c * stride
    out = x.reshape(B, C, -1).gather(2, idx.reshape(B, 1, -1).expand(
        B, C, -1))
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# Deterministic applies
# ---------------------------------------------------------------------------


def apply_flip(x: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Flip spatial axis a of example b where ``flips[b, a]`` (bool)."""
    axes = torch.arange(3, device=x.device).expand(x.shape[0], 3)
    return apply_symmetry(x, axes, flips)


def permute_batch(x: torch.Tensor, key_index: torch.Tensor) -> torch.Tensor:
    """Apply symmetry ``key_index[b]`` (an index into PERMUTATION_KEYS) to
    example b of a cubic batch."""
    axes, rev, _ = _symmetry_tables(x.device)
    key_index = key_index.to(x.device)
    return apply_symmetry(x, axes[key_index], rev[key_index])


def permute_data(data: torch.Tensor, key_index) -> torch.Tensor:
    """The key_index-th cube symmetry of one (C, D, H, W) example."""
    index = torch.as_tensor(key_index, device=data.device).reshape(1)
    return permute_batch(data[None], index)[0]


def reverse_permute_data(data: torch.Tensor, key_index) -> torch.Tensor:
    """The inverse symmetry (test-time augmentation averaging)."""
    _, _, inverse = _symmetry_tables(data.device)
    index = torch.as_tensor(key_index, device=data.device)
    return permute_data(data, inverse[index])


def permute_volume(x: torch.Tensor, key_index: int) -> torch.Tensor:
    """The key_index-th cube symmetry of the last three axes of x (any
    leading axes): :func:`permute_data` as a static axis permutation and
    flips, for test-time augmentation, where the symmetry is a host integer
    and an index tensor on the device would cost a host-to-device copy."""
    axes, rev = _SYMMETRIES[key_index]
    lead = x.dim() - 3
    y = x.permute(*range(lead), *(lead + a for a in axes))
    dims = [lead + a for a in range(3) if rev[a]]
    return y.flip(dims) if dims else y


def reverse_permute_volume(x: torch.Tensor, key_index: int) -> torch.Tensor:
    """The inverse of :func:`permute_volume` (TTA averaging)."""
    return permute_volume(x, INVERSE_KEY_INDEX[key_index])


def apply_contrast(x: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor) -> torch.Tensor:
    """``x * scale + shift * std(x)`` per example, ``scale`` and ``shift``
    (B,), with the population std over (C, D, H, W) as ``jnp.std`` takes
    it."""
    dims = tuple(range(1, x.ndim))
    view = (-1,) + (1,) * (x.ndim - 1)
    std = x.std(dim=dims, correction=0, keepdim=True)
    return x * scale.view(view) + shift.view(view) * std


# ---------------------------------------------------------------------------
# Draws (per example, on the generator's device)
# ---------------------------------------------------------------------------


def draw_flips(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(B, 3) bool, each True with p = 0.5."""
    return torch.rand((batch, 3), generator=generator,
                      device=generator.device) < 0.5


def draw_permutations(generator: torch.Generator,
                      batch: int) -> torch.Tensor:
    """(B,) indices, uniform over the 48 symmetries."""
    return torch.randint(0, len(PERMUTATION_KEYS), (batch,),
                         generator=generator, device=generator.device)


def draw_contrast(generator: torch.Generator, batch: int, factor: float):
    """(scale, shift), each (B,): U(1 - f, 1 + f) and U(-f, f)."""
    u = torch.rand((2, batch), generator=generator, device=generator.device)
    return 1.0 - factor + 2.0 * factor * u[0], -factor + 2.0 * factor * u[1]


# ---------------------------------------------------------------------------
# Random transforms of a batch, each example with its own draw
# ---------------------------------------------------------------------------


def random_flip(generator: torch.Generator, x: torch.Tensor,
                y: torch.Tensor):
    """Flip each spatial axis with p = 0.5, the same draw for x and y."""
    flips = draw_flips(generator, x.shape[0]).to(x.device)
    return apply_flip(x, flips), apply_flip(y, flips)


def _require_cubic(x: torch.Tensor) -> None:
    if len(set(x.shape[-3:])) != 1:
        raise ValueError(
            f"permutation augmentation requires cubic patches, got spatial "
            f"shape {tuple(x.shape[-3:])} (reference: augment.py::"
            "permute_data)")


def random_permutation_x_y(generator: torch.Generator, x: torch.Tensor,
                           y: torch.Tensor):
    """One random cube symmetry per example, the same for data and truth
    (cubic patches only)."""
    _require_cubic(x)
    index = draw_permutations(generator, x.shape[0])
    return permute_batch(x, index), permute_batch(y, index)


def random_contrast(generator: torch.Generator, x: torch.Tensor,
                    factor: float) -> torch.Tensor:
    """Random affine intensity remap per example."""
    scale, shift = draw_contrast(generator, x.shape[0], factor)
    return apply_contrast(x, scale.to(x.device), shift.to(x.device))


def augment_batch(generator: torch.Generator, x: torch.Tensor,
                  y: torch.Tensor, *, flip: bool = True,
                  permute: bool = True, contrast: Optional[float] = None):
    """Augment each example of a batch with its own draws, in the JAX
    package's order: flip, then permute, then contrast."""
    if flip:
        x, y = random_flip(generator, x, y)
    if permute:
        x, y = random_permutation_x_y(generator, x, y)
    if contrast:
        x = random_contrast(generator, x, contrast)
    return x, y


def augment_example(generator: torch.Generator, x: torch.Tensor,
                    y: torch.Tensor, *, flip: bool = True,
                    permute: bool = True, contrast: Optional[float] = None):
    """:func:`augment_batch` of one (C, D, H, W) example and its truth."""
    x, y = augment_batch(generator, x[None], y[None], flip=flip,
                         permute=permute, contrast=contrast)
    return x[0], y[0]
