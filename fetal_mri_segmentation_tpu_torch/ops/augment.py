"""On-device augmentation: scale, rotation, flips, the 48 cube symmetries
and contrast (port of ``fetal_mri_segmentation_tpu/ops/augment.py``).

Each random transform is a draw (per example, on the generator's device,
from a ``torch.Generator``) and a deterministic apply that takes the drawn
parameters, so the applies can be held to the JAX functions with chosen
parameters. Flips and symmetries are one ``gather`` over the batch: output
spatial axis ``a`` of example ``b`` reads source axis ``axes[b, a]``,
reversed where ``rev[b, a]``, so every example takes its own draw with no
host round trip. Batches are channels-first ``(B, C, D, H, W)``.

Scale and rotation resample each example at source coordinates in voxel
index space about the patch centre ``(s - 1) / 2``, as
``jax.scipy.ndimage.map_coordinates`` does with ``mode="constant",
cval=0``: the data trilinearly (floor, two weights per axis, eight reads),
the truth at the nearest voxel with halves rounded away from zero
(``lax.round``; ``torch.round`` rounds them to even, and with a centre of
31.5 the ties are real). The gather is written out in plain ops so that it
can be held exact: the coordinates are made of one rounding per operation
(no fused multiply-add), and the rotation matrix is made in float64 and
rounded once, so the CPU and the card resample at the same coordinates.
No kernel of the JAX package computes this, and none does here.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.utils.device import device_table

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


@device_table
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


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Nearest integer (int64), halves away from zero (``lax.round``).
    ``x - trunc(x)`` is exact, where ``|x| + 0.5`` could round up."""
    t = torch.trunc(x)
    away = (x - t).abs() >= 0.5
    return (t + torch.sign(x) * away).long()


def _read(flat: torch.Tensor, idx, spatial) -> torch.Tensor:
    """``flat`` (B, C, D*H*W) at the integer voxel ``idx`` = (iz, iy, ix),
    each (B, D, H, W) int64; zero where the voxel lies outside."""
    B, C = flat.shape[:2]
    valid, offset = None, 0
    for i, n in zip(idx, spatial):
        inside = (i >= 0) & (i < n)
        valid = inside if valid is None else valid & inside
        offset = offset * n + i.clamp(0, n - 1)
    out = flat.gather(2, offset.reshape(B, 1, -1).expand(B, C, -1))
    return torch.where(valid.reshape(B, 1, -1), out, torch.zeros_like(out))


def resample(vol: torch.Tensor, coords: torch.Tensor,
             order: int) -> torch.Tensor:
    """``vol`` (B, C, D, H, W) read at ``coords`` (B, 3, D, H, W), the
    source (z, y, x) voxel coordinate of every output voxel: order 1 is
    trilinear, order 0 the nearest voxel; outside the volume reads 0
    (``map_coordinates(mode="constant", cval=0)``)."""
    spatial = vol.shape[2:]
    flat = vol.reshape(vol.shape[0], vol.shape[1], -1)
    if order == 0:
        idx = [_round_half_away(coords[:, a]) for a in range(3)]
        return _read(flat, idx, spatial).reshape(vol.shape)
    lower = torch.floor(coords)
    upper_w = coords - lower
    lower_w = 1 - upper_w
    lower = lower.long()
    nodes = [((lower[:, a], lower_w[:, a]), (lower[:, a] + 1, upper_w[:, a]))
             for a in range(3)]
    out = None
    for (iz, wz), (iy, wy), (ix, wx) in itertools.product(*nodes):
        w = (wz * wy * wx).reshape(vol.shape[0], 1, -1)
        term = w * _read(flat, (iz, iy, ix), spatial)
        out = term if out is None else out + term
    return out.reshape(vol.shape)


def _centred_grid(spatial, device):
    """Per axis: the centre ``(s - 1) / 2`` and the voxel index minus the
    centre, broadcastable over (D, H, W)."""
    centres = [(s - 1) / 2.0 for s in spatial]
    offsets = [(torch.arange(s, dtype=torch.float32, device=device)
                - c).view([s if i == a else 1 for i in range(3)])
               for a, (s, c) in enumerate(zip(spatial, centres))]
    return centres, offsets


def apply_scale(x: torch.Tensor, y: torch.Tensor, factors: torch.Tensor):
    """Zoom example b by ``factors[b]`` (B, 3) per axis about the patch
    centre: output voxel g reads the source at ``c + (g - c) / f``. x comes
    back in float32 whatever came in, y in its own dtype."""
    B = x.shape[0]
    spatial = x.shape[2:]
    centres, offsets = _centred_grid(spatial, x.device)
    f = factors.to(device=x.device, dtype=torch.float32)
    coords = torch.stack([
        (c + o[None] / f[:, a].view(B, 1, 1, 1)).expand(B, *spatial)
        for a, (c, o) in enumerate(zip(centres, offsets))], dim=1)
    return resample(x.float(), coords, 1), resample(y, coords, 0)


def rotation_matrices(angles_rad: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) ``rz @ ry @ rx`` of the Euler angles (B, 3), made in
    float64 and rounded to float32 once."""
    a = angles_rad.double()
    ca, sa = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(ca[:, 0]), torch.zeros_like(ca[:, 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat([[one, zero, zero], [zero, ca[:, 0], -sa[:, 0]],
              [zero, sa[:, 0], ca[:, 0]]])
    ry = mat([[ca[:, 1], zero, sa[:, 1]], [zero, one, zero],
              [-sa[:, 1], zero, ca[:, 1]]])
    rz = mat([[ca[:, 2], -sa[:, 2], zero], [sa[:, 2], ca[:, 2], zero],
              [zero, zero, one]])
    return (rz @ ry @ rx).float()


def apply_rotation(x: torch.Tensor, y: torch.Tensor,
                   angles_rad: torch.Tensor):
    """Rotate example b by the Euler angles ``angles_rad[b]`` (B, 3,
    radians) about the patch centre: output voxel g reads the source at
    ``rot^T (g - c) + c`` with ``rot = rz @ ry @ rx`` (the output-to-input
    map is the inverse, the transpose). x comes back in float32."""
    B = x.shape[0]
    spatial = x.shape[2:]
    centres, offsets = _centred_grid(spatial, x.device)
    rot_t = rotation_matrices(angles_rad.to(x.device)).transpose(1, 2)
    coords = []
    for i in range(3):
        # one rounding per product and per sum, in a fixed order
        src = None
        for j in range(3):
            term = rot_t[:, i, j].view(B, 1, 1, 1) * offsets[j][None]
            src = term if src is None else src + term
        coords.append((src + centres[i]).expand(B, *spatial))
    coords = torch.stack(coords, dim=1)
    return resample(x.float(), coords, 1), resample(y, coords, 0)


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


def draw_scale_factors(generator: torch.Generator, batch: int,
                       scale_deviation: float) -> torch.Tensor:
    """(B, 3) zoom factors ``max(1 + dev * N(0, 1), 0.1)``: an unclamped
    draw can go <= 0, which would mirror or blank the volume."""
    z = torch.randn((batch, 3), generator=generator,
                    device=generator.device)
    return torch.clamp(1.0 + scale_deviation * z, min=0.1)


def draw_rotation_angles(generator: torch.Generator, batch: int,
                         max_angle_deg: float) -> torch.Tensor:
    """(B, 3) Euler angles in radians, U(-a, a) degrees per axis."""
    u = torch.rand((batch, 3), generator=generator, device=generator.device)
    return (-max_angle_deg + 2.0 * max_angle_deg * u) * (np.pi / 180.0)


# ---------------------------------------------------------------------------
# Random transforms of a batch, each example with its own draw
# ---------------------------------------------------------------------------


def random_scale(generator: torch.Generator, x: torch.Tensor,
                 y: torch.Tensor, scale_deviation: float):
    """Random anisotropic zoom about the patch centre, per example
    (trilinear for data, nearest for truth)."""
    return apply_scale(x, y, draw_scale_factors(generator, x.shape[0],
                                                scale_deviation))


def random_rotation(generator: torch.Generator, x: torch.Tensor,
                    y: torch.Tensor, max_angle_deg: float):
    """Random small 3-D rotation about the patch centre, per example."""
    return apply_rotation(x, y, draw_rotation_angles(generator, x.shape[0],
                                                     max_angle_deg))


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
                  permute: bool = True, contrast: Optional[float] = None,
                  scale_deviation: Optional[float] = None,
                  rotate: Optional[float] = None):
    """Augment each example of a batch with its own draws, in the JAX
    package's order: scale, rotate, flip, permute, then contrast."""
    if scale_deviation:
        x, y = random_scale(generator, x, y, scale_deviation)
    if rotate:
        x, y = random_rotation(generator, x, y, rotate)
    if flip:
        x, y = random_flip(generator, x, y)
    if permute:
        x, y = random_permutation_x_y(generator, x, y)
    if contrast:
        x = random_contrast(generator, x, contrast)
    return x, y


def augment_example(generator: torch.Generator, x: torch.Tensor,
                    y: torch.Tensor, *, flip: bool = True,
                    permute: bool = True, contrast: Optional[float] = None,
                    scale_deviation: Optional[float] = None,
                    rotate: Optional[float] = None):
    """:func:`augment_batch` of one (C, D, H, W) example and its truth."""
    x, y = augment_batch(generator, x[None], y[None], flip=flip,
                         permute=permute, contrast=contrast,
                         scale_deviation=scale_deviation, rotate=rotate)
    return x[0], y[0]
