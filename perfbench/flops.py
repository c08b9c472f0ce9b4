"""The operations and bytes of each convolution of a forward, from shapes
alone, so that a count stays the same whatever computes the conv.

- FLOPs are the least the operation needs: 2 per multiply-add. A 3^3
  conv whose input channels arrive up-sampled by nearest x2 (the decoders'
  up-sample, concatenate, conv) needs 2^3 distinct taps per output voxel
  for those channels, not 27. Strided and 1^3 convs are counted at their
  output resolution.
- Bytes: each input, weight and output read or written once, in the
  configuration's compute dtype.

``block`` marks the convs that run inside the program's conv blocks
(``models/layers.py::ConvBlock``), whose device time the conv metrics
read; the 1^3 heads run outside them.
"""

from __future__ import annotations

from typing import List, NamedTuple

from perfbench.peaks import bound_ms


class Conv(NamedTuple):
    name: str
    flops: float
    bytes: float
    block: bool


_ITEMSIZE = {"bfloat16": 2, "float32": 4, "float16": 2}


def convs(cfg: dict, patch, in_channels: int = 1) -> List[Conv]:
    """Every conv of one forward of one patch of shape ``patch``."""
    item = _ITEMSIZE[cfg.get("compute_dtype", "bfloat16")]
    nl, nbf = int(cfg["n_labels"]), int(cfg["n_base_filters"])
    depth = cfg.get("depth") or (5 if cfg["model_name"] == "isensee" else 4)
    out = []

    def vox(level):
        n = 1
        for s in patch:
            n *= s // 2 ** level
        return n

    def add(name, level, cout, taps_in, in_vox, block=True):
        """``taps_in``: [(channels, taps)]; ``in_vox``: the voxels each
        input channel group is read at."""
        v = vox(level)
        flops = 2.0 * v * cout * sum(c * t for c, t in taps_in)
        weights = cout * sum(c * t for c, t in taps_in)
        reads = sum(c * n for (c, _), n in zip(taps_in, in_vox))
        nbytes = float(item * (reads + weights + v * cout))
        out.append(Conv(name, flops, nbytes, block))

    if cfg["model_name"] == "unet":
        cin = in_channels
        for level in range(depth):
            f = nbf * 2 ** level
            add(f"enc{level}_conv1", level, f, [(cin, 27)], [vox(level)])
            add(f"enc{level}_conv2", level, 2 * f, [(f, 27)], [vox(level)])
            cin = 2 * f
        for level in range(depth - 2, -1, -1):
            skip = 2 * nbf * 2 ** level
            add(f"dec{level}_conv1", level, skip, [(cin, 8), (skip, 27)],
                [vox(level + 1), vox(level)])
            add(f"dec{level}_conv2", level, skip, [(skip, 27)], [vox(level)])
            cin = skip
        add("head", 0, nl, [(cin, 1)], [vox(0)], block=False)
        return out
    nseg = int(cfg.get("n_segmentation_levels", 3))
    filters = [nbf * 2 ** level for level in range(depth)]
    cin = in_channels
    for level, f in enumerate(filters):
        src = vox(level - 1) if level else vox(0)
        add(f"enc{level}_in", level, f, [(cin, 27)], [src])
        add(f"enc{level}_ctx1", level, f, [(f, 27)], [vox(level)])
        add(f"enc{level}_ctx2", level, f, [(f, 27)], [vox(level)])
        cin = f
    for level in range(depth - 2, -1, -1):
        f = filters[level]
        add(f"dec{level}_up", level, f, [(cin, 8)], [vox(level + 1)])
        add(f"dec{level}_loc1", level, f, [(2 * f, 27)], [vox(level)])
        add(f"dec{level}_loc2", level, f, [(f, 1)], [vox(level)])
        if level < nseg:
            add(f"seg{level}", level, nl, [(f, 1)], [vox(level)], block=False)
        cin = f
    return out


def forward_flops(cfg: dict, patch) -> float:
    return sum(c.flops for c in convs(cfg, patch))


def train_step_flops(cfg: dict, patch, batch: int) -> float:
    """A train step's least FLOPs: the forward, the input gradients and the
    weight gradients (3x the forward), less the input gradient of the
    first conv, which nothing needs."""
    cs = convs(cfg, patch)
    return batch * (3 * sum(c.flops for c in cs) - cs[0].flops)


def block_bound_ms(cfg: dict, patch) -> float:
    """The sum of ``bound_ms`` over the convs inside conv blocks."""
    return sum(bound_ms(c.flops, c.bytes)[0] for c in convs(cfg, patch)
               if c.block)
