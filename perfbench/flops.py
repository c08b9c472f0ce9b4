"""The operations and bytes of each operation of a forward, from shapes
alone, so that a count stays the same whatever computes it. Each family
lists its operations (``families/<model_name>.py::ops``); this module
gives the arithmetic they share and the sums the metrics read.

- FLOPs are the least the operation needs: 2 per multiply-add. A 3^3
  conv whose input channels arrive up-sampled by nearest x2 (the decoders'
  up-sample, concatenate, conv) needs 2^3 distinct taps per output voxel
  for those channels, not 27. Strided and 1^3 convs are counted at their
  output resolution.
- Bytes: each input, weight and output read or written once, in the
  configuration's compute dtype.

``group`` names the program's modules whose device time a metric reads
against the operation: ``"conv"`` for the convs that run inside the
program's conv blocks (``models/layers.py::ConvBlock``); ``None`` for
those outside any (the 1^3 heads).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

from perfbench.families import family
from perfbench.peaks import bound_ms


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float
    group: Optional[str]

    @property
    def block(self) -> bool:
        """Inside a conv block."""
        return self.group == "conv"


Conv = Op

_ITEMSIZE = {"bfloat16": 2, "float32": 4, "float16": 2}


def itemsize(cfg: dict) -> int:
    return _ITEMSIZE[cfg.get("compute_dtype", "bfloat16")]


def voxels(patch, level: int) -> int:
    """Voxels of ``patch`` halved ``level`` times."""
    n = 1
    for s in patch:
        n *= s // 2 ** level
    return n


def conv_op(name: str, out_vox: int, cout: int, taps_in, in_vox, item: int,
            group: Optional[str] = "conv") -> Op:
    """A conv writing ``cout`` channels at ``out_vox`` voxels.
    ``taps_in``: [(channels, taps)]; ``in_vox``: the voxels each input
    channel group is read at."""
    flops = 2.0 * out_vox * cout * sum(c * t for c, t in taps_in)
    weights = cout * sum(c * t for c, t in taps_in)
    reads = sum(c * n for (c, _), n in zip(taps_in, in_vox))
    return Op(name, flops, float(item * (reads + weights + out_vox * cout)),
              group)


def convs(cfg: dict, patch, in_channels: int = 1) -> List[Op]:
    """Every operation of one forward of one patch of shape ``patch``."""
    return family(cfg).ops(cfg, patch, in_channels)


def forward_flops(cfg: dict, patch) -> float:
    return sum(c.flops for c in convs(cfg, patch))


def train_step_flops(cfg: dict, patch, batch: int) -> float:
    """A train step's least FLOPs: the forward, the input gradients and the
    weight gradients (3x the forward), less the input gradient of the
    first operation, which nothing needs."""
    cs = convs(cfg, patch)
    return batch * (3 * sum(c.flops for c in cs) - cs[0].flops)


def block_bound_ms(cfg: dict, patch) -> float:
    """The sum of ``bound_ms`` over the convs inside conv blocks."""
    return sum(bound_ms(c.flops, c.bytes)[0] for c in convs(cfg, patch)
               if c.block)


def group_bound_ms(cfg: dict, patch) -> Dict[str, float]:
    """Per ``group``, the sum of ``bound_ms`` over its operations (those
    outside any group left out)."""
    out: Dict[str, float] = {}
    for c in convs(cfg, patch):
        if c.group is not None:
            out[c.group] = out.get(c.group, 0.0) + bound_ms(c.flops,
                                                            c.bytes)[0]
    return out
