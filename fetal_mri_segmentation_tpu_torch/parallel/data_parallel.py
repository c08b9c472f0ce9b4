"""Data-parallel training over a 1-D mesh of GPUs (port of
``fetal_mri_segmentation_tpu/parallel/data_parallel.py``).

The JAX package runs ONE process that owns every device: a ``Mesh`` with
the axis ``"data"``, the batch sharded over it, and ``shard_map`` inserting
the collectives. PyTorch's idiom is one PROCESS per device, joined by
``torch.distributed``. So here:

- :class:`DataMesh` is this process's view of the mesh: the process group,
  this rank, the world size and this rank's device;
- every rank draws the SAME global batch (identically seeded generators)
  and keeps rows ``[rank * b, (rank + 1) * b)`` of it (:func:`shard_batch`),
  which is what the JAX ``shard_batch`` hands shard ``rank``;
- the loss is the GLOBAL batch's (``ops/dice.py``: the partial sums are
  all-reduced), identical on every rank, and each rank's backward yields
  its share of that loss's gradient. The shares are SUMMED with one
  all-reduce of the flattened gradients between ``backward()`` and
  ``optimizer.step()`` (``parallel/collectives.py::sum_gradients``), chosen
  over ``DistributedDataParallel`` because DDP averages, which would divide
  the update by N, and a hand-written sum is exact and lets the optimizer's
  global-norm clip see the summed gradient on every rank;
- BatchNorm is sync BatchNorm (``models/layers.py::BatchNorm.group``): the
  moments are the global batch's, so N ranks train like one.

Per-rank augmentation: the caller seeds each rank's ``torch.Generator``
from (seed, epoch, rank) (``training/loop.py::epoch_seed``), so shards
augment differently and a fixed (seed, world size) repeats.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from fetal_mri_segmentation_tpu_torch.models.layers import BatchNorm
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    local_device)
from fetal_mri_segmentation_tpu_torch.training.train_step import (
    make_eval_step, make_train_step)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the 1-D data mesh."""

    group: Optional[object]  # torch.distributed process group; None alone
    rank: int
    size: int
    device: torch.device
    axis_names: Tuple[str, ...] = ("data",)


def make_mesh(num_devices: Optional[int] = None, *, device="cuda",
              share_devices: bool = False) -> DataMesh:
    """The data mesh over the ``num_devices`` ranks of the initialized
    process group (``parallel/distributed.py::initialize_distributed``);
    None: over all of them. One process alone is a mesh of one device with
    no group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices is not None and num_devices > world:
        # running on fewer devices than the user asked for must not pass
        raise ValueError(f"requested {num_devices} devices, have {world}")
    if num_devices is not None and num_devices < world:
        raise ValueError(
            f"requested {num_devices} devices of a process group of "
            f"{world}: the port runs one process per device, so start "
            f"{num_devices} processes")
    dev = local_device(device, share_devices)
    if not dist.is_initialized():
        return DataMesh(None, 0, 1, dev)
    return DataMesh(dist.group.WORLD, dist.get_rank(), world, dev)


def shard_batch(mesh: DataMesh, *arrays):
    """This rank's rows of each globally shaped array (numpy or torch):
    rows ``[rank * b, (rank + 1) * b)`` with ``b = B / size``."""
    n = mesh.size
    out = []
    for a in arrays:
        if a.shape[0] % n != 0:
            raise ValueError(
                f"global batch size {a.shape[0]} is not divisible by the "
                f"{n}-device data mesh — pick batch_size as a multiple of "
                f"the device count")
        b = a.shape[0] // n
        out.append(a[mesh.rank * b:(mesh.rank + 1) * b])
    return tuple(out) if len(out) > 1 else out[0]


def local_valid_count(mesh: DataMesh, n_valid: Optional[int],
                      local_b: int) -> int:
    """The real samples among this rank's ``local_b`` rows when the global
    batch holds ``n_valid`` (None: all of them)."""
    if n_valid is None:
        return local_b
    return min(max(int(n_valid) - mesh.rank * local_b, 0), local_b)


def replicate_state(mesh: DataMesh, state):
    """Every rank takes rank 0's parameters and buffers (the JAX
    ``replicate_state``); the optimizer's state is the same on every rank
    already, since each made or restored it from the same source."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in list(state.model.parameters()) + list(
                    state.model.buffers()):
                dist.broadcast(t, src=0, group=mesh.group)
    return state


def set_bn_group(model, group, whole_group=None) -> None:
    """Make every BatchNorm of ``model`` a sync BatchNorm over ``group``
    (the JAX steps rebuild the model with ``bn_axis_name``; a module owns
    its parameters, so the port sets the group in place). ``whole_group``:
    on a depth-sharded mesh, the group over which a level that every rank
    holds whole is summed (``models/layers.py::BatchNorm.whole_group``)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
            m.whole_group = whole_group


def make_dp_train_step(model, config, mesh: DataMesh, *,
                       generator: Optional[torch.Generator] = None,
                       sharded: bool = False,
                       debug_return_batch: bool = False) -> Callable:
    """``step(state, x, y, n_valid=None) -> metrics`` over the mesh; every
    rank calls it with the same global batch.

    x and y are globally shaped and the step keeps this rank's rows;
    ``sharded=True`` says they are this rank's rows already
    (:func:`shard_batch` ran before the upload). ``n_valid`` is the number
    of real samples in the GLOBAL batch either way. The metrics are the
    global batch's and identical on every rank. The model's BatchNorms
    become sync BatchNorms over the mesh's group."""
    set_bn_group(model, mesh.group)
    inner = make_train_step(model, config, generator=generator,
                            axis_name=mesh.group,
                            debug_return_batch=debug_return_batch)

    def step(state, x, y, n_valid=None):
        if not sharded:
            x, y = shard_batch(mesh, x, y)
        return inner(state, x, y,
                     local_valid_count(mesh, n_valid, x.shape[0]))

    return step


def make_dp_eval_step(model, config, mesh: DataMesh, *,
                      sharded: bool = False) -> Callable:
    """Mesh-parallel eval step; every rank returns the global metrics."""
    inner = make_eval_step(model, config)

    def step(state, x, y, n_valid=None):
        if not sharded:
            x, y = shard_batch(mesh, x, y)
        return inner(state, x, y,
                     local_valid_count(mesh, n_valid, x.shape[0]),
                     axis_name=mesh.group)

    return step
