"""Depth-axis spatial sharding and whole-volume prediction (port of
``fetal_mri_segmentation_tpu/parallel/spatial.py``).

The JAX package annotates a 2-D ``Mesh(("data", "spatial"))`` and lets
XLA's SPMD partitioner insert a halo exchange for every 3^3 conv along the
sharded depth axis and a global reduction for every norm and loss. PyTorch
has no partitioner and the port runs one process per device, so here:

- :class:`HybridMesh` (:func:`make_hybrid_mesh`) is this rank's view of the
  mesh: the whole mesh's process group, the group of its data row (the
  ranks that share a volume's depth, one slab each), the group of its
  spatial column, and its coordinates; ranks are laid out row-major, as
  the JAX ``reshape(n_data, n_spatial)`` lays out devices;
- :func:`shard_batch_spatial` keeps this rank's batch rows and depth slab;
- the model becomes a depth-sharded model (``models/layers.py::
  set_spatial_group``): every 3^3 conv exchanges halos with its neighbours
  (``parallel/collectives.py::halo_exchange``), every InstanceNorm sums its
  moments over the data row, BatchNorm over the whole mesh; the kernels run
  on the halo'd slabs, their launches per forward unchanged;
- :func:`make_gspmd_train_step` / :func:`make_gspmd_eval_step` take the
  GLOBAL batch on every rank and equal the single-device steps on it
  (``training/train_step.py``, ``partition``): the loss and metrics are the
  global batch's and the gradients are summed over the whole mesh;
- :class:`SpatialPredictor` runs one whole-volume forward, each rank on its
  slab, and gathers the probability slabs, so every rank returns the whole
  volume (the JAX ``out_shardings=repl``). Volume-level test-time
  augmentation ("flips": the 8 axis flips, any shape; "permute": the 48
  cube symmetries, cubic volumes only) transforms the whole volume before
  it is cut and after it is gathered, the members batched ``tta_chunk`` at
  a time. On one device (:func:`make_direct_predictor`) it is the direct
  predictor: no patch grid, no overlap recompute, no seams.

Volume dims must be divisible by 2^(depth-1), and the depth by the
spatial ranks, as in the JAX package. Where a rank's slab goes odd before
the last halving, the models gather that level whole on every rank and run
the coarser levels there, where XLA would reshard
(``models/layers.py::gather_level``). A space-to-depth folded level 0
(``ops/fold.py``) runs on the slabs too, its halo one folded row; a slab
too odd to fold on the depth axis is gathered whole before level 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    flip_member)
from fetal_mri_segmentation_tpu_torch.models.layers import (
    set_spatial_group)
from fetal_mri_segmentation_tpu_torch.ops.augment import (
    PERMUTATION_KEYS, permute_volume, reverse_permute_volume)
from fetal_mri_segmentation_tpu_torch.parallel.collectives import (
    all_gather_cat)
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
    set_bn_group)
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    local_device)
from fetal_mri_segmentation_tpu_torch.training.train_step import (
    make_eval_step, make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.packing import (
    device_label_map, host_label_map)
from fetal_mri_segmentation_tpu_torch.utils.residency import (
    normalize_tta_mode, stage_to_device, transfer_prob, unpack_prob_f32)


@dataclasses.dataclass(frozen=True)
class HybridMesh:
    """This process's place in the (data, spatial) mesh. ``group`` spans
    the whole mesh; ``spatial_group`` the ranks of this rank's data row,
    which share each sample's depth (None where ``n_spatial`` is 1);
    ``data_group`` the ranks of its spatial column, which hold the same
    slab of different samples (None where ``n_data`` is 1). All are None
    for a process alone."""

    group: Optional[object]
    data_group: Optional[object]
    spatial_group: Optional[object]
    rank: int
    n_data: int
    n_spatial: int
    device: torch.device
    axis_names: tuple = ("data", "spatial")

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial

    def row_range(self, batch: int) -> tuple:
        """``(first row, batch)``: where this rank's rows of a global batch
        of ``batch`` start, and the global batch."""
        return self.data_rank * (batch // self.n_data), batch

    def shard(self, *arrays):
        return shard_batch_spatial(self, *arrays)


def make_hybrid_mesh(n_data: int, n_spatial: int, *, device="cuda",
                     share_devices: bool = False) -> HybridMesh:
    """This rank's view of the ``n_data`` x ``n_spatial`` mesh over the
    ranks of the initialized process group (``parallel/distributed.py::
    initialize_distributed``), which must hold exactly that many. Every
    rank creates every subgroup, in the same order."""
    need = n_data * n_spatial
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    if world > need:
        raise ValueError(
            f"a {n_data} x {n_spatial} mesh of a process group of {world}: "
            f"the port runs one process per device, so start {need} "
            "processes")
    dev = local_device(device, share_devices)
    if not dist.is_initialized():
        return HybridMesh(None, None, None, 0, n_data, n_spatial, dev)
    rank = dist.get_rank()

    def subgroup(groups, n):
        """This rank's group among ``groups`` (rank lists covering the
        mesh), made on every rank; the world itself when there is one."""
        if n == 1:
            return None
        if len(groups) == 1:
            return dist.group.WORLD
        mine = None
        for ranks in groups:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    rows = [[d * n_spatial + s for s in range(n_spatial)]
            for d in range(n_data)]
    spatial = subgroup(rows, n_spatial)
    data = subgroup([list(col) for col in zip(*rows)], n_data)
    return HybridMesh(dist.group.WORLD, data, spatial, rank, n_data,
                      n_spatial, dev)


def shard_batch_spatial(mesh: HybridMesh, *arrays):
    """This rank's batch rows and depth slab of each globally shaped (B, C,
    D, H, W) array (numpy or torch): batch on "data", depth on "spatial"."""
    out = []
    for a in arrays:
        for dim, axis, n in ((0, "data", mesh.n_data),
                             (2, "spatial", mesh.n_spatial)):
            if a.shape[dim] % n != 0:
                raise ValueError(
                    f"array dim {dim} (size {a.shape[dim]}) not divisible "
                    f"by mesh axis {axis!r} ({n} shards)")
        b, d = a.shape[0] // mesh.n_data, a.shape[2] // mesh.n_spatial
        r, s = mesh.data_rank, mesh.spatial_rank
        out.append(a[r * b:(r + 1) * b, :, s * d:(s + 1) * d])
    return tuple(out) if len(out) > 1 else out[0]


def make_gspmd_train_step(model, config, mesh: HybridMesh, *,
                          generator: Optional[torch.Generator] = None
                          ) -> Callable:
    """``step(state, x, y, n_valid=None) -> metrics`` over the mesh; every
    rank calls it with the same GLOBAL (B, C, D, H, W) batch and a
    generator seeded alike. It augments and draws the dropout masks for the
    whole batch, keeps this rank's rows and slab, and equals the
    single-device step on the global batch: the loss and metrics are the
    global batch's on every rank, BatchNorm's moments the whole mesh's, the
    gradients summed over the mesh."""
    set_bn_group(model, mesh.group, whole_group=mesh.data_group)
    inner = make_train_step(model, config, generator=generator,
                            axis_name=mesh.group, partition=mesh)

    def gspmd_step(state, x, y, n_valid=None):
        # set at every call: a predictor on the same module sets its own
        set_spatial_group(model, mesh.spatial_group)
        return inner(state, x, y, n_valid)

    return gspmd_step


def make_gspmd_eval_step(model, config, mesh: HybridMesh) -> Callable:
    """``eval_step(state, x, y, n_valid=None) -> metrics`` of the global
    batch, on every rank."""
    inner = make_eval_step(model, config, partition=mesh)

    def gspmd_eval_step(state, x, y, n_valid=None):
        set_spatial_group(model, mesh.spatial_group)
        return inner(state, x, y, n_valid, axis_name=mesh.group)

    return gspmd_eval_step


class AsyncLabels:
    """Async label-map handle: the device label map bound to the volume
    shape it was dispatched for."""

    __slots__ = ("device_array", "shape")

    def __init__(self, device_array, shape):
        self.device_array = device_array
        self.shape = tuple(shape)


class SpatialPredictor:
    """Whole-volume predictor: one forward over the full volume (or one per
    chunk of TTA members), the depth axis split over the mesh's spatial
    ranks: each runs the forward on its slab, so a rank's activation memory
    drops by the spatial factor, and the probability slabs are gathered, so
    every rank returns the whole volume. The volume is staged whole on every
    rank (one channel of the input against every layer's activations) and
    cut on the device, after any TTA transform. ``mesh``: a
    :class:`HybridMesh` (its "spatial" axis) or a ``DataMesh`` (its one
    axis); None: one device. Duck-types ``SlidingWindowPredictor``'s
    serving surface: ``__call__``, ``predict_probabilities``,
    ``predict_labels``, ``predict_labels_async`` / ``unpack_labels`` and
    ``predict_prob_async`` / ``unpack_prob``."""

    def __init__(self, model, config, mesh=None, *, tta=False,
                 tta_chunk: Optional[int] = None, device=None):
        group, n = None, 1
        if mesh is not None:
            group, n = ((mesh.spatial_group, mesh.n_spatial)
                        if "spatial" in mesh.axis_names
                        else (mesh.group, mesh.size))
            if device is None:
                device = mesh.device
        self._group = group if n > 1 else None
        self._n_spatial = n
        self._slab = dist.get_rank(group) if self._group is not None else 0
        self.device = (resolve_device(device) if device is not None
                       else next(model.parameters()).device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.n_labels = config.n_labels
        self.tta_mode = normalize_tta_mode(tta)
        # defaults of the JAX predictor: permute in chunks of 8 of the 48
        # symmetries, flips in chunks of 2 of the 8 flips
        members = 8 if self.tta_mode == "flips" else 48
        if tta_chunk is None:
            tta_chunk = 8 if self.tta_mode == "permute" else 2
        if tta_chunk < 1 or members % tta_chunk:
            raise ValueError(f"tta_chunk={tta_chunk} must divide {members}")
        self.tta_chunk = tta_chunk

    # ------------------------------------------------------------------
    def _forward(self, xs: torch.Tensor) -> torch.Tensor:
        """(N, D, H, W, C) -> fp32 (N, D, H, W, L): on a spatial mesh this
        rank's slab through the model, then every rank's slab."""
        if self._group is None:
            return self.model(xs.contiguous()).float()
        d = xs.shape[1] // self._n_spatial
        y = self.model(xs[:, self._slab * d:(self._slab + 1) * d]
                       .contiguous()).float()
        return all_gather_cat(y, self._group, dim=1)

    def _probs(self, vol: torch.Tensor) -> torch.Tensor:
        """(C, D, H, W) device volume -> fp32 (L, D, H, W)."""
        x = vol.permute(1, 2, 3, 0)[None]                 # (1, D, H, W, C)
        if self.tta_mode is None:
            return self._forward(x)[0].permute(3, 0, 1, 2)
        if self.tta_mode == "flips":
            acc = None
            for start in range(0, 8, self.tta_chunk):
                members = range(start, start + self.tta_chunk)
                ys = self._forward(torch.cat([flip_member(x, i)
                                              for i in members]))
                for i, y in zip(members, ys):
                    y = flip_member(y[None], i)[0]
                    acc = y if acc is None else acc + y
            return (acc / 8).permute(3, 0, 1, 2)
        n = len(PERMUTATION_KEYS)
        acc = None
        for start in range(0, n, self.tta_chunk):
            members = range(start, start + self.tta_chunk)
            xs = torch.stack([permute_volume(vol, i) for i in members])
            ys = self._forward(xs.movedim(1, -1))         # (chunk, ..., L)
            for i, y in zip(members, ys):
                y = reverse_permute_volume(y.movedim(-1, 0), i)
                acc = y if acc is None else acc + y
        return acc / n

    # ------------------------------------------------------------------
    def _check_volume(self, full_shape):
        """A (C, D, H, W) volume with the config's channel count."""
        n_ch = self.config.nb_channels
        if len(full_shape) != 4 or full_shape[0] != n_ch:
            raise ValueError(
                f"expected a (C={n_ch}, D, H, W) volume "
                f"(training_modalities="
                f"{tuple(self.config.training_modalities)}); got shape "
                f"{tuple(full_shape)} — stack the case's modalities on "
                "axis 0 (as preprocess_case does)")
        self._check_shape(tuple(full_shape[1:]))

    def _check_shape(self, shape):
        """Fail loudly where the whole-volume forward cannot run: spatial
        dims must survive depth-1 halvings, the depth must split evenly over
        the mesh's spatial ranks, and 48-symmetry TTA needs a cube."""
        depth = getattr(self.config, "depth", None)
        if depth is None:
            raise ValueError(
                "config.depth is required for whole-volume inference — the "
                "divisibility guard needs the model's pooling depth")
        d_div = 2 ** (int(depth) - 1)
        for i, s in enumerate(shape):
            if s % d_div != 0:
                raise ValueError(
                    f"whole-volume inference needs every spatial dim "
                    f"divisible by 2^(depth-1)={d_div}; volume shape "
                    f"{tuple(shape)} dim {i} is {s}. Use the sliding-window "
                    f"predictor (patching) for this geometry.")
        if shape[0] % self._n_spatial != 0:
            raise ValueError(
                f"volume depth {shape[0]} not divisible by the mesh's "
                f"{self._n_spatial} spatial shards")
        if self.tta_mode == "permute" and len(set(shape)) != 1:
            raise ValueError(
                f"48-symmetry TTA (permute) on the whole-volume predictor "
                f"requires a CUBIC volume, got {tuple(shape)} — use "
                f"tta='flips' (the 8-way flip subgroup works for any shape)")

    def _stage(self, data_cdhw) -> torch.Tensor:
        self._check_volume(tuple(data_cdhw.shape))
        return stage_to_device(data_cdhw, self.model.dtype, self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_probabilities(self, data_cdhw) -> torch.Tensor:
        """(C, D, H, W) -> fp32 probabilities (L, D, H, W) on the device;
        enqueued without a synchronization. The module is put in eval
        mode, and given this predictor's spatial group, at every
        prediction: a train step on the same module leaves it in training
        mode and may have set another group."""
        self.model.eval()
        set_spatial_group(self.model, self._group)
        return self._probs(self._stage(data_cdhw))

    def __call__(self, data_cdhw) -> np.ndarray:
        """(C, D, H, W) -> probabilities (L, D, H, W), float32 on the host."""
        return self.predict_probabilities(data_cdhw).cpu().numpy()

    @torch.inference_mode()
    def predict_labels_async(self, data_cdhw,
                             threshold: float = 0.5) -> AsyncLabels:
        """Enqueue the label map without waiting; finish with
        :meth:`unpack_labels`."""
        prob = self.predict_probabilities(data_cdhw)
        return AsyncLabels(device_label_map(prob, threshold, self.n_labels,
                                            self.config.labels),
                           prob.shape[1:])

    def unpack_labels(self, out) -> np.ndarray:
        """An async result (an :class:`AsyncLabels` or a device label map)
        on the host."""
        if isinstance(out, AsyncLabels):
            out = out.device_array
        return host_label_map(out, self.n_labels, self.config.labels)

    def predict_labels(self, data_cdhw, threshold: float = 0.5) -> np.ndarray:
        return self.unpack_labels(
            self.predict_labels_async(data_cdhw, threshold))

    @torch.inference_mode()
    def predict_prob_async(self, data_cdhw,
                           transfer_dtype: str = "float32") -> torch.Tensor:
        """Enqueue the probability map in ``transfer_dtype`` (float32,
        float16, uint8 or uint16) without waiting; finish with
        :meth:`unpack_prob`."""
        return transfer_prob(self.predict_probabilities(data_cdhw),
                             transfer_dtype)

    def unpack_prob(self, out) -> np.ndarray:
        """An async probability map as float32 (L, D, H, W) on the host."""
        return unpack_prob_f32(out)


def make_direct_predictor(model, config, tta=False,
                          tta_chunk: Optional[int] = None,
                          device=None) -> SpatialPredictor:
    """The single-device direct whole-volume predictor (see
    :class:`SpatialPredictor`)."""
    return SpatialPredictor(model, config, tta=tta, tta_chunk=tta_chunk,
                            device=device)


def make_spatial_predictor(model, config, mesh, tta=False,
                           tta_chunk: Optional[int] = None,
                           device=None) -> SpatialPredictor:
    """See :class:`SpatialPredictor`."""
    return SpatialPredictor(model, config, mesh, tta=tta,
                            tta_chunk=tta_chunk, device=device)

