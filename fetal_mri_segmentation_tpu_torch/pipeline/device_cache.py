"""Device-resident case cache: patches are GATHERED on the device, not
uploaded (port of ``fetal_mri_segmentation_tpu/pipeline/device_cache.py``).

The host pipeline cuts every patch of a batch out of its case on the host
and uploads the batch each step. With the cache every training and
validation case is uploaded ONCE (data in the model's compute dtype, truth
as uint8, zero-padded by the exact worst-case grid margins), and a step's
input shrinks to one ``(B, 4)`` int32 tensor: the case row and the patch
corner of each sample. Patch extraction, label conversion and augmentation
run on the device inside the step.

Bit-parity with the host staging path (``training/loop.py``):

- data rides bf16 for bf16 models, rounded to nearest even as the host
  path's cast rounds it (and the model's first op is that cast); zero
  padding is exact in either dtype;
- truth rides uint8: binary and one-hot labels are integral by the
  generator's contract;
- the margins come from ``ops/patches.py::compute_patch_indices`` itself
  (the centered grid's negative corners and the training grid's random
  negative start offset), so the gather reproduces
  ``get_patch_from_3d_data``'s zero-padded out-of-bounds reads with no
  masking;
- the index stream consumes the SAME numpy rng sequence as
  ``pipeline/generator.py::data_generator`` (same epoch grids, shuffle,
  blank skip and partial-batch boundaries), so for a given seed the cached
  step trains on the same batches in the same order.

The gather is plain tensor indexing (the JAX one is ``lax.dynamic_slice``
under ``vmap``, not a Pallas kernel): one index tensor built on the device
from the corners, so the step never reads an index back to the host.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.ops.patches import (
    compute_patch_indices, get_patch_from_3d_data)
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
    BatchSkipper, CaseCache, TruthCache, convert_data,
    create_patch_index_list)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load


# ---------------------------------------------------------------------------
# Exact worst-case grid margins
# ---------------------------------------------------------------------------

def plan_margins(image_shape: Sequence[int], patch_shape: Sequence[int],
                 validation_patch_overlap: int = 0,
                 training_patch_start_offset: Optional[Sequence[int]] = None
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-axis zero-pad margins covering EVERY corner either generator can
    emit: the centered validation grid (negative-start overflow) and all
    training grids (random start offset in [-offset, 0], inclusive).

    Returns ``(margin_lo, margin_hi)`` such that for any emitted corner c:
    ``0 <= c + margin_lo`` and ``c + patch <= shape + margin_hi``. The
    corners come from ``compute_patch_indices``, the function the
    generators call. The grids are separable, so enumerating scalar offsets
    0..max (each axis clamped to its own maximum) covers every per-axis
    combination."""
    image_shape = tuple(int(v) for v in image_shape)
    patch_shape = tuple(int(v) for v in patch_shape)
    grids = [compute_patch_indices(image_shape, patch_shape,
                                   validation_patch_overlap)]
    if training_patch_start_offset is not None:
        max_off = [int(v) for v in training_patch_start_offset]
        for off in range(max(max_off) + 1):
            start = tuple(-min(off, m) for m in max_off)
            grids.append(compute_patch_indices(image_shape, patch_shape, 0,
                                               start=start))
    else:
        grids.append(compute_patch_indices(image_shape, patch_shape, 0))
    corners = np.concatenate(grids, axis=0)
    min_corner = np.minimum(corners.min(axis=0), 0)
    max_end = np.maximum(corners.max(axis=0) + np.asarray(patch_shape),
                         image_shape)
    lo = tuple(int(-c) for c in min_corner)
    hi = tuple(int(e - s) for e, s in zip(max_end, image_shape))
    return lo, hi


# ---------------------------------------------------------------------------
# The cache itself
# ---------------------------------------------------------------------------

class DeviceCaseCache:
    """Zero-padded stacks, on the device, of every case the run touches.

    ``data_stack``: (n_cases, n_channels, D+lo+hi, ...) in ``dtype``;
    ``truth_stack``: (n_cases, 1, same spatial) uint8;
    ``row_of``: the dataset's case index -> stack row.
    """

    def __init__(self, data_stack, truth_stack, row_of, margin_lo,
                 patch_shape):
        self.data_stack = data_stack
        self.truth_stack = truth_stack
        self.row_of = dict(row_of)
        self.margin_lo = tuple(int(m) for m in margin_lo)
        self.patch_shape = tuple(int(p) for p in patch_shape)
        self.host_truth = None  # optional {case_idx: uint8 array}, see build
        self.partial = False    # True when only a subset is resident
        self.n_total_cases = len(self.row_of)
        self.resident_cases = sorted(self.row_of)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.data_stack, self.truth_stack))

    @classmethod
    def build(cls, data_file, case_indices: Sequence[int], *,
              patch_shape: Sequence[int],
              margin_lo: Sequence[int], margin_hi: Sequence[int],
              dtype=None, device=None,
              keep_host_truth: bool = False) -> "DeviceCaseCache":
        """Read the cases from ``data_file`` (``.root.data`` /
        ``.root.truth``), pad them and put both stacks on ``device`` (the
        card by default). For a CUDA device the padded stacks are built in
        pinned host memory and uploaded once each, so the card never holds
        a second copy. ``keep_host_truth`` retains the unpadded uint8 truth
        volumes in ``self.host_truth`` so the blank-skip generators share
        them instead of reading the dataset again."""
        dtype = dtype or torch.bfloat16
        device = resolve_device("cuda" if device is None else device)
        pin = device.type == "cuda"
        case_indices = [int(i) for i in case_indices]
        c = int(data_file.root.data.shape[1])
        spatial = tuple(int(s) for s in data_file.root.data.shape[-3:])
        padded = tuple(s + lo + hi for s, lo, hi
                       in zip(spatial, margin_lo, margin_hi))
        n = len(case_indices)
        data = torch.zeros((n, c) + padded, dtype=dtype, pin_memory=pin)
        truth = torch.zeros((n, 1) + padded, dtype=torch.uint8,
                            pin_memory=pin)
        host_truth = {}
        sl = tuple(slice(lo, lo + s) for lo, s in zip(margin_lo, spatial))
        for row, idx in enumerate(case_indices):
            data[(row, slice(None)) + sl] = torch.from_numpy(np.array(
                data_file.root.data[idx], dtype=np.float32)).to(dtype)
            t = np.asarray(data_file.root.truth[idx])
            t8 = t.astype(np.uint8)
            if not np.array_equal(t, t8):
                raise ValueError(
                    f"case {idx}: truth values are not integral uint8 "
                    "(reference truth_dtype contract) — device case cache "
                    "cannot represent them; use the host pipeline")
            t8 = t8.reshape((1,) + spatial)
            truth[(row, slice(None)) + sl] = torch.from_numpy(t8)
            if keep_host_truth:
                host_truth[idx] = t8
        out = cls(data.to(device), truth.to(device),
                  {idx: row for row, idx in enumerate(case_indices)},
                  margin_lo, patch_shape)
        out.host_truth = host_truth if keep_host_truth else None
        return out


def estimate_cache_bytes(data_file, n_cases: int, margin_lo, margin_hi,
                         dtype_bytes: int = 2) -> int:
    c = int(data_file.root.data.shape[1])
    spatial = tuple(int(s) for s in data_file.root.data.shape[-3:])
    padded_voxels = int(np.prod([s + lo + hi for s, lo, hi
                                 in zip(spatial, margin_lo, margin_hi)]))
    return n_cases * padded_voxels * (c * dtype_bytes + 1)


# ---------------------------------------------------------------------------
# Device-side patch gather + label conversion
# ---------------------------------------------------------------------------

def make_gather(patch_shape: Sequence[int], margin_lo: Sequence[int]):
    """(stack, rows[B], corners[B,3]) -> (B, C, *patch_shape) patches.

    ``rows`` and ``corners`` are integer tensors on the stack's device.
    One advanced index over the flattened volumes, built on the device
    from the corners (no value is read back to the host); the margins make
    every read in-bounds, reproducing the host path's zero-padded
    out-of-bounds reads."""
    patch = tuple(int(p) for p in patch_shape)
    m = tuple(int(v) for v in margin_lo)
    aranges = {}

    def gather(stack, rows, corners):
        dev = stack.device
        if dev not in aranges:
            aranges[dev] = [torch.arange(p, device=dev) for p in patch]
        a0, a1, a2 = aranges[dev]
        c = stack.shape[1]
        _, s1, s2 = stack.shape[2:]
        rows = rows.to(torch.int64)
        corners = corners.to(torch.int64)
        i0 = (corners[:, 0:1] + (m[0] + a0))[:, :, None, None]
        i1 = (corners[:, 1:2] + (m[1] + a1))[:, None, :, None]
        i2 = (corners[:, 2:3] + (m[2] + a2))[:, None, None, :]
        voxel = ((i0 * s1 + i1) * s2 + i2).reshape(rows.shape[0], 1, -1)
        channel = torch.arange(c, device=dev)[None, :, None]
        out = stack.reshape(stack.shape[0], c, -1)[
            rows[:, None, None], channel, voxel]
        return out.reshape((rows.shape[0], c) + patch)

    return gather


def convert_labels_device(truth, n_labels: int,
                          labels: Optional[Sequence[int]] = None):
    """(B, 1, *patch) integer truth -> float32 binary / one-hot target.

    Device twin of ``generator.py::convert_data`` and
    ``get_multi_class_labels``; exact, since labels are integral."""
    if n_labels == 1:
        return (truth > 0).float()
    labs = (tuple(labels) if labels is not None
            else tuple(range(1, n_labels + 1)))
    return torch.cat([(truth == lab).float() for lab in labs], dim=1)


# ---------------------------------------------------------------------------
# Cached train / eval steps
# ---------------------------------------------------------------------------

def _make_gather_convert(config, margin_lo):
    """(stacks, rows, corners, n_valid) -> (x, y) exactly as the host
    staging path would deliver them: gathered patches with the padded batch
    slots ZEROED (the host path zero-pads before the upload, and that
    matters beyond the masked loss: BatchNorm's batch statistics see the
    padding)."""
    gather = make_gather(config.patch_shape, margin_lo)
    n_labels, labels = config.n_labels, config.labels

    def gather_convert(data_stack, truth_stack, rows, corners, n_valid):
        x = gather(data_stack, rows, corners)
        y = convert_labels_device(gather(truth_stack, rows, corners),
                                  n_labels, labels)
        if n_valid is not None:
            keep = (torch.arange(x.shape[0], device=x.device)
                    < n_valid).reshape((-1,) + (1,) * (x.ndim - 1))
            x = torch.where(keep, x, 0)
            y = torch.where(keep, y, 0)
        return x, y

    return gather_convert


def make_cached_train_step(model, config, margin_lo, *,
                           generator: Optional[torch.Generator] = None):
    """``step(state, data_stack, truth_stack, rows, corners, n_valid=None)
    -> metrics``: the train step (``training/train_step.py``) behind the
    patch gather and the label conversion, all on the device. Nothing in
    it reads a value back to the host."""
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)

    base = make_train_step(model, config, generator=generator)
    gather_convert = _make_gather_convert(config, margin_lo)

    def step(state, data_stack, truth_stack, rows, corners, n_valid=None):
        x, y = gather_convert(data_stack, truth_stack, rows, corners, n_valid)
        return base(state, x, y, n_valid)

    return step


def make_cached_eval_step(model, config, margin_lo):
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_eval_step)

    base = make_eval_step(model, config)
    gather_convert = _make_gather_convert(config, margin_lo)

    def step(state, data_stack, truth_stack, rows, corners, n_valid=None):
        x, y = gather_convert(data_stack, truth_stack, rows, corners, n_valid)
        return base(state, x, y, n_valid)

    return step


def make_cached_dp_train_step(model, config, mesh, margin_lo, *,
                              generator: Optional[torch.Generator] = None):
    """Data-parallel cached step: every rank holds the whole stacks and
    gathers only its own rows of the global index batch. Twin of
    ``parallel/data_parallel.py::make_dp_train_step`` (same local-valid
    math, same per-rank generator, sync BatchNorm)."""
    from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
        local_valid_count, make_dp_train_step, shard_batch)

    inner = make_dp_train_step(model, config, mesh, generator=generator,
                               sharded=True)
    gather_convert = _make_gather_convert(config, margin_lo)

    def step(state, data_stack, truth_stack, rows, corners, n_valid=None):
        rows, corners = shard_batch(mesh, rows, corners)
        x, y = gather_convert(
            data_stack, truth_stack, rows, corners,
            local_valid_count(mesh, n_valid, rows.shape[0]))
        return inner(state, x, y, n_valid)

    return step


def make_cached_dp_eval_step(model, config, mesh, margin_lo):
    from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
        local_valid_count, make_dp_eval_step, shard_batch)

    inner = make_dp_eval_step(model, config, mesh, sharded=True)
    gather_convert = _make_gather_convert(config, margin_lo)

    def step(state, data_stack, truth_stack, rows, corners, n_valid=None):
        rows, corners = shard_batch(mesh, rows, corners)
        x, y = gather_convert(
            data_stack, truth_stack, rows, corners,
            local_valid_count(mesh, n_valid, rows.shape[0]))
        return inner(state, x, y, n_valid)

    return step


# ---------------------------------------------------------------------------
# Host index stream (rng-parity twin of generator.py::data_generator)
# ---------------------------------------------------------------------------

class _DictTruth:
    """Truth lookup over the host copies retained by ``DeviceCaseCache.build``
    (shared by the train and validation generators: the dataset is not read
    again)."""

    def __init__(self, host_truth):
        self._d = host_truth

    def get(self, index: int) -> np.ndarray:
        return self._d[index]


def _index_batch(pairs, row_of, batch_size):
    """(rows, corners, n_valid) of one batch of (case, corner) pairs, padded
    to ``batch_size`` by repeating the first entry."""
    n_valid = len(pairs)
    while len(pairs) < batch_size:
        pairs.append(pairs[0])
    rows = np.asarray([row_of[c] for c, _ in pairs], dtype=np.int32)
    corners = np.asarray([corner for _, corner in pairs],
                         dtype=np.int32).reshape(batch_size, 3)
    return rows, corners, n_valid


def index_batch_generator(data_file, index_list, row_of, batch_size: int = 1,
                          patch_shape=None, patch_overlap: int = 0,
                          patch_start_offset=None,
                          shuffle_index_list: bool = True,
                          skip_blank: bool = True,
                          seed: Optional[int] = None,
                          cache_cases: int = 64,
                          truth_cache=None,
                          skip_batches: int = 0
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Infinite generator of ``(rows[B] int32, corners[B,3] int32, n_valid)``.

    Mirrors ``generator.py::data_generator`` line for line: the same rng
    construction and consumption order (per-epoch ``default_rng((seed,
    k))``, the batch-level ``skip_batches`` fast-forward of data-order
    exact resume, epoch grid offsets, shuffle), the same blank-skip
    decisions (truth sliced on the host from an LRU) and the same
    partial-batch boundaries, so the cached pipeline trains on the exact
    sequence the host pipeline would. Partial batches are padded by
    repeating the first entry; ``n_valid`` masks the padding in the step.

    ``truth_cache``: optional shared ``.get(case_idx) -> truth array``
    lookup (``DeviceCaseCache.host_truth`` wrapped), so several generators
    do not read the truth again that the build already loaded."""
    if patch_shape is None:
        raise ValueError("device case cache requires patch_shape training")
    skipper = BatchSkipper(skip_batches)
    cache = truth_cache or TruthCache(data_file, max_cases=cache_cases)
    base_list = list(index_list)
    image_shape = tuple(data_file.root.data.shape[-3:])
    epoch = 0

    while True:
        rng = np.random.default_rng(
            None if seed is None else (seed, epoch))
        epoch += 1
        pairs: List[Tuple[int, np.ndarray]] = []
        skipper.reset_epoch()
        epoch_list = create_patch_index_list(
            base_list, image_shape, patch_shape, patch_overlap,
            patch_start_offset, rng)
        if shuffle_index_list:
            rng.shuffle(epoch_list)
        yielded = False
        while epoch_list:
            if skipper and not skip_blank:
                if skipper.arith_skip_epoch(epoch_list, batch_size):
                    yielded = True
                    break
                continue
            case_index, corner = epoch_list.pop()
            kept = True
            if skip_blank:
                truth = cache.get(case_index)
                y = get_patch_from_3d_data(truth, patch_shape, corner)
                kept = bool(np.any(y))
            if skipper:
                # fast-forward: same batch boundaries, nothing emitted
                if skipper.note_patch(kept, batch_size, not epoch_list):
                    yielded = True
                continue
            if kept:
                pairs.append((case_index, corner))
            # emit check after EVERY pop (the trailing-partial semantics of
            # generator.py::data_generator: must stay in lockstep)
            if pairs and (len(pairs) == batch_size or not epoch_list):
                yield _index_batch(pairs, row_of, batch_size)
                yielded = True
                pairs = []
        if not yielded:
            raise RuntimeError(
                "index_batch_generator produced no batches for an entire "
                f"epoch (skip_blank={skip_blank}, {len(base_list)} cases) — "
                "truth volumes appear to be empty")


def partial_index_batch_generator(data_file, index_list, row_of,
                                  batch_size: int = 1,
                                  patch_shape=None, patch_overlap: int = 0,
                                  patch_start_offset=None,
                                  shuffle_index_list: bool = True,
                                  skip_blank: bool = True,
                                  seed: Optional[int] = None,
                                  cache_cases: int = 64,
                                  truth_cache=None,
                                  skip_batches: int = 0,
                                  n_labels: int = 1, labels=None
                                  ) -> Iterator[tuple]:
    """Tagged twin of :func:`index_batch_generator` for a PARTIALLY
    resident cache.

    Emits either ``("idx", rows, corners, n_valid)`` (every case of the
    batch resident) or ``("host", x, y, n_valid)`` (host-gathered float32
    patches and converted labels, what the host staging path would
    upload). Each epoch derives the SAME rng stream as the host and full
    generators (same grids, shuffle and blank-skip decisions), then routes
    each kept patch by residency and fills the two batch kinds
    independently: the epoch's PATCH MULTISET is the host pipeline's while
    the batch grouping differs (resident and non-resident patches share a
    batch only in the merged trailing flush below). Trailing partials flush
    at the epoch's end (idx batches padded by repeating the first row, host
    batches by the loop's ``pad_batch``, both masked by ``n_valid``); when
    both kinds have remainders that fit one batch they merge into a single
    host batch, so the emissions per epoch equal the host generator's
    ``ceil(kept / batch_size)``, which is what the loop consumes.

    ``skip_batches`` replays the whole routing and suppresses the first N
    emissions (exact resume, as the full-cache generator gives; slower per
    skipped batch because it reads truth for the blank checks)."""
    if patch_shape is None:
        raise ValueError("device case cache requires patch_shape training")
    tcache = truth_cache or TruthCache(data_file, max_cases=64)
    dcache = CaseCache(data_file, max_cases=cache_cases)
    base_list = list(index_list)
    image_shape = tuple(data_file.root.data.shape[-3:])
    epoch = 0
    to_skip = int(skip_batches)

    def emit_idx(pairs):
        return ("idx",) + _index_batch(pairs, row_of, batch_size)

    def emit_host(pairs):
        xs, ys = [], []
        for case_index, corner in pairs:
            data, truth = dcache.get(case_index)
            xs.append(get_patch_from_3d_data(data, patch_shape, corner))
            ys.append(get_patch_from_3d_data(truth, patch_shape, corner))
        x, y = convert_data(xs, ys, n_labels=n_labels, labels=labels)
        return "host", x, y, len(pairs)

    while True:
        rng = np.random.default_rng(
            None if seed is None else (seed, epoch))
        epoch += 1
        epoch_list = create_patch_index_list(
            base_list, image_shape, patch_shape, patch_overlap,
            patch_start_offset, rng)
        if shuffle_index_list:
            rng.shuffle(epoch_list)
        res: List[Tuple[int, np.ndarray]] = []
        mis: List[Tuple[int, np.ndarray]] = []
        yielded = False

        def boundary(pairs, emit):
            """One batch boundary: skip (fast-forward) or build + emit."""
            nonlocal to_skip, yielded
            yielded = True
            if to_skip > 0:
                to_skip -= 1
                return None
            return emit(list(pairs))

        while epoch_list:
            case_index, corner = epoch_list.pop()
            if skip_blank:
                truth = tcache.get(case_index)
                if not np.any(get_patch_from_3d_data(truth, patch_shape,
                                                     corner)):
                    continue
            bucket = res if case_index in row_of else mis
            bucket.append((case_index, corner))
            if len(res) == batch_size:
                out = boundary(res, emit_idx)
                res = []
                if out is not None:
                    yield out
            if len(mis) == batch_size:
                out = boundary(mis, emit_host)
                mis = []
                if out is not None:
                    yield out
        # flush the trailing partials. The host generator emits exactly
        # ceil(kept / batch_size) batches per epoch and the loop consumes
        # that many; flushing the two remainders independently would emit
        # ONE EXTRA batch whenever both fit a single batch, and the trained
        # epochs would drift from the generator's by one batch per epoch.
        # Such remainders merge into one host batch (resident cases live in
        # the dataset too); when they overflow one batch, two flushes match
        # the host's two trailing batches. Resident first, so the replayed
        # routing (skip_batches) is deterministic.
        if res and mis and len(res) + len(mis) <= batch_size:
            out = boundary(res + mis, emit_host)
            res, mis = [], []
            if out is not None:
                yield out
        for pairs, emit in ((res, emit_idx), (mis, emit_host)):
            if pairs:
                out = boundary(pairs, emit)
                if out is not None:
                    yield out
        if not yielded:
            raise RuntimeError(
                "partial_index_batch_generator produced no batches for an "
                f"entire epoch (skip_blank={skip_blank}, {len(base_list)} "
                "cases) — truth volumes appear to be empty")


# ---------------------------------------------------------------------------
# The auto decision
# ---------------------------------------------------------------------------

#: budget when the stacks live in host memory (a CPU device): there is no
#: device allocator to ask, so a fixed cap beside the dataset's memory maps.
AUTO_BUDGET_BYTES = 4 << 30

#: fraction of the card's FREE memory the cache may claim; the rest absorbs
#: fragmentation and the estimate's error.
HBM_SAFETY_FRACTION = 0.8

#: bytes kept out of the free memory for the train step's working set
#: (activations, gradients, Adam moments, cuDNN workspaces), none of which
#: exists yet when the cache is built. Set from the step as
#: ``chip_smoke.py``'s scale phase measures it with the cache resident
#: (``configs/fetal_unet.json``, both kernel switches on, batch 6 of 64^3,
#: NVIDIA H100 80GB HBM3 at 700 W): ``torch.cuda.max_memory_allocated``
#: 3.22 GiB above the cache's bytes, and 4.10 GiB reserved by the caching
#: allocator in all. The reserve is twice that reserved figure, rounded
#: down to 8 GiB: room for the validation batch of 12 and for
#: ``configs/fetal_isensee.json``, whose step peaks at 3.63-3.67 GiB on the
#: same card. The phase fails if a step's peak ever exceeds it.
#: Module-level so tests (and unusual models) can patch it.
HBM_STEP_RESERVE_BYTES = 8 << 30


def hbm_budget_bytes(device=None, safety: float = HBM_SAFETY_FRACTION,
                     fallback: Optional[int] = None,
                     reserve: Optional[int] = None) -> int:
    """The cache's budget from the card's ACTUAL free memory:
    ``safety * free - reserve``, where free is what
    ``torch.cuda.mem_get_info(device)`` reports plus what this process's
    caching allocator holds unused. A CPU device (or None) has no
    allocator to ask and gets the static ``fallback`` (module-level
    AUTO_BUDGET_BYTES when None, read at call time so tests can patch it;
    no reserve is taken from it)."""
    if fallback is None:
        fallback = AUTO_BUDGET_BYTES
    if reserve is None:
        reserve = HBM_STEP_RESERVE_BYTES
    if device is None or torch.device(device).type != "cuda":
        return fallback
    free, _total = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return max(0, int(safety * free) - int(reserve))


def maybe_build_device_cache(data_file, config, *, mesh=None, seed=0,
                             train_skip_batches: int = 0,
                             val_skip_batches: int = 0,
                             budget_bytes: Optional[int] = None,
                             resume_data_order: Optional[dict] = None,
                             verbose: bool = False, device=None):
    """Returns ``(cache, train_index_gen, val_index_gen)`` when the device
    case cache applies, else None (host staging).

    Applies when: ``config.device_case_cache != "off"``, patch training, a
    single device or a pure data-parallel mesh (every rank builds the whole
    stacks on its own device), the split pickles exist, the truth is
    integral uint8, and ("auto") the padded stacks fit the budget, taken
    from the device's ACTUAL free memory (:func:`hbm_budget_bytes`;
    ``budget_bytes`` overrides it). "on" raises instead of falling back,
    except for a spatial mesh, and skips the budget check. "auto" falling
    back to host staging is the knob's contract: it says why when
    ``verbose``, and the run stays on the same device and kernels.

    ``device``: where the stacks go; None takes the mesh's device, else
    the card.

    PARTIAL mode (single device, "auto"): when the whole dataset exceeds
    the budget but at least two cases fit, the K hottest cases are cached
    (training cases first, they are revisited every epoch; then
    validation) and the rest host-stage per batch. The generators then
    emit TAGGED batches (:func:`partial_index_batch_generator`) and
    ``cache.partial`` is True.

    ``resume_data_order``: the interrupted run's recorded mode
    (``CheckpointIO.peek_data_order``) when this call resumes with nonzero
    skip counts. Partial mode's batch GROUPING depends on which cases were
    resident, and the auto decision otherwise reads LIVE free memory, which
    can differ between the interrupted run and the resume, so the recorded
    mode is pinned: ``{"mode": "lockstep"}`` suppresses partial (a full
    cache or host staging share the host's batch boundaries);
    ``{"mode": "partial", "resident": [...]}`` forces exactly that resident
    set and RAISES if it cannot be reproduced. None (a fresh run) keeps
    the free auto decision."""
    knob = getattr(config, "device_case_cache", "auto")
    if knob not in ("auto", "on", "off"):
        raise ValueError(
            f"device_case_cache={knob!r} — must be 'auto', 'on' or 'off'")

    forced_partial = (resume_data_order is not None
                      and resume_data_order.get("mode") == "partial")

    def _resume_break(why):
        return RuntimeError(
            "exact-resume violation: the interrupted run trained with a "
            "PARTIAL device case cache (batch grouping depends on the "
            f"resident case set), but {why} — resuming differently would "
            "silently replay a different batch sequence than the "
            "interrupted run consumed. Reproduce the original environment "
            "(free device memory / same config), or delete the "
            "'data_order' field from the checkpoint's .meta.json to accept "
            "an inexact resume.")

    if knob == "off":
        if forced_partial:
            raise _resume_break("device_case_cache is now 'off'")
        return None
    if forced_partial and knob == "on":
        raise _resume_break("device_case_cache='on' forces a FULL cache, "
                            "whose batch grouping differs from partial")

    def skip(reason):
        if knob == "on":
            raise ValueError(f"device_case_cache='on' but {reason}")
        if forced_partial:
            raise _resume_break(reason)
        if verbose:
            print(f"[device-cache] {reason} — keeping host staging")
        return None

    if config.patch_shape is None:
        return skip("patch_shape is None (whole-volume training)")

    dp_mesh = mesh is not None and mesh.size > 1
    if dp_mesh and "spatial" in mesh.axis_names:
        # a depth-sharded volume axis would need halo-aware gathers
        if forced_partial:
            raise _resume_break("a spatial/hybrid mesh is now active "
                                "(partial mode is single-device)")
        if verbose:
            print("[device-cache] spatial/hybrid mesh — keeping host staging")
        return None
    if not (os.path.exists(config.training_file)
            and os.path.exists(config.validation_file)):
        return skip("split pickles not found (build the generators first)")
    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    device = resolve_device(device)
    training_list = [int(i) for i in pickle_load(config.training_file)]
    validation_list = [int(i) for i in pickle_load(config.validation_file)]
    all_cases = sorted(set(training_list) | set(validation_list))
    margin_lo, margin_hi = plan_margins(
        tuple(data_file.root.data.shape[-3:]), config.patch_shape,
        config.validation_patch_overlap, config.training_patch_start_offset)
    dtype = (torch.bfloat16 if config.compute_dtype == "bfloat16"
             else torch.float32)
    est = estimate_cache_bytes(data_file, len(all_cases), margin_lo,
                               margin_hi, dtype_bytes=dtype.itemsize)
    budget = (int(budget_bytes) if budget_bytes is not None
              else hbm_budget_bytes(device))
    resident = all_cases
    if forced_partial:
        # reproduce the interrupted run's resident set EXACTLY: grouping
        # (and so the skip_batches fast-forward) depends on membership
        recorded = [int(c) for c in (resume_data_order.get("resident")
                                     or [])]
        missing = sorted(set(recorded) - set(all_cases))
        if len(recorded) < 2 or missing:
            raise _resume_break(
                "the recorded resident set is "
                + (f"not in the current splits (cases {missing[:5]})"
                   if missing else "empty/invalid"))
        if dp_mesh:
            raise _resume_break("a multi-device mesh is now active "
                                "(partial mode is single-device)")
        resident = recorded
    elif knob == "auto" and est > budget:
        if resume_data_order is not None:
            # the interrupted run used lockstep batch boundaries; engaging
            # partial now would regroup, host staging keeps the sequence
            if verbose:
                print("[device-cache] resumed run recorded lockstep data "
                      "order — partial mode suppressed, keeping host "
                      "staging")
            return None
        # partial mode: cache what fits (single device only: per-rank host
        # routing of a partially resident stack is not implemented)
        case_bytes = max(1, est // max(1, len(all_cases)))
        k = int(budget // case_bytes)
        if dp_mesh or k < 2:
            if verbose:
                why = ("data-parallel mesh" if dp_mesh
                       else f"only {k} case(s) fit")
                print(f"[device-cache] dataset needs {est / 2**30:.2f} GiB "
                      f"(> {budget / 2**30:.2f} GiB budget) and partial "
                      f"mode is unavailable ({why}) — keeping host staging")
            return None
        # hottest first: training cases are revisited every epoch at full
        # grid weight, validation cases only at validation time
        ordered = list(dict.fromkeys(list(training_list)
                                     + list(validation_list)))
        resident = ordered[:k]
    partial = len(resident) < len(all_cases)
    try:
        cache = DeviceCaseCache.build(
            data_file, resident, patch_shape=config.patch_shape,
            margin_lo=margin_lo, margin_hi=margin_hi, dtype=dtype,
            device=device,
            keep_host_truth=config.skip_blank and not partial)
    except ValueError as e:
        # non-integral truth: a representation problem, not a bug
        return skip(str(e))
    except (RuntimeError, MemoryError) as e:
        # the budget is an estimate: a device whose memory is busy can
        # still fail the upload (torch.cuda.OutOfMemoryError is a
        # RuntimeError). The auto contract is host staging, not a crash.
        return skip(f"cache upload failed ({type(e).__name__}: {e})")
    cache.partial = partial
    cache.n_total_cases = len(all_cases)
    cache.resident_cases = sorted(int(c) for c in resident)
    if verbose:
        frac = len(resident) / max(1, len(all_cases))
        part = (f"{len(resident)}/{len(all_cases)} cases "
                f"({frac:.0%}) resident — PARTIAL cache, non-resident "
                "patches host-stage" if partial
                else f"{len(all_cases)} cases resident on {device}")
        print(f"[device-cache] {part} ({cache.nbytes / 2**20:.0f} MiB"
              f"{' on every rank' if dp_mesh else ''}); "
              "steps feed int32 indices")
    common = dict(patch_shape=config.patch_shape,
                  skip_blank=config.skip_blank, seed=seed)
    train_kw = dict(batch_size=config.batch_size, patch_overlap=0,
                    patch_start_offset=config.training_patch_start_offset,
                    skip_batches=train_skip_batches, **common)
    val_kw = dict(batch_size=config.validation_batch_size
                  or config.batch_size,
                  patch_overlap=config.validation_patch_overlap,
                  shuffle_index_list=False, skip_batches=val_skip_batches,
                  **common)
    if partial:
        # ONE truth cache across both generators: they blank-check the same
        # dataset (the full-cache path shares its truth lookup likewise)
        make = partial_index_batch_generator
        shared = dict(truth_cache=TruthCache(data_file, max_cases=64),
                      n_labels=config.n_labels, labels=config.labels)
    else:
        make = index_batch_generator
        shared = dict(truth_cache=(_DictTruth(cache.host_truth)
                                   if cache.host_truth is not None
                                   else None))
    return (cache,
            make(data_file, training_list, cache.row_of, **train_kw,
                 **shared),
            make(data_file, validation_list, cache.row_of, **val_kw,
                 **shared))
