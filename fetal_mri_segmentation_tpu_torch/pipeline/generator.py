"""Patch-sampling data pipeline on the host (port of
``fetal_mri_segmentation_tpu/pipeline/generator.py``).

Copies of the numpy functions the training loop needs: the split, the
patch index list, the batch generator with data-order exact resume
(``BatchSkipper``), patch counting and
``get_training_and_validation_generators``. The JAX package's module
imports jax through its ``ops`` package, so the port cannot import it;
tests hold the copies equal to the originals. The data file is any object
with ``.root.data`` (N, C, D, H, W) and ``.root.truth`` (N, 1, D, H, W):
the dataset that ``data/build.py`` opens (the port's directory of memory
maps, or the JAX package's HDF5 file where h5py is installed), or
:class:`InMemoryDataFile` (``data/memory.py``). Batches come out as channels-first float32 numpy
arrays; augmentation runs on the device in the train step.
"""

from __future__ import annotations

import collections
import copy
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fetal_mri_segmentation_tpu_torch.utils.io_utils import (
    pickle_dump, pickle_load)
from fetal_mri_segmentation_tpu_torch.ops.patches import (
    compute_patch_indices, get_patch_from_3d_data, get_random_nd_index)


# ---------------------------------------------------------------------------
# Split
# ---------------------------------------------------------------------------

def get_validation_split(data_file, training_file: str, validation_file: str,
                         data_split: float = 0.8, overwrite: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple[List[int], List[int]]:
    """Shuffle case indices, split, pickle the index lists (reused on rerun).

    Reference: generator.py::get_validation_split + split_list (pickled to
    training_ids.pkl / validation_ids.pkl; recomputed only on overwrite).
    """
    if overwrite or not (os.path.exists(training_file)
                         and os.path.exists(validation_file)):
        # EITHER pickle missing regenerates the pair — loading a surviving
        # training_file against a freshly-made validation_file (or crashing
        # on the missing one) would silently desync the split
        n = data_file.root.data.shape[0]
        sample_list = list(range(n))
        rng = np.random.default_rng(seed)
        rng.shuffle(sample_list)
        n_training = int(len(sample_list) * data_split)
        training_list = sample_list[:n_training]
        validation_list = sample_list[n_training:]
        pickle_dump(training_list, training_file)
        pickle_dump(validation_list, validation_file)
        return training_list, validation_list
    training_list = pickle_load(training_file)
    validation_list = pickle_load(validation_file)
    contaminated = set(training_list) & set(validation_list)
    if contaminated:
        # a training pickle from one run paired with a validation pickle
        # from another loads without error but puts the same cases in both
        # lists — every validation metric would then be silently invalid
        raise ValueError(
            f"training and validation index pickles OVERLAP (case indices "
            f"{sorted(contaminated)[:8]}{'...' if len(contaminated) > 8 else ''}) "
            f"— {training_file} and {validation_file} come from different "
            f"runs; delete both (or pass overwrite) to regenerate the split")
    return training_list, validation_list


# ---------------------------------------------------------------------------
# Label conversion
# ---------------------------------------------------------------------------

def get_multi_class_labels(truth: np.ndarray, n_labels: int,
                           labels: Optional[Sequence[int]] = None
                           ) -> np.ndarray:
    """(B, 1, D, H, W) label map → (B, n_labels, D, H, W) one-hot float32.

    Reference: generator.py::get_multi_class_labels.
    """
    new_shape = (truth.shape[0], n_labels) + truth.shape[2:]
    y = np.zeros(new_shape, np.float32)
    for label_index in range(n_labels):
        lab = labels[label_index] if labels is not None else (label_index + 1)
        y[:, label_index][truth[:, 0] == lab] = 1.0
    return y


def convert_data(x_list: List[np.ndarray], y_list: List[np.ndarray],
                 n_labels: int = 1, labels: Optional[Sequence[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a batch; binarize truth if n_labels==1 else one-hot expand.

    Reference: generator.py::convert_data.
    """
    x = np.asarray(x_list, dtype=np.float32)
    y = np.asarray(y_list, dtype=np.float32)
    if y.ndim == x.ndim - 1:
        y = y[:, None]
    if n_labels == 1:
        y = (y > 0).astype(np.float32)
    elif n_labels > 1:
        y = get_multi_class_labels(y, n_labels=n_labels, labels=labels)
    return x, y


def get_number_of_steps(n_samples: int, batch_size: int) -> int:
    """Reference: generator.py::get_number_of_steps — ceil division, except
    that for n_samples <= batch_size the reference returns ``n_samples``
    (each step then yields a partial batch of 1+ samples), matched exactly."""
    if n_samples <= batch_size:
        return n_samples
    return -(-n_samples // batch_size)


# ---------------------------------------------------------------------------
# Case reading with an LRU RAM cache
# ---------------------------------------------------------------------------

class CaseCache:
    """LRU cache of decompressed cases — kills the reference's per-patch
    whole-case HDF5 reread (SURVEY.md section 3.1 hot-loop note)."""

    def __init__(self, data_file, max_cases: int = 64):
        self._file = data_file
        self._max = max_cases
        self._cache: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()

    def get(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if index in self._cache:
            self._cache.move_to_end(index)
            return self._cache[index]
        data = np.asarray(self._file.root.data[index], dtype=np.float32)
        truth = np.asarray(self._file.root.truth[index], dtype=np.float32)
        self._cache[index] = (data, truth)
        if len(self._cache) > self._max:
            self._cache.popitem(last=False)
        return data, truth


class TruthCache:
    """LRU of truth volumes ONLY (uint8-sized) for host blank-skip checks —
    ~1/(4·C+1) of a full case's bytes. Used by the skip_blank fast-forward
    (resume) so replaying blank decisions never decompresses the float32
    data payload."""

    def __init__(self, data_file, max_cases: int = 64):
        self._file = data_file
        self._max = max_cases
        self._cache: "collections.OrderedDict[int, np.ndarray]" = (
            collections.OrderedDict())

    def get(self, index: int) -> np.ndarray:
        if index in self._cache:
            self._cache.move_to_end(index)
            return self._cache[index]
        truth = np.asarray(self._file.root.truth[index])
        self._cache[index] = truth
        if len(self._cache) > self._max:
            self._cache.popitem(last=False)
        return truth


def get_data_from_file(data_file, index, patch_shape=None,
                       cache: Optional[CaseCache] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Read one case (or slice one patch of it when index = (case, corner)).

    Reference: generator.py::get_data_from_file.
    """
    if patch_shape is not None:
        case_index, patch_corner = index
        data, truth = get_data_from_file(data_file, case_index, cache=cache)
        x = get_patch_from_3d_data(data, patch_shape, patch_corner)
        y = get_patch_from_3d_data(truth, patch_shape, patch_corner)
        return x, y
    if cache is not None:
        return cache.get(index)
    return (np.asarray(data_file.root.data[index], dtype=np.float32),
            np.asarray(data_file.root.truth[index], dtype=np.float32))


# ---------------------------------------------------------------------------
# Patch index list
# ---------------------------------------------------------------------------

def create_patch_index_list(index_list: Sequence[int],
                            image_shape: Sequence[int],
                            patch_shape: Sequence[int],
                            patch_overlap: int = 0,
                            patch_start_offset: Optional[Sequence[int]] = None,
                            rng: Optional[np.random.Generator] = None
                            ) -> List[Tuple[int, np.ndarray]]:
    """[(case_idx, corner), ...] over all cases.

    Training uses a per-case random NEGATIVE start offset in
    [-patch_start_offset, 0] so epochs see different grids; validation uses
    the fixed centered overlap grid. Reference: generator.py::
    create_patch_index_list.
    """
    patch_index = []
    rng = rng or np.random.default_rng()
    for index in index_list:
        if patch_start_offset is not None:
            random_start_offset = np.negative(
                get_random_nd_index(patch_start_offset, rng))
            patches = compute_patch_indices(image_shape, patch_shape,
                                            overlap=patch_overlap,
                                            start=random_start_offset)
        else:
            patches = compute_patch_indices(image_shape, patch_shape,
                                            overlap=patch_overlap)
        patch_index.extend((index, patch) for patch in patches)
    return patch_index


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

class BatchSkipper:
    """Batch-level fast-forward boundary math of ``data_generator`` (a
    resumed stream must replay IDENTICAL batch boundaries for data-order
    exact resume).

    Usage per epoch: call :meth:`reset_epoch`, then either
    :meth:`arith_skip_epoch` (no blank-skipping: batch counts are exact,
    no per-patch walk) or :meth:`note_kept_patch` per surviving patch.
    Truthiness = "still skipping". ``left`` only reaches 0 at a batch
    boundary, so the switch back to yielding never lands mid-batch.
    """

    def __init__(self, skip_batches: int):
        if skip_batches < 0:
            raise ValueError(f"skip_batches={skip_batches} must be >= 0")
        self.left = int(skip_batches)
        self._in_batch = 0

    def __bool__(self) -> bool:
        return self.left > 0

    def reset_epoch(self) -> None:
        # defensive only: the emit path yields any held partial at epoch
        # end (even when the final pop was blank-skipped), so _in_batch is
        # always 0 here — kept so a future emit-path change cannot leak
        # in-batch state across epochs
        self._in_batch = 0

    def arith_skip_epoch(self, epoch_list: list, batch_size: int) -> bool:
        """Returns True when the WHOLE remaining epoch was consumed (caller
        moves to the next epoch); otherwise trims the consumed prefix off
        ``epoch_list`` in place and deactivates. ``epoch_list`` is consumed
        by pop() from the end, so the first ``left`` batches are the LAST
        ``left * batch_size`` entries."""
        n_batches = -(-len(epoch_list) // batch_size)
        if self.left >= n_batches:
            self.left -= n_batches
            return True
        del epoch_list[-self.left * batch_size:]
        self.left = 0
        return False

    def note_patch(self, kept: bool, batch_size: int,
                   epoch_end: bool) -> bool:
        """Replay one popped index into the batch being skipped; True when
        a skipped-batch boundary was crossed — the SAME boundary condition
        as the emit path: batch full, or epoch exhausted with patches held.
        Blank pops (kept=False) count nothing but can still close a held
        partial batch at epoch end, exactly like the emit path does."""
        if kept:
            self._in_batch += 1
        if self._in_batch and (self._in_batch == batch_size or epoch_end):
            self.left -= 1
            self._in_batch = 0
            return True
        return False


def data_generator(data_file, index_list, batch_size: int = 1,
                   n_labels: int = 1, labels=None, patch_shape=None,
                   patch_overlap: int = 0, patch_start_offset=None,
                   shuffle_index_list: bool = True, skip_blank: bool = True,
                   seed: Optional[int] = None,
                   cache_cases: int = 64,
                   skip_batches: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite epoch-reshuffling batch generator of channels-first arrays.

    Reference: generator.py::data_generator (augmentation removed — it runs
    on device; see ops/augment.py).

    Epoch k's rng is derived as ``default_rng((seed, k))`` (one fresh
    stream per epoch, not one stream advanced across epochs), so the batch
    sequence is a pure function of ``seed`` — resumable at any point.
    ``skip_batches`` fast-forwards the stream by exactly that many emitted
    batches (replaying every rng draw and blank-skip decision, skipping
    only the one-hot/convert/yield), so a resumed run trains on the EXACT
    batch sequence an uninterrupted run would — data-order exact resume
    even when ``skip_blank`` makes generator-epoch lengths drift from the
    loop's fixed ``steps_per_epoch`` (train.py peeks the checkpoint's
    epoch via CheckpointIO.peek_epoch and skips epoch*steps batches).
    ``seed=None`` stays nondeterministic.
    """
    skipper = BatchSkipper(skip_batches)
    cache = CaseCache(data_file, max_cases=cache_cases)
    truth_cache = TruthCache(data_file, max_cases=cache_cases)
    base_list = list(index_list)
    image_shape = tuple(data_file.root.data.shape[-3:])
    epoch = 0

    while True:
        rng = np.random.default_rng(
            None if seed is None else (seed, epoch))
        epoch += 1
        x_list: List[np.ndarray] = []
        y_list: List[np.ndarray] = []
        skipper.reset_epoch()
        if patch_shape is not None:
            epoch_list = create_patch_index_list(
                base_list, image_shape, patch_shape, patch_overlap,
                patch_start_offset, rng)
        else:
            epoch_list = copy.copy(base_list)
        if shuffle_index_list:
            rng.shuffle(epoch_list)
        yielded = False
        while epoch_list:
            if skipper and not skip_blank:
                # the epoch's rng draws already happened above
                if skipper.arith_skip_epoch(epoch_list, batch_size):
                    yielded = True
                    break
                continue
            index = epoch_list.pop()
            if skipper:
                # skip_blank fast-forward: replay only the blank decision —
                # truth-only LRU reads (TruthCache), so resuming never
                # decompresses the float32 data payload of skipped cases
                if patch_shape is not None:
                    truth = truth_cache.get(index[0])
                    y = get_patch_from_3d_data(truth, patch_shape, index[1])
                else:
                    y = truth_cache.get(index)
                if skipper.note_patch(bool(np.any(y)), batch_size,
                                      not epoch_list):
                    yielded = True
                continue
            x, y = get_data_from_file(data_file, index,
                                      patch_shape=patch_shape, cache=cache)
            if not (skip_blank and not np.any(y)):
                x_list.append(x)
                y_list.append(y)
            # the emit check runs after EVERY pop (reference semantics:
            # generator.py::data_generator checks after add_data whether
            # the patch was kept or not) — a trailing partial batch is
            # yielded even when the epoch's final pops were blank-skipped
            if x_list and (len(x_list) == batch_size or not epoch_list):
                yield convert_data(x_list, y_list, n_labels=n_labels,
                                   labels=labels)
                yielded = True
                x_list, y_list = [], []
        if not yielded:
            # every patch was blank-skipped: a consumer waiting on
            # next(generator) would otherwise hang forever
            raise RuntimeError(
                "data_generator produced no batches for an entire epoch "
                f"(skip_blank={skip_blank}, {len(base_list)} cases) — "
                "truth volumes appear to be empty")


def get_number_of_patches(data_file, index_list, patch_shape=None,
                          patch_overlap: int = 0, patch_start_offset=None,
                          skip_blank: bool = True,
                          cache_cases: int = 64) -> int:
    """Count non-blank patches for steps_per_epoch.

    Reference: generator.py::get_number_of_patches (walks one epoch once).
    """
    if patch_shape is None:
        return len(index_list)
    cache = CaseCache(data_file, max_cases=cache_cases)
    image_shape = tuple(data_file.root.data.shape[-3:])
    index = create_patch_index_list(index_list, image_shape, patch_shape,
                                    patch_overlap, patch_start_offset,
                                    np.random.default_rng(0))
    if not skip_blank:
        return len(index)
    count = 0
    for idx in index:
        _, y = get_data_from_file(data_file, idx, patch_shape=patch_shape,
                                  cache=cache)
        if np.any(y):
            count += 1
    return count


def get_training_and_validation_generators(
        data_file, batch_size: int, n_labels: int, training_keys_file: str,
        validation_keys_file: str, data_split: float = 0.8,
        overwrite: bool = False, labels=None, patch_shape=None,
        validation_batch_size=None, validation_patch_overlap: int = 0,
        training_patch_start_offset=None, skip_blank: bool = True,
        seed: Optional[int] = None, cache_cases: int = 64,
        start_epoch: int = 0,
        # accepted for reference-signature parity; augmentation itself is
        # applied on device in the train step (ops/augment.py):
        augment: bool = False, augment_flip: bool = True,
        augment_distortion_factor=0.25, permute: bool = False):
    """Returns (train_gen, n_train_steps, val_gen, n_val_steps).

    Reference: generator.py::get_training_and_validation_generators — same
    call signature and semantics; the `augment*`/`permute` flags are carried
    in the config to the train step instead of mutating batches here.
    """
    validation_batch_size = validation_batch_size or batch_size
    training_list, validation_list = get_validation_split(
        data_file, training_keys_file, validation_keys_file,
        data_split=data_split, overwrite=overwrite, seed=seed)

    num_training_steps = get_number_of_steps(
        get_number_of_patches(data_file, training_list, patch_shape,
                              patch_start_offset=training_patch_start_offset,
                              skip_blank=skip_blank, cache_cases=cache_cases),
        batch_size)
    num_validation_steps = get_number_of_steps(
        get_number_of_patches(data_file, validation_list, patch_shape,
                              patch_overlap=validation_patch_overlap,
                              skip_blank=skip_blank, cache_cases=cache_cases),
        validation_batch_size)

    # data-order exact resume: the training loop consumes exactly
    # steps_per_epoch batches per epoch, so a run resumed at epoch k has
    # consumed k*steps batches of each stream — fast-forward both by that
    # count (NOT by generator epochs: with skip_blank the generator's own
    # epoch lengths drift from the fixed step counts)
    training_generator = data_generator(
        data_file, training_list, batch_size=batch_size, n_labels=n_labels,
        labels=labels, patch_shape=patch_shape,
        patch_start_offset=training_patch_start_offset,
        patch_overlap=0, skip_blank=skip_blank, seed=seed,
        cache_cases=cache_cases,
        skip_batches=start_epoch * num_training_steps)
    validation_generator = data_generator(
        data_file, validation_list, batch_size=validation_batch_size,
        n_labels=n_labels, labels=labels, patch_shape=patch_shape,
        patch_overlap=validation_patch_overlap, skip_blank=skip_blank,
        shuffle_index_list=False, seed=seed, cache_cases=cache_cases,
        skip_batches=start_epoch * num_validation_steps)
    return (training_generator, num_training_steps,
            validation_generator, num_validation_steps)
