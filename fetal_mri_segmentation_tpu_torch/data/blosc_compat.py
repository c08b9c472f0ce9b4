"""Read reference-era PyTables/blosc HDF5 datasets without PyTables: a copy
of ``fetal_mri_segmentation_tpu/data/blosc_compat.py``, kept in the port so
that the port imports nothing of the JAX package
(``tests/test_torch_copies.py`` holds each function equal to the original).

The reference writes its dataset with PyTables EArrays compressed by the
HDF5 *blosc* filter (id 32001, complevel 5). The system ``libblosc.so.1``
is driven through ctypes, raw chunks come through h5py's
``read_direct_chunk`` (which bypasses the HDF5 filter pipeline), and
:class:`BloscDataset` assembles the decompressed chunks into numpy arrays
behind a read-only, h5py-Dataset-like surface.
``data/build.py::open_data_file`` wraps every blosc-filtered array of an
HDF5 dataset in one, where h5py is installed; ``python -m
fetal_mri_segmentation_tpu_torch.data.build --convert`` rewrites such a
file into the port's native layout.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional, Tuple

import numpy as np

BLOSC_FILTER_ID = 32001  # registered HDF5 filter id for blosc


@functools.lru_cache(maxsize=1)
def _libblosc() -> Optional[ctypes.CDLL]:
    """The system blosc C library, or None when unavailable."""
    candidates = []
    found = ctypes.util.find_library("blosc")
    if found:
        candidates.append(found)
    candidates += ["libblosc.so.1", "libblosc.so", "libblosc.1.dylib"]
    for name in candidates:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        lib.blosc_compress_ctx.restype = ctypes.c_int
        lib.blosc_compress_ctx.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        return lib
    return None


def blosc_available() -> bool:
    return _libblosc() is not None


def blosc_decompress(chunk: bytes, nbytes: Optional[int] = None) -> bytes:
    """Decompress one blosc frame (handles blosc's internal shuffle).

    ``nbytes``: expected decompressed size; read from the frame header
    (bytes 4:8, little-endian) when omitted.
    """
    lib = _libblosc()
    if lib is None:
        raise RuntimeError(
            "libblosc is not available on this system — use "
            "tools/convert_reference_h5.py on a machine that has it, or "
            "rebuild the dataset from NIfTI with train.py --overwrite")
    if nbytes is None:
        if len(chunk) < 16:
            raise ValueError("truncated blosc frame (<16-byte header)")
        nbytes = int.from_bytes(chunk[4:8], "little")
    out = ctypes.create_string_buffer(nbytes)
    n = lib.blosc_decompress_ctx(chunk, out, nbytes, 1)
    if n != nbytes:
        raise ValueError(f"blosc decompression failed (rc={n}, "
                         f"expected {nbytes} bytes)")
    return out.raw


def blosc_compress(data: np.ndarray, clevel: int = 5,
                   shuffle: int = 1, cname: bytes = b"blosclz") -> bytes:
    """Compress an array into one blosc frame (test/tooling helper —
    mirrors PyTables' complevel-5 blosc default)."""
    lib = _libblosc()
    if lib is None:
        raise RuntimeError("libblosc is not available on this system")
    data = np.ascontiguousarray(data)
    src = data.tobytes()
    dest = ctypes.create_string_buffer(len(src) + 16)
    n = lib.blosc_compress_ctx(clevel, shuffle, data.dtype.itemsize,
                               len(src), src, dest, len(dest), cname, 0, 1)
    if n <= 0:
        raise ValueError(f"blosc compression failed (rc={n})")
    return dest.raw[:n]


def dataset_filters(dset) -> Tuple[int, ...]:
    """HDF5 filter ids on a dataset's chunk pipeline (low-level — h5py's
    ``.compression`` reports None for unregistered filters)."""
    plist = dset.id.get_create_plist()
    return tuple(plist.get_filter(i)[0] for i in range(plist.get_nfilters()))


def is_unreadable_blosc(dset) -> bool:
    """True when this dataset needs the (absent) blosc HDF5 filter.

    Only a PURE blosc pipeline qualifies for the built-in reader: with
    another filter stacked (e.g. HDF5 shuffle ahead of blosc) the reader
    would blosc-decompress but never undo the other stage — silently
    scrambled voxels — and the raw-chunk filter-mask bit would refer to
    the wrong pipeline stage. Such files are rejected loudly instead.
    """
    try:
        filters = dataset_filters(dset)
    except Exception:
        return False
    if BLOSC_FILTER_ID not in filters or _filter_registered():
        return False
    if filters != (BLOSC_FILTER_ID,):
        raise ValueError(
            f"dataset {dset.name!r}: HDF5 filter pipeline {filters} stacks "
            f"blosc with other filters — the built-in blosc reader only "
            f"handles a pure blosc pipeline (decoding anyway would return "
            f"silently scrambled data). Install the blosc HDF5 filter "
            f"plugin, or re-export the file without the extra filters.")
    return True


@functools.lru_cache(maxsize=1)
def _filter_registered() -> bool:
    import h5py

    try:
        return bool(h5py.h5z.filter_avail(BLOSC_FILTER_ID))
    except Exception:
        return False


class BloscDataset:
    """Read-only, h5py-Dataset-like view over a blosc-filtered dataset.

    Supports the access patterns the pipeline uses on ``root.data`` /
    ``root.truth``: ``.shape``, ``.dtype``, ``len()``, integer and
    basic-slice indexing. Chunks are fetched raw (``read_direct_chunk``
    bypasses the filter pipeline) and decompressed via libblosc, which
    also undoes blosc's internal shuffle. Edge chunks are stored
    full-size by HDF5, so decompressed chunks are trimmed to the array
    bounds.
    """

    def __init__(self, dset):
        self._dset = dset
        self.shape = tuple(dset.shape)
        self.dtype = dset.dtype
        self.chunks = tuple(dset.chunks) if dset.chunks else self.shape

    def __len__(self) -> int:
        return self.shape[0]

    def _chunk_array(self, chunk_offset: Tuple[int, ...]) -> np.ndarray:
        filter_mask, raw = self._dset.id.read_direct_chunk(chunk_offset)
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        if filter_mask & 1:
            # filter skipped for this chunk: the c-blosc HDF5 filter calls
            # blosc_compress with destsize == nbytes, so an incompressible
            # chunk is stored RAW with the filter-mask bit set — the bytes
            # must not be fed to the decompressor
            buf = bytes(raw)
            if len(buf) != nbytes:
                raise ValueError(
                    f"chunk at {chunk_offset}: filter-skipped chunk has "
                    f"{len(buf)} bytes, expected {nbytes}")
        else:
            buf = blosc_decompress(bytes(raw), nbytes)
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.chunks)

    def __getitem__(self, key) -> np.ndarray:
        index = np.index_exp[key]
        if self._needs_full(index):
            # general case: materialize the whole array, then index it
            # (zeros = the HDF5 fill value, in case a chunk was never
            # allocated)
            out = np.zeros(self.shape, self.dtype)
            self._fill(out, None)
            return out[key]
        # fast path: leading-axis integer (the pipeline's per-case read) —
        # only the chunks containing that row are decompressed
        i = int(index[0])
        if i < 0:
            i += self.shape[0]
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"index {index[0]} out of range "
                             f"for axis 0 of size {self.shape[0]}")
        out = np.zeros((1,) + self.shape[1:], self.dtype)
        self._fill(out, i)
        rest = index[1:]
        return out[(0,) + rest] if rest else out[0]

    def _needs_full(self, index) -> bool:
        return not (len(index) >= 1 and isinstance(index[0], (int, np.integer)))

    def _chunk_allocated(self, chunk_offset) -> Optional[bool]:
        """False iff the chunk verifiably has no storage allocated;
        None when the probe API is unavailable (treated as unknown)."""
        try:
            info = self._dset.id.get_chunk_info_by_coord(chunk_offset)
            return info.byte_offset is not None
        except Exception:
            return None

    def _fill(self, out: np.ndarray, only_row: Optional[int]) -> None:
        """Decompress every chunk overlapping the request into ``out``
        (``out`` covers the full array, or one leading-axis row).

        Chunk offsets lie on the regular chunk grid, so they are computed
        directly — enumerating the chunk index (get_num_chunks +
        get_chunk_info) walked EVERY chunk's B-tree entry per read, an
        O(total-chunks) metadata scan for a single-case access."""
        import itertools

        c0 = self.chunks[0]
        if only_row is not None:
            lead = [(only_row // c0) * c0]
        else:
            lead = range(0, self.shape[0], c0)
        rest_grid = [range(0, s, c)
                     for s, c in zip(self.shape[1:], self.chunks[1:])]
        for off in itertools.product(lead, *rest_grid):
            try:
                arr = self._chunk_array(off)
            except KeyError:
                continue  # never-written chunk -> HDF5 fill value (0)
            except (OSError, RuntimeError) as e:
                # h5py raises RuntimeError ("chunk storage is not
                # allocated") for never-written chunks on some versions;
                # distinguish "chunk was never allocated" (legitimate fill
                # value) from a REAL read failure (truncated/corrupt file)
                # — substituting zeros for the latter would train/predict
                # on partially-zeroed volumes with no error
                alloc = self._chunk_allocated(off)
                if alloc is False:
                    continue
                if alloc is None and "not allocated" in str(e).lower():
                    # probe API unavailable (h5py < 3.0) but the error text
                    # is h5py's never-written-chunk message — legitimate
                    # fill value, not corruption
                    continue
                raise ValueError(
                    f"failed to read chunk {off} of "
                    f"{getattr(self._dset, 'name', '?')}: {e} — the file "
                    f"appears truncated or corrupt") from e
            # trim to array bounds (edge chunks are stored full-size)
            slices_src, slices_dst = [], []
            for d, (o, c, s) in enumerate(zip(off, self.chunks, self.shape)):
                valid = min(c, s - o)
                slices_src.append(slice(0, valid))
                if d == 0 and only_row is not None:
                    # map the absolute row to out's single-row axis
                    slices_dst.append(slice(0, 1))
                    slices_src[0] = slice(only_row - o, only_row - o + 1)
                else:
                    slices_dst.append(slice(o, o + valid))
            out[tuple(slices_dst)] = arr[tuple(slices_src)]

    # h5py-Dataset conveniences used around the codebase
    def __array__(self, dtype=None):
        arr = self[...]
        return arr.astype(dtype) if dtype is not None else arr
