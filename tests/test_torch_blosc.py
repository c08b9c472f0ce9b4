"""The port reads the reference-era PyTables/blosc datasets
(``fetal_mri_segmentation_tpu_torch/data/blosc_compat.py`` behind
``data/build.py::open_data_file``) as the JAX package's ``open_data_file``
reads them: the same arrays, bit for bit, the same subject ids and
normalization, the same patch batches from the generators, and the
port's converter writes them into its native layout. The files are made
as ``tests/test_blosc_compat.py`` makes them (h5py's raw-chunk writes of
frames from the system libblosc, byte-compatible with PyTables' filter).
Like that file, each test skips only where libblosc is missing.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import h5py  # noqa: E402

from fetal_mri_segmentation_tpu.data import (  # noqa: E402
    open_data_file as jax_open)
from fetal_mri_segmentation_tpu.pipeline import generator as JG  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data import blosc_compat  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data import build as port_build  # noqa: E402
from fetal_mri_segmentation_tpu_torch.pipeline import generator as TG  # noqa: E402
from tests.test_blosc_compat import (  # noqa: E402
    _write_blosc_dataset, _write_reference_style_file)


@pytest.fixture
def reference_file(tmp_path):
    if not blosc_compat.blosc_available():
        pytest.skip("system libblosc not available: blosc interop is "
                    "exercised on hosts that have it")
    path = str(tmp_path / "reference_data.h5")
    return (path,) + _write_reference_style_file(path, n=4)


def test_open_data_file_reads_blosc_like_jax(reference_file):
    path, data, truth, affine = reference_file
    port, jax = port_build.open_data_file(path), jax_open(path)
    try:
        assert isinstance(port.root.data, blosc_compat.BloscDataset)
        assert len(port) == len(jax) == 4
        for name, want in (("data", data), ("truth", truth),
                           ("affine", affine)):
            got = getattr(port.root, name)
            assert got.shape == want.shape and got.dtype == want.dtype
            for i in (0, 3, -1):
                np.testing.assert_array_equal(got[i], getattr(jax.root,
                                                              name)[i])
            np.testing.assert_array_equal(got[1:3], want[1:3])
            np.testing.assert_array_equal(np.asarray(got), want)
        np.testing.assert_array_equal(port.root.data[2, 0, 5:9],
                                      jax.root.data[2, 0, 5:9])
        assert port.subject_ids == [f"sub_{i}" for i in range(4)]
        assert port.normalization == "per_volume"
    finally:
        port.close()
        jax.close()


def test_generators_read_blosc_like_jax(reference_file, tmp_path):
    """Patch batches of the port's generator off the blosc file equal the
    JAX generator's off the same file (same seed, same split)."""
    path = reference_file[0]
    port, jax = port_build.open_data_file(path), jax_open(path)
    try:
        got = TG.data_generator(port, [0, 1, 3], batch_size=2,
                                patch_shape=(8, 8, 8), seed=3,
                                patch_start_offset=(2, 2, 2))
        want = JG.data_generator(jax, [0, 1, 3], batch_size=2,
                                 patch_shape=(8, 8, 8), seed=3,
                                 patch_start_offset=(2, 2, 2))
        for _ in range(3):
            for a, b in zip(next(got), next(want)):
                np.testing.assert_array_equal(a, b)
    finally:
        port.close()
        jax.close()


def test_convert_writes_the_native_layout(reference_file, tmp_path):
    path, data, truth, affine = reference_file
    out = port_build.convert_hdf5(path, str(tmp_path / "native"))
    with port_build.open_data_file(out) as native:
        np.testing.assert_array_equal(np.asarray(native.root.data), data)
        np.testing.assert_array_equal(np.asarray(native.root.truth), truth)
        np.testing.assert_array_equal(np.asarray(native.root.affine), affine)
        assert native.subject_ids == [f"sub_{i}" for i in range(4)]
        assert native.normalization == "per_volume"


def test_blosc_pipeline_with_another_filter_is_refused(reference_file,
                                                       tmp_path):
    """Blosc stacked behind the HDF5 shuffle filter would decode to
    scrambled voxels: refused with the JAX package's ValueError."""
    path = str(tmp_path / "stacked.h5")
    arr = np.arange(2 * 4 * 4 * 4, dtype=np.float32).reshape(2, 1, 4, 4, 4)
    with h5py.File(path, "w") as h5:
        space = h5py.h5s.create_simple(arr.shape)
        plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        plist.set_chunk((1, 1, 4, 4, 4))
        plist.set_shuffle()
        plist.set_filter(blosc_compat.BLOSC_FILTER_ID,
                         h5py.h5z.FLAG_OPTIONAL, (2, 2, 4, 256, 5, 1, 0))
        h5py.h5d.create(h5.id, b"data", h5py.h5t.py_create("f4"), space,
                        dcpl=plist)
        _write_blosc_dataset(h5, "truth", arr.astype(np.uint8),
                             chunks=(1, 1, 4, 4, 4))
        h5.create_dataset("affine", data=np.stack([np.eye(4)] * 2))
    with pytest.raises(ValueError, match="stacks blosc with other filters"):
        port_build.open_data_file(path)
    assert os.path.exists(path)
