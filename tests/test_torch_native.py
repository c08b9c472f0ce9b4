"""The port's native host library (``utils/native.py`` over its copy of
``native/fastloader.cpp``) against numpy, case by case as
``tests/test_native.py``: each entry point equals the numpy path exactly
(the JAX package's numpy path with ``FETAL_TPU_NO_NATIVE=1``, and the
port's own), a patch wholly outside the volume is zeros, the one-hot
binding, the hash-named build (two processes that build at once both end
with one whole library; another source gets another file), and the numpy
path where no compiler is found."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from fetal_mri_segmentation_tpu.ops import patches as JP
from fetal_mri_segmentation_tpu_torch.ops import patches as P
from fetal_mri_segmentation_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def numpy_path(monkeypatch):
    """``get_patch_from_3d_data`` of the JAX package and of the port with
    the native loader off (``FETAL_TPU_NO_NATIVE=1``)."""
    def patch(data, shape, corner):
        with monkeypatch.context() as m:
            m.setenv("FETAL_TPU_NO_NATIVE", "1")
            return (JP.get_patch_from_3d_data(data, shape, corner),
                    P.get_patch_from_3d_data(data, shape, corner))
    return patch


def test_the_library_builds_and_loads():
    """This machine has a C++ compiler: the library is built from the
    port's source, into build/torch_native/, named by its hash."""
    assert native.compiler() is not None
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "torch_native"
    assert native.SOURCE == (ROOT / "fetal_mri_segmentation_tpu_torch"
                             / "native" / "fastloader.cpp")


@pytest.mark.parametrize("corner", [(0, 0, 0), (-2, 3, 8), (8, 8, 8),
                                    (-5, -5, -5), (10, 10, 10)])
def test_extract_patch_matches_numpy(corner, numpy_path):
    data = np.random.default_rng(0).random((2, 12, 12, 12)).astype(
        np.float32)
    got = native.extract_patch(data, (6, 6, 6), corner)
    for want in numpy_path(data, (6, 6, 6), corner):
        np.testing.assert_array_equal(got, want)
    # a 3-D volume through the hot path keeps its dimensions
    np.testing.assert_array_equal(
        P.get_patch_from_3d_data(data[1], (6, 6, 6), corner), got[1])


def test_extract_patches_batch(numpy_path):
    data = np.random.default_rng(1).random((1, 10, 10, 10)).astype(
        np.float32)
    corners = np.array([[0, 0, 0], [-2, 4, 4], [6, 6, 6]], np.int64)
    got = native.extract_patches_batch(data, (5, 5, 5), corners)
    assert got.shape == (3, 1, 5, 5, 5)
    for i, c in enumerate(corners):
        for want in numpy_path(data, (5, 5, 5), c):
            np.testing.assert_array_equal(got[i], want)


def test_overlap_add_matches_numpy():
    rng = np.random.default_rng(2)
    shape = (1, 12, 12, 12)
    acc = np.zeros(shape, np.float32)
    wsum = np.zeros(shape[1:], np.float32)
    w = P.gaussian_importance_map((6, 6, 6))
    patches, corners = [], P.compute_patch_indices(shape[1:], (6, 6, 6), 2)
    for c in corners:
        p = rng.random((1, 6, 6, 6)).astype(np.float32)
        patches.append(p)
        assert native.overlap_add(acc, wsum, p, w, c)
    want = JP.reconstruct_from_patches(patches, corners, shape, weight_map=w)
    covered = wsum > 0
    got = np.zeros(shape, np.float32)
    got[:, covered] = acc[:, covered] / wsum[covered]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_any_nonzero():
    z = np.zeros((4, 4, 4), np.float32)
    assert native.any_nonzero(z) is False
    z[1, 2, 3] = 0.5
    assert native.any_nonzero(z) is True


def test_one_hot_binding():
    truth = np.random.default_rng(3).integers(0, 4, 500).astype(np.float32)
    labels = np.array([1.0, 3.0], np.float64)
    out = np.empty((2, truth.size), np.float32)
    native._load().one_hot_f32(truth, out, labels, 2, truth.size)
    want = (truth[None] == labels[:, None].astype(np.float32)).astype(
        np.float32)
    np.testing.assert_array_equal(out, want)


def test_hot_path_uses_native_transparently(monkeypatch, numpy_path):
    """A contiguous float32 volume goes through the native copy and equals
    the numpy path; anything else stays on numpy."""
    data = np.random.default_rng(4).random((1, 16, 16, 16)).astype(
        np.float32)
    calls = []
    real = native.extract_patch
    monkeypatch.setattr(native, "extract_patch",
                        lambda *a: calls.append(1) or real(*a))
    got = P.get_patch_from_3d_data(data, (8, 8, 8), (-3, 2, 12))
    assert calls
    for want in numpy_path(data, (8, 8, 8), (-3, 2, 12)):
        np.testing.assert_array_equal(got, want)
    calls.clear()
    strided = data[:, ::2]
    P.get_patch_from_3d_data(strided, (4, 4, 4), (0, 0, 0))
    P.get_patch_from_3d_data(data.astype(np.float64), (4, 4, 4), (0, 0, 0))
    assert not calls


def test_wholly_outside_patch_is_zeros(monkeypatch):
    """Where the JAX numpy path returns a wrongly shaped patch, the native
    loader and the port's numpy path return zeros of the patch's shape."""
    data = np.random.default_rng(5).random((2, 12, 12, 12)).astype(
        np.float32)
    zeros = np.zeros((2, 6, 6, 6), np.float32)
    for corner in ((-8, -8, 9), (12, 0, 0), (0, -6, 0)):
        np.testing.assert_array_equal(
            native.extract_patch(data, (6, 6, 6), corner), zeros)
        np.testing.assert_array_equal(
            P.get_patch_from_3d_data(data, (6, 6, 6), corner), zeros)
        monkeypatch.setenv("FETAL_TPU_NO_NATIVE", "1")
        np.testing.assert_array_equal(
            P.get_patch_from_3d_data(data, (6, 6, 6), corner), zeros)
        monkeypatch.delenv("FETAL_TPU_NO_NATIVE")


_BUILD = r"""
import sys, time
from pathlib import Path
from fetal_mri_segmentation_tpu_torch.utils import native
native.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
print(native.build())
assert native.available()
"""


def test_two_processes_build_at_once(tmp_path):
    """Two processes that start the same build together each end with the
    one library of this source, whole, and leave no partial file."""
    start = time.time() + 2.0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path),
                               str(start)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outputs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outputs
    name = native.library_path().name
    assert {Path(o.strip().splitlines()[-1]).name for o in outputs} == {name}
    assert sorted(os.listdir(tmp_path)) == [name]


def test_another_source_gets_another_library(monkeypatch, tmp_path):
    """The file name hashes the source: a library built from another
    source is never the one loaded."""
    other = tmp_path / "fastloader.cpp"
    other.write_bytes(native.SOURCE.read_bytes() + b"\n// changed\n")
    here = native.library_path()
    monkeypatch.setattr(native, "SOURCE", other)
    assert native.library_path() != here
    assert native.library_path().parent == here.parent


def test_without_a_compiler_numpy_runs(monkeypatch, tmp_path):
    """No compiler and no built library: unavailable, every entry point
    returns None (``overlap_add`` False), and patches come from numpy."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "compiler", lambda: None)
    native._load.cache_clear()
    try:
        assert not native.available()
        data = np.ones((1, 4, 4, 4), np.float32)
        assert native.extract_patch(data, (2, 2, 2), (0, 0, 0)) is None
        assert native.any_nonzero(data) is None
        assert native.overlap_add(data, data[0], data, data[0],
                                  (0, 0, 0)) is False
        patch = P.get_patch_from_3d_data(data, (2, 2, 2), (1, 1, 1))
        assert patch.base is not None  # the numpy path's view
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            native.build()
    finally:
        native._load.cache_clear()
