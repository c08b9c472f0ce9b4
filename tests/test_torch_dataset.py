"""The port's dataset builder and reader against the JAX package's.

The same synthetic NIfTI cases go through ``fetal_mri_segmentation_tpu.data.
write_data_to_file`` (HDF5, h5py) and the port's (a directory of ``.npy``
memory maps and ``meta.json``), for every normalization mode: data, truth,
affine, ``subject_ids`` and the ``global`` moments must be EQUAL (the
passes are copies: the same float32 operations in the same order, atol 0).
Then the converter's round trip, the port's reader on the HDF5 file,
``load_global_moments`` from both formats, and the generators' batches from
either file for one seed (equal). The storage passes are also held equal to
their originals on a random array.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from fetal_mri_segmentation_tpu.data import (  # noqa: E402
    normalize as jax_normalize, open_data_file as jax_open,
    write_data_to_file as jax_write)
from fetal_mri_segmentation_tpu.inference.predict import (  # noqa: E402
    load_global_moments as jax_moments)
from fetal_mri_segmentation_tpu_torch.data import (  # noqa: E402
    build as port_build, normalize as port_normalize)
from fetal_mri_segmentation_tpu_torch.data.memory import (  # noqa: E402
    InMemoryDataFile)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    load_global_moments)
from fetal_mri_segmentation_tpu_torch.pipeline import (  # noqa: E402
    generator as TG)
from tests.synthetic import write_synthetic_dataset  # noqa: E402

MODES = [None, "per_volume", "global", "windowed"]
SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dataset")
    files = write_synthetic_dataset(str(d / "nii"), n_cases=4,
                                    shape=(20, 22, 18),
                                    modalities=("t2", "adc"))
    ids = [os.path.basename(os.path.dirname(f[0])) for f in files]
    return d, files, ids


@pytest.fixture(scope="module")
def built(cases):
    """Every mode built by both packages: {mode: (hdf5 path, directory)}."""
    d, files, ids = cases
    out = {}
    for mode in MODES:
        h5 = jax_write(files, str(d / f"jax_{mode}.h5"), image_shape=SHAPE,
                       subject_ids=ids, normalize=mode)
        native = port_build.write_data_to_file(
            files, str(d / f"port_{mode}"), image_shape=SHAPE,
            subject_ids=ids, normalize=mode)
        out[mode] = (h5, native)
    return out


def _assert_same_dataset(port, ref):
    np.testing.assert_array_equal(np.asarray(port.root.data),
                                  ref.root.data[:])
    np.testing.assert_array_equal(np.asarray(port.root.truth),
                                  ref.root.truth[:])
    np.testing.assert_array_equal(np.asarray(port.root.affine),
                                  ref.root.affine[:])
    assert port.root.data.dtype == np.float32
    assert port.root.truth.dtype == ref.root.truth.dtype == np.uint8
    assert port.root.affine.dtype == np.float64
    assert len(port) == len(ref)


@pytest.mark.parametrize("mode", MODES)
def test_builder_matches_jax(cases, built, mode):
    _, _, ids = cases
    h5, native = built[mode]
    assert os.path.isdir(native)
    assert sorted(os.listdir(native)) == ["affine.npy", "data.npy",
                                          "meta.json", "truth.npy"]
    with port_build.open_data_file(native) as port, jax_open(h5) as ref:
        _assert_same_dataset(port, ref)
        assert port.filename == native
        assert port.subject_ids == ids
        assert [str(s) for s in port.root.subject_ids] == ids
        assert port.normalization == mode
        assert port.normalization == ref._h5.attrs.get("normalization")
        if mode == "global":
            mean, std = port.global_moments
            np.testing.assert_array_equal(mean, ref._h5.attrs["norm_mean"])
            np.testing.assert_array_equal(std, ref._h5.attrs["norm_std"])
            assert mean.shape == (2,) and mean.dtype == np.float64
        else:
            assert port.global_moments is None
            assert "norm_mean" not in ref._h5.attrs
    with open(os.path.join(native, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format_version"] == port_build.FORMAT_VERSION
    assert meta["normalization"] == mode


@pytest.mark.parametrize("mode", MODES)
def test_port_reads_the_jax_hdf5(built, mode):
    """A file opens as the JAX package's HDF5 (h5py is installed here):
    the same arrays and the format-neutral accessors."""
    h5, native = built[mode]
    with port_build.open_data_file(h5) as via_h5, \
            port_build.open_data_file(native) as port:
        np.testing.assert_array_equal(via_h5.root.data[:],
                                      np.asarray(port.root.data))
        np.testing.assert_array_equal(via_h5.root.truth[:],
                                      np.asarray(port.root.truth))
        assert via_h5.subject_ids == port.subject_ids
        assert via_h5.normalization == port.normalization
        if mode == "global":
            for a, b in zip(via_h5.global_moments, port.global_moments):
                np.testing.assert_array_equal(a, b)
        else:
            assert via_h5.global_moments is None


@pytest.mark.parametrize("mode", ["global", "per_volume"])
def test_converter_round_trip(built, tmp_path, mode):
    h5, native = built[mode]
    out = str(tmp_path / "converted")
    r = subprocess.run(
        [sys.executable, "-m", "fetal_mri_segmentation_tpu_torch.data.build",
         "--convert", h5, out], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr
    assert "wrote 4 cases" in r.stdout
    with port_build.open_data_file(out) as conv, \
            port_build.open_data_file(native) as port, jax_open(h5) as ref:
        _assert_same_dataset(conv, ref)
        assert conv.subject_ids == port.subject_ids
        assert conv.normalization == mode
        if mode == "global":
            for a, b in zip(conv.global_moments, port.global_moments):
                np.testing.assert_array_equal(a, b)
    for name in ("data", "truth", "affine"):
        assert (open(os.path.join(out, name + ".npy"), "rb").read()
                == open(os.path.join(native, name + ".npy"), "rb").read())


def test_load_global_moments_from_both_formats(built, tmp_path):
    h5, native = built["global"]
    want = jax_moments(h5)
    for path in (h5, native):
        mean, std = load_global_moments(path)
        np.testing.assert_array_equal(mean, want[0])
        np.testing.assert_array_equal(std, want[1])
    for mode in (None, "per_volume"):
        assert load_global_moments(built[mode][1]) is None
        assert load_global_moments(built[mode][0]) is None
    assert load_global_moments(str(tmp_path / "absent")) is None
    assert jax_moments(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("mode", ["per_volume", "global"])
def test_generators_give_the_same_batches_from_either_file(built, tmp_path,
                                                           mode):
    h5, native = built[mode]

    def batches(data_file, tag):
        tg, n_t, vg, n_v = TG.get_training_and_validation_generators(
            data_file, batch_size=3, n_labels=1,
            training_keys_file=str(tmp_path / f"t_{tag}.pkl"),
            validation_keys_file=str(tmp_path / f"v_{tag}.pkl"),
            data_split=0.75, overwrite=True, patch_shape=(8, 8, 8),
            validation_batch_size=3, validation_patch_overlap=2,
            training_patch_start_offset=(2, 2, 2), skip_blank=True, seed=3)
        return ([next(tg) for _ in range(n_t + 1)],
                [next(vg) for _ in range(n_v)], n_t, n_v)

    with port_build.open_data_file(native) as port, jax_open(h5) as ref:
        got = batches(port, "port")
        want = batches(ref, "jax")
    assert got[2:] == want[2:] and got[2] > 0 and got[3] > 0
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_in_memory_file_matches_the_native_dataset(cases, built):
    """``InMemoryDataFile.from_cases`` (kept for the tests) preprocesses
    like the builder: atol 1e-5 on the data (sums in another order), truth
    equal."""
    from fetal_mri_segmentation_tpu_torch.config import Config
    _, files, _ = cases
    cfg = Config(image_shape=SHAPE, training_modalities=("t2", "adc"),
                 all_modalities=("t2", "adc"))
    mem = InMemoryDataFile.from_cases(
        [os.path.dirname(f[0]) for f in files], cfg)
    with port_build.open_data_file(built["per_volume"][1]) as port:
        np.testing.assert_allclose(mem.root.data, np.asarray(port.root.data),
                                   atol=1e-5)
        np.testing.assert_array_equal(mem.root.truth,
                                      np.asarray(port.root.truth))


@pytest.mark.parametrize("name", [
    "normalize_data_storage", "normalize_data_storage_per_volume",
    "normalize_data_storage_windowed"])
def test_storage_pass_equals_original(name):
    rng = np.random.default_rng(5)
    base = rng.normal(40.0, 12.0, (3, 2, 6, 7, 5)).astype(np.float32)
    base[1, 0] = 7.0  # a constant channel: std 0 must not divide
    got, want = base.copy(), base.copy()
    r_got = getattr(port_normalize, name)(got)
    r_want = getattr(jax_normalize, name)(want)
    np.testing.assert_array_equal(got, want)
    if name == "normalize_data_storage":
        for a, b in zip(r_got, r_want):
            np.testing.assert_array_equal(a, b)
    else:
        assert r_got is None and r_want is None


def test_builder_refuses_an_unknown_mode_like_jax(cases, tmp_path):
    _, files, _ = cases
    for write, out in ((jax_write, "a.h5"), (port_build.write_data_to_file,
                                             "a")):
        with pytest.raises(ValueError, match="per_volume"):
            write(files, str(tmp_path / out), image_shape=SHAPE,
                  normalize="per-volume")


def test_reader_errors_name_the_way_out(cases, built, tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="no dataset"):
        port_build.open_data_file(str(tmp_path / "absent"))
    (tmp_path / "half").mkdir()
    with pytest.raises(FileNotFoundError, match="meta.json"):
        port_build.open_data_file(str(tmp_path / "half"))
    # where h5py is absent, a file raises and names the converter
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="--convert"):
        port_build.open_data_file(built[None][0])


def test_reader_refuses_a_blosc_dataset(tmp_path):
    """A dataset whose filter pipeline holds blosc (id 32001, the PyTables
    reference format) is refused with a pointer to the converter; the
    filter need not be registered to declare it."""
    import h5py
    path = str(tmp_path / "blosc.h5")
    with h5py.File(path, "w") as f:
        for name, shape, dtype in (("data", (1, 1, 4, 4, 4), "f4"),
                                   ("truth", (1, 1, 4, 4, 4), "u1"),
                                   ("affine", (1, 4, 4), "f8")):
            space = h5py.h5s.create_simple(shape)
            plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            plist.set_chunk(shape)
            if name == "data":
                plist.set_filter(32001, h5py.h5z.FLAG_OPTIONAL,
                                 (2, 2, 4, 256, 5, 1, 0))
            h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(dtype),
                            space, dcpl=plist)
    with pytest.raises(RuntimeError, match="convert_reference_h5"):
        port_build.open_data_file(path)


def test_data_file_surface(built):
    _, native = built["per_volume"]
    f = port_build.open_data_file(native)
    assert len(f) == 4 and f.root.data.shape == (4, 2) + SHAPE
    with pytest.raises(AttributeError):
        f.root.nothing
    with pytest.raises(ValueError):  # opened read-only
        f.root.data[0, 0, 0, 0, 0] = 1.0
    f.close()
    f.close()  # idempotent
    rw = port_build.open_data_file(native, "r+")
    assert rw.root.data.flags.writeable
    rw.close()
