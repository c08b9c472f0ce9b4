"""The port's device-resident case cache (``pipeline/device_cache.py``)
against the JAX package's, on the CPU: 5 synthetic cases of 16^3, 8^3
patches, inputs made from numpy seeds.

Exact (integers, copies of bits): the margins, the stacks that ``build``
makes (bf16 rounded as ``ml_dtypes`` rounds), the gather against
``get_patch_from_3d_data`` and against the JAX gather, the label
conversion, both index streams element for element, ``estimate_cache_
bytes``. Bit for bit within the port: the cached step against the host
step on the same batches (fp32 and bf16; the same ops on the same values),
``train_model`` with the cache against without, both resume tests. Against
the JAX cached step (fp32, fold off, augmentation off): parameters atol 1e-5
and loss / dice atol 1e-5 after 3 steps, the tolerance of
``tests/test_torch_train_step.py``.
"""

import csv
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.data import (  # noqa: E402
    open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.pipeline import device_cache as JC  # noqa: E402
from fetal_mri_segmentation_tpu.training import (  # noqa: E402
    create_train_state as jax_state)
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops.patches import (  # noqa: E402
    get_patch_from_3d_data)
from fetal_mri_segmentation_tpu_torch.pipeline import device_cache as TC  # noqa: E402
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (  # noqa: E402
    data_generator, get_training_and_validation_generators,
    get_validation_split)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.training.loop import train_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_eval_step, make_train_step, pad_batch)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    from_flax, init_flax_like)
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
PATCH, OFFSET = (8, 8, 8), (4, 4, 4)


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_devcache")
    files = write_synthetic_dataset(str(d / "nii"), n_cases=5,
                                    shape=(20, 20, 20))
    out = str(d / "data.h5")
    write_data_to_file(files, out, image_shape=(16, 16, 16),
                       normalize="per_volume", crop=False)
    f = open_data_file(out)
    yield f
    f.close()


def _blank_file(truth_value=0, dtype=np.uint8):
    root = SimpleNamespace(data=np.zeros((2, 1, 8, 8, 8), np.float32),
                           truth=np.full((2, 1, 8, 8, 8), truth_value, dtype))
    return SimpleNamespace(root=root)


def _cfg(tmp_path, cls=Config, **kw):
    base = dict(model_name="unet", depth=2, n_base_filters=2,
                image_shape=(16, 16, 16), patch_shape=PATCH,
                batch_size=3, validation_batch_size=3, n_epochs=1,
                compute_dtype="float32", fold_level0="off",
                training_patch_start_offset=OFFSET,
                validation_patch_overlap=2,
                training_file=str(tmp_path / "t.pkl"),
                validation_file=str(tmp_path / "v.pkl"),
                model_file=str(tmp_path / "model.ckpt"),
                training_log=str(tmp_path / "training.log"))
    base.update(kw)
    return cls(**base)


def _split(data_file, config, **kw):
    args = dict(overwrite=True, seed=0)
    args.update(kw)
    return get_validation_split(data_file, config.training_file,
                                config.validation_file, **args)


def _fresh(config, seed=0):
    model = build_model(config, "cpu")
    model.load_state_dict(from_flax(init_flax_like(config, seed=seed)))
    return model, create_train_state(model, config)


def _tight_budget(data_file):
    """Bytes that fit about 2/3 of the 5 cases in fp32."""
    est = TC.estimate_cache_bytes(
        data_file, 5, *TC.plan_margins((16, 16, 16), PATCH, 2, OFFSET),
        dtype_bytes=4)
    return est, int(est / 1.5)


# --- margins, stacks, gather, labels: exact -----------------------------------


@pytest.mark.parametrize("with_offset", [True, False])
def test_plan_margins_equal_jax(with_offset):
    rng = np.random.default_rng(0)
    for _ in range(25):
        shape = tuple(int(rng.integers(9, 40)) for _ in range(3))
        patch = tuple(int(rng.integers(4, min(12, min(shape))))
                      for _ in range(3))
        overlap = int(rng.integers(0, min(patch) - 1))
        offset = (tuple(int(rng.integers(0, p)) for p in patch)
                  if with_offset else None)
        got = TC.plan_margins(shape, patch, overlap, offset)
        assert got == JC.plan_margins(shape, patch, overlap, offset)
        assert all(isinstance(v, int) for side in got for v in side)
    if not with_offset:
        lo, _ = TC.plan_margins((15, 15, 15), PATCH, 0, None)
        assert all(v >= 1 for v in lo)  # the centered grid starts at -1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_equals_jax_stacks(data_file, dtype):
    lo, hi = TC.plan_margins((16, 16, 16), PATCH, 2, OFFSET)
    ids = [3, 0, 4]
    got = TC.DeviceCaseCache.build(
        data_file, ids, patch_shape=PATCH, margin_lo=lo, margin_hi=hi,
        dtype=getattr(torch, dtype), device="cpu", keep_host_truth=True)
    want = JC.DeviceCaseCache.build(
        data_file, ids, patch_shape=PATCH, margin_lo=lo, margin_hi=hi,
        dtype=getattr(jnp, dtype), keep_host_truth=True)
    np.testing.assert_array_equal(
        got.data_stack.float().numpy(),
        np.asarray(want.data_stack.astype(jnp.float32)))
    np.testing.assert_array_equal(got.truth_stack.numpy(),
                                  np.asarray(want.truth_stack))
    assert got.data_stack.dtype == getattr(torch, dtype)
    assert got.truth_stack.dtype == torch.uint8
    assert got.row_of == want.row_of and got.margin_lo == want.margin_lo
    assert got.nbytes == want.nbytes
    assert got.nbytes == TC.estimate_cache_bytes(
        data_file, 3, lo, hi, dtype_bytes=4 if dtype == "float32" else 2)
    assert TC.estimate_cache_bytes(data_file, 3, lo, hi, 2) == \
        JC.estimate_cache_bytes(data_file, 3, lo, hi, 2)
    for idx in ids:
        np.testing.assert_array_equal(got.host_truth[idx],
                                      want.host_truth[idx])
    # the margins hold zeros
    assert not got.data_stack[:, :, :lo[0]].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_equals_host_patch_extraction_and_jax(dtype):
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(2, 2, 10, 12, 9)).astype(np.float32)
    patch, lo, hi = (6, 6, 6), (6, 6, 6), (6, 6, 6)
    padded = np.pad(vol, [(0, 0), (0, 0)] + list(zip(lo, hi)))
    stack = torch.from_numpy(padded).to(getattr(torch, dtype))
    corners = np.array([[-3, 0, 2], [0, 8, -1], [5, 7, 4], [-6, -6, -6],
                        [4, 6, 3]], dtype=np.int32)
    rows = np.array([0, 1, 1, 0, 1], dtype=np.int32)
    got = TC.make_gather(patch, lo)(stack, torch.from_numpy(rows),
                                    torch.from_numpy(corners))
    assert got.shape == (5, 2, 6, 6, 6) and got.dtype == stack.dtype
    rounded = stack[:, :, 6:-6, 6:-6, 6:-6].float().numpy()
    for b in range(len(rows)):
        np.testing.assert_array_equal(
            got[b].float().numpy(),
            get_patch_from_3d_data(rounded[rows[b]], patch, corners[b]))
    want = JC.make_gather(patch, lo)(
        jnp.asarray(padded).astype(getattr(jnp, dtype)), jnp.asarray(rows),
        jnp.asarray(corners))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n_labels,labels", [(1, None), (3, (2, 5, 1)),
                                             (2, None)])
def test_convert_labels_device_equals_jax_and_host(n_labels, labels):
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        convert_data)

    truth = np.random.default_rng(4).integers(
        0, 6, size=(3, 1, 4, 4, 4)).astype(np.uint8)
    got = TC.convert_labels_device(torch.from_numpy(truth), n_labels, labels)
    want = JC.convert_labels_device(jnp.asarray(truth), n_labels, labels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, host = convert_data([np.zeros_like(truth[0], np.float32)] * 3,
                           [t.astype(np.float32) for t in truth],
                           n_labels=n_labels, labels=labels)
    np.testing.assert_array_equal(got.numpy(), host)


def test_non_integral_truth_rejected():
    with pytest.raises(ValueError, match="integral"):
        TC.DeviceCaseCache.build(
            _blank_file(0.5, np.float32), [0], patch_shape=(4, 4, 4),
            margin_lo=(2, 2, 2), margin_hi=(2, 2, 2), device="cpu")


# --- the index streams: element for element -----------------------------------


@pytest.mark.parametrize("shuffle,offset,overlap,skip_blank,skip_batches", [
    (True, OFFSET, 0, True, 0),     # the training stream
    (False, None, 2, True, 0),      # the validation stream
    (True, OFFSET, 0, True, 13),    # resumed mid-epoch, blank checks replayed
    (True, OFFSET, 0, False, 13),   # resumed, arithmetic fast-forward
    (False, None, 2, False, 5),
])
def test_index_stream_equals_jax(data_file, shuffle, offset, overlap,
                                 skip_blank, skip_batches):
    ids = [0, 1, 2, 3]
    row_of = {i: r for r, i in enumerate(ids)}
    kw = dict(batch_size=3, patch_shape=PATCH, patch_overlap=overlap,
              patch_start_offset=offset, shuffle_index_list=shuffle,
              skip_blank=skip_blank, seed=7, skip_batches=skip_batches)
    got = TC.index_batch_generator(data_file, ids, row_of, **kw)
    want = JC.index_batch_generator(data_file, ids, row_of, **kw)
    host = data_generator(data_file, ids, n_labels=1, **kw)
    for _ in range(12):  # crosses epoch boundaries and partial batches
        (rows, corners, n_valid), ref = next(got), next(want)
        assert rows.dtype == corners.dtype == np.int32
        np.testing.assert_array_equal(rows, ref[0])
        np.testing.assert_array_equal(corners, ref[1])
        assert n_valid == ref[2]
        # and the port's host pipeline emits the same patches
        xh, yh = next(host)
        assert n_valid == xh.shape[0]
        for b in range(n_valid):
            case = ids[int(rows[b])]
            np.testing.assert_array_equal(xh[b], get_patch_from_3d_data(
                np.asarray(data_file.root.data[case], np.float32), PATCH,
                corners[b]))


@pytest.mark.parametrize("resident,batch,offset,skip", [
    ([0, 2], 3, OFFSET, 0), ([0, 2], 3, OFFSET, 7),
    ([0], 5, None, 0),      # remainders 3 + 1 merge into one host batch
    ([0], 5, None, 6),      # a resume across that merged flush
])
def test_partial_index_stream_equals_jax(data_file, resident, batch, offset,
                                         skip):
    ids = [0, 1, 2]
    row_of = {c: r for r, c in enumerate(resident)}
    kw = dict(batch_size=batch, patch_shape=PATCH, patch_overlap=0,
              patch_start_offset=offset, skip_blank=False, seed=11,
              skip_batches=skip)
    got = TC.partial_index_batch_generator(data_file, ids, row_of, **kw)
    want = JC.partial_index_batch_generator(data_file, ids, row_of, **kw)
    kinds = []
    for _ in range(12):
        a, b = next(got), next(want)
        assert a[0] == b[0] and a[3] == b[3]
        kinds.append((a[0], a[3]))
        for x, y in zip(a[1:3], b[1:3]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert {k for k, _ in kinds} == {"idx", "host"}
    if batch == 5 and skip == 0:
        # 24 patches in 5 emissions per epoch, as the host generator's
        # ceil(24 / 5); the fifth is the merged trailing host batch
        assert kinds[4] == ("host", 4) and kinds[9] == ("host", 4)
        assert sum(n for _, n in kinds[:5]) == 24


@pytest.mark.parametrize("make", ["index", "partial"])
def test_index_stream_all_blank_raises(make):
    f = _blank_file()
    gen = (TC.index_batch_generator(f, [0, 1], {0: 0, 1: 1}, batch_size=2,
                                    patch_shape=(4, 4, 4), skip_blank=True)
           if make == "index" else
           TC.partial_index_batch_generator(f, [0, 1], {0: 0}, batch_size=2,
                                            patch_shape=(4, 4, 4),
                                            skip_blank=True))
    with pytest.raises(RuntimeError, match="no batches"):
        next(gen)
    with pytest.raises(ValueError, match="patch_shape"):
        next(TC.index_batch_generator(f, [0], {0: 0}))


# --- the cached step ----------------------------------------------------------


def _streams(data_file, ids, seed=11, **kw):
    args = dict(batch_size=3, patch_shape=PATCH, patch_overlap=0,
                patch_start_offset=OFFSET, shuffle_index_list=True,
                skip_blank=True, seed=seed)
    args.update(kw)
    n_labels, labels = args.pop("n_labels", 1), args.pop("labels", None)
    row_of = {i: r for r, i in enumerate(ids)}
    return (data_generator(data_file, ids, n_labels=n_labels, labels=labels,
                           **args),
            TC.index_batch_generator(data_file, ids, row_of, **args))


def _stage_like_the_loop(x, y, bs, bf16):
    x, y, n_valid = pad_batch(x, y, bs)
    x = torch.from_numpy(np.ascontiguousarray(x))
    return (x.bfloat16() if bf16 else x,
            torch.from_numpy(y.astype(np.uint8)), n_valid)


@pytest.mark.parametrize("compute_dtype,kw", [
    ("float32", {}), ("bfloat16", {}),
    ("float32", {"batch_normalization": True}),
    ("float32", {"n_labels": 3, "labels": (2, 5, 1),
                 "activation_name": "softmax"}),
])
def test_cached_step_equals_host_step_bitwise(data_file, tmp_path,
                                              compute_dtype, kw):
    """Train and eval: the same batches gathered on the device and staged
    from the host give the same x and y, losses and parameters, bit for
    bit (padded slots included: BatchNorm sees them)."""
    config = _cfg(tmp_path, compute_dtype=compute_dtype, augment=True,
                  flip=True, permute=True, contrast=0.1, **kw)
    ids = [0, 1, 2]
    multi = dict(n_labels=config.n_labels, labels=config.labels)
    source = data_file
    if config.n_labels > 1:
        # truth with several labels: the ellipsoid's voxels numbered by
        # octant
        t = np.asarray(data_file.root.truth[:]).copy()
        t[:, :, 8:] *= 2
        t[:, :, :, 8:] *= 5
        t[t == 10] = 1
        source = SimpleNamespace(root=SimpleNamespace(
            data=np.asarray(data_file.root.data[:]), truth=t))
    lo, hi = TC.plan_margins((16, 16, 16), PATCH, 0, OFFSET)
    dtype = getattr(torch, compute_dtype)
    cache = TC.DeviceCaseCache.build(source, ids, patch_shape=PATCH,
                                     margin_lo=lo, margin_hi=hi, dtype=dtype,
                                     device="cpu")
    host, idx = _streams(source, ids, **multi)
    (model_h, state_h), (model_c, state_c) = _fresh(config), _fresh(config)
    step_h = make_train_step(model_h, config,
                             generator=torch.Generator().manual_seed(5))
    step_c = TC.make_cached_train_step(
        model_c, config, cache.margin_lo,
        generator=torch.Generator().manual_seed(5))
    gather_convert = TC._make_gather_convert(config, cache.margin_lo)
    for i in range(6):
        x, y, n_valid = _stage_like_the_loop(*next(host), 3,
                                             compute_dtype == "bfloat16")
        rows, corners, n_valid_c = next(idx)
        assert n_valid_c == n_valid
        if i == 1 and n_valid == 3:
            # a ragged batch, as pad_batch leaves it: a zeroed tail
            n_valid = 2
            x[2:], y[2:] = 0, 0
        rows, corners = torch.from_numpy(rows), torch.from_numpy(corners)
        xc, yc = gather_convert(cache.data_stack, cache.truth_stack, rows,
                                corners, n_valid)
        assert xc.dtype == dtype and torch.equal(xc, x)
        assert torch.equal(yc, y.float())
        mh = step_h(state_h, x, y, n_valid)
        mc = step_c(state_c, cache.data_stack, cache.truth_stack, rows,
                    corners, n_valid)
        for k in mh:
            assert torch.equal(mh[k], mc[k]), k
    for (n, a), b in zip(model_h.state_dict().items(),
                         model_c.state_dict().values()):
        assert torch.equal(a, b), n
    ev_h = make_eval_step(model_h, config)
    ev_c = TC.make_cached_eval_step(model_c, config, cache.margin_lo)
    x, y, n_valid = _stage_like_the_loop(*next(host), 3,
                                         compute_dtype == "bfloat16")
    rows, corners, _ = next(idx)
    mh = ev_h(state_h, x, y, n_valid)
    mc = ev_c(state_c, cache.data_stack, cache.truth_stack,
              torch.from_numpy(rows), torch.from_numpy(corners), n_valid)
    assert torch.equal(mh["loss"], mc["loss"])


def test_cached_step_equals_jax_cached_step(data_file, tmp_path):
    """Three cached steps of each package from the same parameters on the
    same index batches (fp32, fold off, augmentation off)."""
    config = _cfg(tmp_path, augment=False, initial_learning_rate=1e-2,
                  n_base_filters=4)
    jcfg = _cfg(tmp_path, JaxConfig, augment=False,
                initial_learning_rate=1e-2, n_base_filters=4)
    ids = [0, 1, 2]
    lo, hi = TC.plan_margins((16, 16, 16), PATCH, 0, OFFSET)
    build = dict(patch_shape=PATCH, margin_lo=lo, margin_hi=hi)
    cache = TC.DeviceCaseCache.build(data_file, ids, dtype=torch.float32,
                                     device="cpu", **build)
    jcache = JC.DeviceCaseCache.build(data_file, ids, dtype=jnp.float32,
                                      **build)
    jmodel = jax_build(jcfg)
    js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0))
    model = build_model(config, "cpu")
    model.load_state_dict(from_flax(flatten_dict(js.params, sep="/")))
    state = create_train_state(model, config)
    jstep = JC.make_cached_train_step(jmodel, jcfg, lo)
    step = TC.make_cached_train_step(model, config, lo)
    _, idx = _streams(data_file, ids)
    saw_partial = False
    for i in range(3):
        rows, corners, n_valid = next(idx) if i else (
            np.array([0, 1, 0], np.int32),
            np.array([[0, 0, 0], [4, 4, 4], [0, 0, 0]], np.int32), 2)
        saw_partial |= n_valid < 3
        js, jm = jstep(js, jcache.data_stack, jcache.truth_stack,
                       jnp.asarray(rows), jnp.asarray(corners),
                       jax.random.PRNGKey(i), n_valid)
        m = step(state, cache.data_stack, cache.truth_stack,
                 torch.from_numpy(rows), torch.from_numpy(corners), n_valid)
        for k in ("loss", "dice"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5)
    assert saw_partial
    want = from_flax(flatten_dict(js.params, sep="/"))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


# --- the auto decision --------------------------------------------------------


def test_maybe_build_gating(data_file, tmp_path, monkeypatch, capsys):
    config = _cfg(tmp_path)
    _split(data_file, config)
    config.device_case_cache = "off"
    assert TC.maybe_build_device_cache(data_file, config,
                                       device="cpu") is None
    config.device_case_cache = "auto"
    # a spatial mesh keeps host staging, whatever the knob
    mesh = SimpleNamespace(size=4, rank=0, device=torch.device("cpu"),
                           axis_names=("data", "spatial"))
    for knob in ("auto", "on"):
        config.device_case_cache = knob
        assert TC.maybe_build_device_cache(data_file, config, mesh=mesh,
                                           verbose=True) is None
    assert "spatial/hybrid mesh" in capsys.readouterr().out
    config.device_case_cache = "auto"
    # the budget exceeded in auto: None, and it says why
    monkeypatch.setattr(TC, "AUTO_BUDGET_BYTES", 10)
    assert TC.maybe_build_device_cache(data_file, config, device="cpu",
                                       verbose=True) is None
    assert "keeping host staging" in capsys.readouterr().out
    # "on" skips the budget check
    config.device_case_cache = "on"
    assert TC.maybe_build_device_cache(data_file, config,
                                       device="cpu") is not None
    monkeypatch.undo()
    config.device_case_cache = "auto"
    cache, tg, vg = TC.maybe_build_device_cache(data_file, config,
                                                device="cpu", verbose=True)
    assert "5 cases resident on cpu" in capsys.readouterr().out
    assert not cache.partial and cache.resident_cases == [0, 1, 2, 3, 4]
    assert cache.host_truth is not None and len(cache.host_truth) == 5
    rows, corners, n_valid = next(tg)
    assert rows.shape == (3,) and corners.shape == (3, 3)
    assert len(next(vg)) == 3
    # a data mesh builds the whole stacks on the rank's device; partial
    # mode is refused there
    dp = SimpleNamespace(size=2, rank=1, device=torch.device("cpu"),
                         axis_names=("data",))
    out = TC.maybe_build_device_cache(data_file, config, mesh=dp)
    assert out is not None and not out[0].partial
    _, tight = _tight_budget(data_file)
    assert TC.maybe_build_device_cache(data_file, config, mesh=dp,
                                       budget_bytes=tight,
                                       verbose=True) is None
    assert "data-parallel mesh" in capsys.readouterr().out


def test_knob_validation_and_skip_reasons(data_file, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="device_case_cache"):
        _cfg(tmp_path, device_case_cache="On")
    config = _cfg(tmp_path)
    config.device_case_cache = "sometimes"
    with pytest.raises(ValueError, match="must be 'auto', 'on' or 'off'"):
        TC.maybe_build_device_cache(data_file, config, device="cpu")
    # missing split pickles: auto -> None, on -> a clear error
    config = _cfg(tmp_path)
    assert not os.path.exists(config.training_file)
    assert TC.maybe_build_device_cache(data_file, config,
                                       device="cpu") is None
    config.device_case_cache = "on"
    with pytest.raises(ValueError, match="split pickles"):
        TC.maybe_build_device_cache(data_file, config, device="cpu")
    # whole-volume training has no patch gather
    for knob, cls in (("on", JaxConfig), ("on", Config)):
        whole = cls(patch_shape=None, device_case_cache=knob)
        mod = JC if cls is JaxConfig else TC
        with pytest.raises(ValueError, match="patch_shape"):
            mod.maybe_build_device_cache(None, whole)
    assert TC.maybe_build_device_cache(
        None, Config(patch_shape=None, device_case_cache="auto")) is None
    # a failed upload in auto falls back; "on" raises with the cause
    config = _cfg(tmp_path)
    _split(data_file, config)

    def boom(*a, **kw):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(TC.DeviceCaseCache, "build", boom)
    assert TC.maybe_build_device_cache(data_file, config,
                                       device="cpu") is None
    config.device_case_cache = "on"
    with pytest.raises(ValueError, match="CUDA out of memory"):
        TC.maybe_build_device_cache(data_file, config, device="cpu")
    monkeypatch.undo()
    # non-integral truth is a skip reason too
    bad = _blank_file(0.5, np.float32)
    small = _cfg(tmp_path, image_shape=(8, 8, 8), patch_shape=(4, 4, 4),
                 training_patch_start_offset=None, device_case_cache="on")
    from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_dump
    pickle_dump([0], small.training_file)
    pickle_dump([1], small.validation_file)
    with pytest.raises(ValueError, match="integral"):
        TC.maybe_build_device_cache(bad, small, device="cpu")
    # a CUDA device on a machine without one raises: no quiet move to the
    # CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TC.maybe_build_device_cache(data_file, config)


def test_hbm_budget_bytes(monkeypatch):
    calls = []

    def mem_get_info(device=None):
        calls.append(device)
        return 10 << 30, 80 << 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 3 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d=None: 1 << 30)
    monkeypatch.setattr(TC, "HBM_STEP_RESERVE_BYTES", 4 << 30)
    free = 12 << 30  # mem_get_info's free plus the allocator's unused
    assert TC.hbm_budget_bytes("cuda:0") == int(0.8 * free) - (4 << 30)
    assert calls == ["cuda:0"]
    assert TC.hbm_budget_bytes("cuda", reserve=0) == int(0.8 * free)
    assert TC.hbm_budget_bytes("cuda", safety=0.5, reserve=0) == free // 2
    assert TC.hbm_budget_bytes("cuda", reserve=100 << 30) == 0
    # a CPU device has no allocator to ask: the static fallback, patchable
    assert TC.hbm_budget_bytes("cpu", fallback=123) == 123
    monkeypatch.setattr(TC, "AUTO_BUDGET_BYTES", 77)
    assert TC.hbm_budget_bytes("cpu") == TC.hbm_budget_bytes(None) == 77
    assert len(calls) == 4
    # the reserve is the port's own, not the JAX module's TPU figure
    monkeypatch.undo()
    assert TC.HBM_STEP_RESERVE_BYTES > JC.HBM_STEP_RESERVE_BYTES


# --- through train_model ------------------------------------------------------


def _generators(data_file, config, seed=3, overwrite=True, start_epoch=0):
    return get_training_and_validation_generators(
        data_file, batch_size=config.batch_size, n_labels=1,
        training_keys_file=config.training_file,
        validation_keys_file=config.validation_file, data_split=0.8,
        overwrite=overwrite, patch_shape=config.patch_shape,
        validation_batch_size=config.validation_batch_size,
        validation_patch_overlap=config.validation_patch_overlap,
        training_patch_start_offset=config.training_patch_start_offset,
        skip_blank=config.skip_blank, seed=seed, start_epoch=start_epoch)


def _metric_rows(path):
    with open(path) as f:
        return {r["epoch"]: [r[c] for c in (
            "dice_coefficient", "val_dice_coefficient", "loss", "val_loss",
            "lr")] for r in csv.DictReader(f)}  # the last row of an epoch wins


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_model_with_device_cache(data_file, tmp_path, compute_dtype):
    """Two epochs through ``train_model`` with the cached pipeline equal
    the host pipeline's: the same log and the same final parameters."""
    results = {}
    for mode in ("host", "cache"):
        sub = tmp_path / mode
        sub.mkdir()
        config = _cfg(sub, n_epochs=2, compute_dtype=compute_dtype,
                      augment=True, flip=True, permute=True, contrast=0.1)
        tg, n_t, vg, n_v = _generators(data_file, config)
        model, state = _fresh(config)
        cache = None
        if mode == "cache":
            cache, tg, vg = TC.maybe_build_device_cache(
                data_file, config, seed=3, device="cpu")
            assert cache.data_stack.dtype == getattr(torch, compute_dtype)
        state = train_model(model, state, config, tg, vg, n_t, n_v, seed=3,
                            device_cache=cache, verbose=False)
        results[mode] = (model.state_dict(), _metric_rows(
            config.training_log))
        assert CheckpointIO(config.model_file).peek_data_order() == {
            "mode": "lockstep"}
    assert results["host"][1] == results["cache"][1]
    for (n, a), b in zip(results["host"][0].items(),
                         results["cache"][0].values()):
        assert torch.equal(a, b), n


def test_partial_cache_engages_and_covers_epoch(data_file, tmp_path, capsys):
    """A dataset 1.5x over the budget: most cases resident, the epoch's
    multiset of (case, corner) equal to the host pipeline's, and fewer than
    half of the patches uploaded."""
    config = _cfg(tmp_path, skip_blank=False)
    _split(data_file, config, data_split=0.8)
    est, tight = _tight_budget(data_file)
    cache, tg, vg = TC.maybe_build_device_cache(
        data_file, config, budget_bytes=tight, verbose=True, device="cpu")
    assert "PARTIAL cache" in capsys.readouterr().out
    assert cache.partial and 2 <= len(cache.row_of) < 5
    assert cache.n_total_cases == 5 and cache.host_truth is None
    training_list = [int(i) for i in pickle_load(config.training_file)]
    assert cache.resident_cases == sorted(training_list[:len(cache.row_of)])
    # the JAX package decides the same resident set for the same budget
    jcache, _, _ = JC.maybe_build_device_cache(data_file, config,
                                               budget_bytes=tight)
    assert jcache.resident_cases == cache.resident_cases

    # the host pipeline's epoch, as (case, corner) pairs: the full index
    # stream (held equal to data_generator above) on the same split and seed
    full_row_of = {c: r for r, c in enumerate(sorted(training_list))}
    ref = TC.index_batch_generator(
        data_file, training_list, full_row_of, batch_size=3,
        patch_shape=PATCH, patch_overlap=0, patch_start_offset=OFFSET,
        skip_blank=False, seed=0)
    case_of = {r: c for c, r in full_row_of.items()}
    want = []
    while True:
        rows, corners, n_valid = next(ref)
        want += [(case_of[int(r)], tuple(map(int, c)))
                 for r, c in zip(rows[:n_valid], corners[:n_valid])]
        if n_valid < 3:
            break
    resident_of = {r: c for c, r in cache.row_of.items()}
    cases = {c: np.asarray(data_file.root.data[c], np.float32)
             for c in training_list}
    got, uploaded = [], 0
    while len(got) + uploaded < len(want):
        kind, a, b, n_valid = next(tg)
        if kind == "idx":
            got += [(resident_of[int(r)], tuple(map(int, c)))
                    for r, c in zip(a[:n_valid], b[:n_valid])]
        else:
            assert a.shape[1:] == b.shape[1:] == (1, 8, 8, 8)
            uploaded += n_valid
    assert len(got) + uploaded == len(want)
    assert sorted(got) == sorted(p for p in want if p[0] in cache.row_of)
    assert uploaded == sum(p[0] not in cache.row_of for p in want)
    assert uploaded < len(want) / 2
    del cases


def test_partial_cache_train_model_end_to_end(data_file, tmp_path):
    """The tagged pipeline (both step kinds) through ``train_model``:
    deterministic, and the sidecar records the resident set."""
    def run(tag):
        d = tmp_path / tag
        d.mkdir()
        config = _cfg(d, n_epochs=2, skip_blank=False)
        _split(data_file, config, data_split=0.8)
        _, tight = _tight_budget(data_file)
        cache, tg, vg = TC.maybe_build_device_cache(
            data_file, config, budget_bytes=tight, device="cpu")
        assert cache.partial
        model, state = _fresh(config)
        # 4 cases x 8 patches / 3 -> 11 steps; 1 validation case -> 4
        train_model(model, state, config, tg, vg, 11, 4, seed=0,
                    verbose=False, device_cache=cache)
        rows = _metric_rows(config.training_log)
        assert len(rows) == 2 and all(
            np.isfinite(float(v)) for r in rows.values() for v in r)
        assert CheckpointIO(config.model_file).peek_data_order() == {
            "mode": "partial", "resident": cache.resident_cases}
        return rows, model.state_dict()

    (rows_a, sd_a), (rows_b, sd_b) = run("a"), run("b")
    assert rows_a == rows_b
    for (n, a), b in zip(sd_a.items(), sd_b.values()):
        assert torch.equal(a, b), n


def test_resume_data_order_pins_cache_mode(data_file, tmp_path):
    config = _cfg(tmp_path, skip_blank=False)
    _split(data_file, config, data_split=0.8)
    est, tight = _tight_budget(data_file)
    build = lambda **kw: TC.maybe_build_device_cache(  # noqa: E731
        data_file, config, device="cpu", **kw)
    # lockstep recorded, less memory now: partial would regroup -> host
    assert build(budget_bytes=tight,
                 resume_data_order={"mode": "lockstep"}) is None
    # partial recorded: that resident set again, even when everything fits
    first = build(budget_bytes=tight)
    assert first[0].partial
    resident = first[0].resident_cases
    again = build(budget_bytes=est * 10,
                  resume_data_order={"mode": "partial", "resident": resident})
    assert again[0].partial and again[0].resident_cases == sorted(resident)
    # what cannot be reproduced fails loudly
    with pytest.raises(RuntimeError, match="exact-resume violation"):
        build(budget_bytes=tight, resume_data_order={
            "mode": "partial", "resident": [999, 1000]})
    with pytest.raises(RuntimeError, match="multi-device mesh"):
        TC.maybe_build_device_cache(
            data_file, config, resume_data_order={
                "mode": "partial", "resident": resident},
            mesh=SimpleNamespace(size=2, rank=0, axis_names=("data",),
                                 device=torch.device("cpu")))
    for knob in ("off", "on"):
        config.device_case_cache = knob
        with pytest.raises(RuntimeError, match="exact-resume violation"):
            build(resume_data_order={"mode": "partial",
                                     "resident": resident})
    config.device_case_cache = "auto"
    assert build(budget_bytes=tight, resume_data_order=None)[0].partial


def test_cached_resume_bitwise_identical(data_file, tmp_path):
    """Interrupted after 1 epoch and resumed to 3 (``train.py``'s wiring:
    ``peek_epoch`` -> epoch * steps into ``maybe_build_device_cache``), the
    log equals an uninterrupted cached run's."""
    def run(sub, n_epochs, resume=False):
        config = _cfg(sub, n_epochs=n_epochs, augment=True, flip=True,
                      contrast=0.1)
        start = ((CheckpointIO(config.model_file).peek_epoch() or 0)
                 if resume else 0)
        tg, n_t, vg, n_v = _generators(data_file, config,
                                       overwrite=not resume,
                                       start_epoch=start)
        model, state = _fresh(config)
        cache, tg, vg = TC.maybe_build_device_cache(
            data_file, config, seed=3, device="cpu",
            train_skip_batches=start * n_t, val_skip_batches=start * n_v)
        train_model(model, state, config, tg, vg, n_t, n_v, seed=3,
                    device_cache=cache, verbose=False)
        return config.training_log

    (tmp_path / "cont").mkdir()
    (tmp_path / "res").mkdir()
    log_c = run(tmp_path / "cont", 3)
    run(tmp_path / "res", 1)
    log_r = run(tmp_path / "res", 3, resume=True)
    rows_c, rows_r = _metric_rows(log_c), _metric_rows(log_r)
    assert set(rows_c) == set(rows_r) == {"0", "1", "2"}
    for e in sorted(rows_c):
        assert rows_c[e] == rows_r[e], f"epoch {e} diverged"


def test_partial_cache_resume_bitwise_identical(data_file, tmp_path):
    """A PARTIAL-cache run interrupted at 2 epochs and resumed to 4 logs
    what an uninterrupted one logs. The resume is offered a budget that
    fits the whole dataset: only the recorded data order keeps the partial
    grouping, and with it the replayed batch sequence."""
    est, tight = _tight_budget(data_file)

    def run(tag, n_epochs, budget, resume=False):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        config = _cfg(d, n_epochs=n_epochs, skip_blank=False,
                      training_file=str(tmp_path / "t.pkl"),
                      validation_file=str(tmp_path / "v.pkl"))
        _split(data_file, config, overwrite=False, data_split=0.8)
        start, order = 0, None
        if resume:
            io = CheckpointIO(config.model_file)
            start = io.peek_epoch() or 0
            order = io.peek_data_order() or {"mode": "lockstep"}
            assert start > 0 and order["mode"] == "partial"
        cache, tg, vg = TC.maybe_build_device_cache(
            data_file, config, budget_bytes=budget, device="cpu",
            train_skip_batches=start * 11, val_skip_batches=start * 4,
            resume_data_order=order)
        assert cache.partial
        model, state = _fresh(config)
        train_model(model, state, config, tg, vg, 11, 4, seed=0,
                    verbose=False, device_cache=cache)
        return config

    cfg_c = run("uninterrupted", 4, tight)
    run("interrupted", 2, tight)
    cfg_r = run("interrupted", 4, est * 10, resume=True)
    cont, res = (_metric_rows(cfg_c.training_log),
                 _metric_rows(cfg_r.training_log))
    assert set(cont) == set(res) == {"0", "1", "2", "3"}
    for e in sorted(cont):
        assert cont[e] == res[e], f"epoch {e} diverged"
