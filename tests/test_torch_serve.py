"""The port's watch-directory server (``inference/serve.py``) on the CPU:
the cases of ``tests/test_serve.py`` that need no JAX (once and
idempotent, the stability guard, quarantine and retry, collisions, pruned
state, the stats file, write failures, pipelined against serial, device
preprocessing), then ``python -m fetal_mri_segmentation_tpu_torch.serve``'s
``main`` against the root ``serve.py``'s on the same synthetic NIfTI cases
and weights: identical label maps except voxels within 1e-3 of the
threshold."""

import importlib.util
import json
import os
import shutil
import signal
import threading
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu_torch import serve as port_serve  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.inference import (  # noqa: E402
    predict as predict_mod)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    make_device_preprocessor, predict_case)
from fetal_mri_segmentation_tpu_torch.inference.serve import (  # noqa: E402
    discover_cases, watch_and_predict)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _setup(tmp_path, n_cases=2, shape=(24, 24, 24)):
    write_synthetic_dataset(str(tmp_path / "watch"), n_cases=n_cases,
                            shape=shape)
    cfg = Config(image_shape=(24, 24, 24), patch_shape=(16, 16, 16),
                 depth=3, n_base_filters=4, compute_dtype="float32")
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    return cfg, model, SlidingWindowPredictor(model, cfg, cfg.image_shape,
                                              overlap=4)


class Sweeps:
    """A stop flag that is set at the n-th check (one check per sweep)."""

    def __init__(self, n, before=None):
        self.n, self.calls, self.before = n, 0, before

    def is_set(self):
        self.calls += 1
        if self.before:
            self.before(self.calls)
        return self.calls >= self.n


def _serve(tmp_path, cfg, predictor, **kw):
    kw.setdefault("once", True)
    return watch_and_predict(str(tmp_path / "watch"),
                             str(kw.pop("out", tmp_path / "served")), cfg,
                             predictor, verbose=False, **kw)


def _pred(out, name):
    return load_nifti(os.path.join(out, name, "prediction.nii.gz")
                      ).get_fdata()


def test_discover_cases(tmp_path):
    cfg, *_ = _setup(tmp_path)
    assert sorted(discover_cases(str(tmp_path / "watch"), cfg)) == [
        "case_0", "case_1"]
    os.makedirs(tmp_path / "watch" / "half")
    assert "half" not in discover_cases(str(tmp_path / "watch"), cfg)
    shutil.copy(tmp_path / "watch" / "case_0" / "volume.nii.gz",
                tmp_path / "watch" / "extra.nii.gz")
    assert "extra" in discover_cases(str(tmp_path / "watch"), cfg)


def test_serve_once_idempotent_and_incremental(tmp_path):
    cfg, _, predictor = _setup(tmp_path)
    out = str(tmp_path / "served")
    assert _serve(tmp_path, cfg, predictor) == 2
    assert os.path.exists(os.path.join(out, "case_0", "prediction.nii.gz"))
    assert _serve(tmp_path, cfg, predictor) == 0
    write_synthetic_dataset(str(tmp_path / "more"), n_cases=3,
                            shape=(24, 24, 24))
    shutil.copytree(tmp_path / "more" / "case_2",
                    tmp_path / "watch" / "case_2")
    assert _serve(tmp_path, cfg, predictor) == 1
    assert os.path.exists(os.path.join(out, "case_2", "prediction.nii.gz"))


def test_serve_defers_until_files_stable(tmp_path):
    cfg, _, predictor = _setup(tmp_path, n_cases=1)
    stop = threading.Event()
    stop.set()  # one sweep per call
    for _ in range(2):  # a fresh call starts a fresh signature cache
        assert _serve(tmp_path, cfg, predictor, once=False, stop=stop,
                      poll_interval=0.01) == 0
    assert _serve(tmp_path, cfg, predictor, once=False, stop=Sweeps(2),
                  poll_interval=0.01) == 1


def test_serve_quarantines_bad_case_and_retries_on_change(tmp_path):
    cfg, _, predictor = _setup(tmp_path, n_cases=1)
    out = tmp_path / "served"
    bad = tmp_path / "watch" / "bad"
    bad.mkdir()
    (bad / "volume.nii.gz").write_bytes(b"not a nifti")
    assert _serve(tmp_path, cfg, predictor) == 1
    assert not (out / "bad" / "prediction.nii.gz").exists()
    shutil.rmtree(out / "case_0")
    assert _serve(tmp_path, cfg, predictor, once=False, stop=Sweeps(3),
                  poll_interval=0.01) == 1
    shutil.copy(tmp_path / "watch" / "case_0" / "volume.nii.gz",
                bad / "volume.nii.gz")
    assert _serve(tmp_path, cfg, predictor, once=False, stop=Sweeps(3),
                  poll_interval=0.01) == 1
    assert (out / "bad" / "prediction.nii.gz").exists()


def test_discover_cases_basename_collision(tmp_path):
    cfg, *_ = _setup(tmp_path)
    shutil.copy(tmp_path / "watch" / "case_0" / "volume.nii.gz",
                tmp_path / "watch" / "case_0.nii.gz")
    collisions = []
    assert sorted(discover_cases(str(tmp_path / "watch"), cfg,
                                 collisions)) == ["case_1"]
    assert collisions == ["case_0"]
    os.remove(tmp_path / "watch" / "case_0.nii.gz")
    assert sorted(discover_cases(str(tmp_path / "watch"), cfg)) == [
        "case_0", "case_1"]


def test_serve_pipelined_matches_serial(tmp_path):
    cfg, _, predictor = _setup(tmp_path, n_cases=4)
    out = str(tmp_path / "served")
    assert _serve(tmp_path, cfg, predictor) == 4
    for i in range(4):
        serial = str(tmp_path / "serial" / f"case_{i}")
        predict_case(str(tmp_path / "watch" / f"case_{i}"), serial,
                     predictor, cfg, save_inputs=False)
        np.testing.assert_array_equal(
            _pred(out, f"case_{i}"),
            load_nifti(os.path.join(serial, "prediction.nii.gz")
                       ).get_fdata())


def _failing_save(real, match, attempts=None):
    def save(data, path, affine=None, **kw):
        if match(path):
            if attempts is not None:
                attempts.append(path)
            raise OSError(28, "No space left on device")
        return real(data, path, affine=affine, **kw)
    return save


def test_serve_write_failure_not_counted_and_quarantined(tmp_path):
    cfg, _, predictor = _setup(tmp_path, n_cases=1)
    real = predict_mod.save_nifti
    pred_file = (lambda p: p.endswith("prediction.nii.gz"))
    stats = {}
    with mock.patch.object(predict_mod, "save_nifti",
                           _failing_save(real, pred_file)):
        assert _serve(tmp_path, cfg, predictor, stats=stats) == 0
    assert stats == {"predicted": 0, "write_failures": 1,
                     "aux_write_failures": 0}
    attempts = []
    with mock.patch.object(predict_mod, "save_nifti",
                           _failing_save(real, pred_file, attempts)):
        assert _serve(tmp_path, cfg, predictor, once=False, stop=Sweeps(3),
                      poll_interval=0.01) == 0
    assert len(attempts) == 1  # the backoff held the later sweeps
    assert _serve(tmp_path, cfg, predictor) == 1


def test_serve_aux_write_failure_classified_separately(tmp_path):
    cfg, _, predictor = _setup(tmp_path, n_cases=1)
    stats = {}
    with mock.patch.object(
            predict_mod, "save_nifti",
            _failing_save(predict_mod.save_nifti,
                          lambda p: os.path.basename(p).startswith("data_"))):
        assert _serve(tmp_path, cfg, predictor, stats=stats,
                      save_inputs=True) == 1
    assert stats == {"predicted": 1, "write_failures": 0,
                     "aux_write_failures": 1}


def test_serve_watch_dir_unreadable(tmp_path):
    cfg, _, predictor = _setup(tmp_path, n_cases=1)
    gone = str(tmp_path / "nonexistent")
    assert watch_and_predict(gone, str(tmp_path / "o"), cfg, predictor,
                             stop=Sweeps(2), poll_interval=0.01,
                             verbose=False) == 0
    with pytest.raises(OSError):
        watch_and_predict(gone, str(tmp_path / "o"), cfg, predictor,
                          once=True, verbose=False)


def test_serve_prunes_state_for_deleted_cases(tmp_path, capsys):
    cfg, _, predictor = _setup(tmp_path, n_cases=1)
    bad = tmp_path / "watch" / "bad"
    bad.mkdir()
    (bad / "volume.nii.gz").write_bytes(b"not a nifti")
    mtime = os.stat(bad / "volume.nii.gz").st_mtime

    def script(call):
        if call == 1:
            shutil.rmtree(bad)
        elif call == 2:
            bad.mkdir()
            (bad / "volume.nii.gz").write_bytes(b"not a nifti")
            os.utime(bad / "volume.nii.gz", (mtime, mtime))

    _serve(tmp_path, cfg, predictor, once=False, stop=Sweeps(3, script),
           poll_interval=0.01, require_stable=False, retry_backoff=3600.0)
    assert capsys.readouterr().out.count("FAILED bad") == 2


def test_serve_collision_flicker_keeps_backoff(tmp_path, capsys):
    cfg, _, predictor = _setup(tmp_path, n_cases=1)
    bad = tmp_path / "watch" / "bad"
    bad.mkdir()
    (bad / "volume.nii.gz").write_bytes(b"not a nifti")
    collider = tmp_path / "watch" / "bad.nii.gz"

    def script(call):
        if call == 1:
            shutil.copy(tmp_path / "watch" / "case_0" / "volume.nii.gz",
                        collider)
        elif call == 2:
            os.remove(collider)

    _serve(tmp_path, cfg, predictor, once=False, stop=Sweeps(4, script),
           poll_interval=0.01, require_stable=False, retry_backoff=3600.0)
    assert capsys.readouterr().out.count("FAILED bad") == 1


def test_serve_stats_file_heartbeat(tmp_path):
    cfg, _, predictor = _setup(tmp_path)
    sf = tmp_path / "stats.json"
    assert _serve(tmp_path, cfg, predictor, stats_file=str(sf)) == 2
    s = json.loads(sf.read_text())
    assert s["predicted"] == 2 and s["sweeps"] == 1
    assert s["write_failures"] == 0 and s["quarantined"] == 0
    assert s["latency_sec"]["n"] == 2 and s["latency_sec"]["p50"] > 0
    assert s["latency_sec"]["max"] >= s["latency_sec"]["p50"]
    assert s["last_served"] in ("case_0", "case_1")
    assert _serve(tmp_path, cfg, predictor, out=tmp_path / "s2",
                  stats_file=str(tmp_path / "no_dir" / "x.json")) == 2


def test_serve_device_preprocess_matches_serial(tmp_path):
    cfg, model, predictor = _setup(tmp_path, n_cases=2, shape=(30, 26, 28))
    pre = make_device_preprocessor(model, cfg)
    out = str(tmp_path / "served")
    assert _serve(tmp_path, cfg, predictor, device_pre=pre,
                  save_inputs=True) == 2
    for i in range(2):
        serial = str(tmp_path / "serial" / f"case_{i}")
        predict_case(str(tmp_path / "watch" / f"case_{i}"), serial,
                     predictor, cfg, save_inputs=False, device_pre=pre)
        np.testing.assert_array_equal(
            _pred(out, f"case_{i}"),
            load_nifti(os.path.join(serial, "prediction.nii.gz")
                       ).get_fdata())
        data = load_nifti(os.path.join(out, f"case_{i}",
                                       "data_volume.nii.gz"))
        assert data.shape == cfg.image_shape
        assert abs(float(data.get_fdata().mean())) < 0.1


def _load_root(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """Synthetic cases, a JAX checkpoint, and the same weights as an npz."""
    import jax
    from flax.traverse_util import flatten_dict

    from fetal_mri_segmentation_tpu.config import Config as JaxConfig
    from fetal_mri_segmentation_tpu.models import build_model as jax_build
    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO

    d = tmp_path_factory.mktemp("serve_main")
    write_synthetic_dataset(str(d / "watch"), n_cases=2, shape=(28, 24, 26))
    cfg = JaxConfig(image_shape=(24, 24, 24), patch_shape=(16, 16, 16),
                    depth=3, n_base_filters=4, compute_dtype="float32",
                    fold_level0="off", validation_patch_overlap=4,
                    data_file=str(d / "none.h5"),
                    model_file=str(d / "ckpt"))
    state = create_train_state(jax_build(cfg), cfg, jax.random.PRNGKey(0))
    CheckpointIO(cfg.model_file).save(state, epoch=1, best_val=-0.5)
    np.savez(d / "params.npz", **flatten_dict(state.params, sep="/"))
    return d, cfg, state


def _jax_probabilities(d, cfg, state, case, direct, tta, device_pre):
    """The JAX package's probability map of one case through the predictor
    the server used (for the threshold band of the label comparison)."""
    from fetal_mri_segmentation_tpu.inference import predict as jax_predict
    from fetal_mri_segmentation_tpu.models import build_model as jax_build

    model = jax_build(cfg)
    pre = (jax_predict.make_device_preprocessor(model, cfg) if device_pre
           else None)
    data, _, _ = jax_predict.preprocess_case(str(d / "watch" / case), cfg,
                                             device_pre=pre)
    predictor = jax_predict.build_serving_predictor(model, cfg, direct=direct,
                                                    tta=tta, overlap=4)
    return predictor({"params": state.params}, data)


@pytest.mark.parametrize("direct,tta,device_preprocess", [
    (False, False, False), (True, "flips", True)])
def test_serve_main_matches_root_serve(experiment, monkeypatch, direct, tta,
                                       device_preprocess):
    d, cfg, state = experiment
    monkeypatch.setenv("FETAL_TPU_NO_CACHE", "1")
    tag = f"{direct}-{tta}-{device_preprocess}"
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    try:
        _load_root("serve").main(
            cfg, watch=str(d / "watch"), output=str(d / f"jax_{tag}"),
            direct=direct, tta=tta, once=True,
            device_preprocess=device_preprocess)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    stats_file = d / f"stats_{tag}.json"
    n = port_serve.main(cfg, str(d / "params.npz"), str(d / "watch"),
                        output=str(d / f"port_{tag}"), direct=direct,
                        tta=tta, once=True,
                        device_preprocess=device_preprocess,
                        stats_file=str(stats_file), device="cpu",
                        verbose=False)
    assert n == 2
    assert json.loads(stats_file.read_text())["latency_sec"]["n"] == 2
    for case in ("case_0", "case_1"):
        want = _pred(str(d / f"jax_{tag}"), case)
        got = _pred(str(d / f"port_{tag}"), case)
        prob = _jax_probabilities(d, cfg, state, case, direct, tta,
                                  device_preprocess)
        far = np.abs(prob[0] - 0.5) > 1e-3
        assert got.shape == want.shape == cfg.image_shape
        np.testing.assert_array_equal(got[far], want[far])


def test_serve_main_refuses_without_cuda(experiment):
    d, cfg, _ = experiment
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.main(cfg, str(d / "params.npz"), str(d / "watch"),
                        output=str(d / "nocuda"), once=True)


def test_serve_cli_parses_every_flag():
    args = port_serve._parser().parse_args([
        "--config", "c.json", "--params", "p.npz", "--watch", "w",
        "--output", "o", "--overlap", "8", "--patch-batch-size", "4",
        "--direct", "--tta-mode", "flips", "--poll", "0.5", "--once",
        "--threshold", "0.4", "--save-inputs", "--device-preprocess",
        "--stats-file", "s.json", "--device", "cpu"])
    assert (args.direct, args.tta_mode, args.once, args.device) == (
        True, "flips", True, "cpu")
    assert port_serve._parser().parse_args(
        ["--config", "c", "--params", "p", "--watch", "w"]).device == "cuda"
