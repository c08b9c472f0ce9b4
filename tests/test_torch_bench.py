"""The port's bench (``fetal_mri_segmentation_tpu_torch/bench.py``) against
the root ``bench.py``, on the CPU at 16^3-32^3: the ``--quick`` and the full
line carry exactly ``BENCH_r05.json``'s names (nested) plus
``detail.kernels``, every row gives positive, finite numbers, ``_make_batch``
draws what the root one draws from the same seed, the bench configs equal,
field by field, a JAX ``Config`` built with the keyword arguments of each of
``bench.py``'s ``Config(...)`` calls (the kernel switches aside), ``--config
N`` runs the rows ``bench.py`` runs, and without CUDA the entry exits
non-zero unless given ``--device cpu``.

The root ``bench.py`` is loaded from its file: its top level imports numpy
and the standard library only."""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu_torch import bench  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import PORT_ONLY  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
root_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root_bench)

# Every row at the smallest sizes its models take: the composite's 16^3
# patches (Isensee2017's depth 5 halves four times), a 32^3 volume (the
# real epoch's patch start offset is bench.py's 16), 2 cases where a row
# takes the median after the first, 2 ranks for config 5.
TINY = dict(patch=(16, 16, 16), volume=(32, 32, 32), overlap=0, n_reps=1,
            train_patches_per_volume=1, raw_shape=(40, 40, 28),
            serve_cases=2, backlog_cases=2, prob_cases=2, epoch_cases=4,
            dp_ranks=2, dp_patch=(16, 16, 16))
# names of BENCH_r05.json that the port's line cannot keep on the card
LOST = ()
# the rows --quick leaves out, as bench.py does
NOT_QUICK = ("config2_augmented", "config4_isensee", "config5_dp",
             "direct_volume_infer_sec", "serve_case_sec",
             "serve_case_resample_sec", "serve_case_resample_device_sec",
             "serve_backlog_sec_per_case", "prob_batch_sec_per_case_f32",
             "prob_batch_sec_per_case_f16", "prob_batch_sec_per_case_u8",
             "train_step_b1_aug_sec", "train_step_b1_aug_distort_sec",
             "train_step_b8_aug_sec", "train_step_b8_aug_distort_sec",
             "train_step_b8_sec", "train_patches_per_sec_b8",
             "train_step_b27_sec", "train_patches_per_sec_b27",
             "real_epoch", "tta_flips_volume_sec", "tta_permute_volume_sec",
             "tta_flips_direct_volume_sec", "tta_permute_direct_volume_sec")
KERNELS_KEYS = {"switches": None, "launches": {"K1": None, "K2": None,
                                               "K3": None}}


def _line(argv) -> dict:
    """``bench.main(argv)`` with every row at ``TINY``; its stdout must be
    one JSON line."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "collect", functools.partial(bench.collect,
                                                       **TINY))
        with contextlib.redirect_stdout(out):
            bench.main(argv)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def full_line():
    return _line(["--device", "cpu", "--kernels", "on"])


@pytest.fixture(scope="module")
def quick_line():
    return _line(["--quick", "--device", "cpu"])


def _keys(d):
    """The nested key structure of a JSON object."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def _r05_keys() -> dict:
    keys = _keys(json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"])
    for name in LOST:
        keys["detail"].pop(name)
    keys["detail"]["kernels"] = KERNELS_KEYS
    return keys


def test_full_line_has_bench_py_names(full_line):
    assert _keys(full_line) == _r05_keys()
    assert full_line["detail"]["kernels"] == {
        "switches": "on", "launches": {"K1": 0, "K2": 0, "K3": 0}}
    assert full_line["detail"]["device"] == "cpu"
    assert (full_line["detail"]["host_canary_sec"]
            == full_line["detail"]["config5_dp"]["dp_step_sec_cpu8"])
    cpu = json.loads((ROOT / "baseline_cpu_keras.json").read_text())
    assert full_line["vs_baseline"] == round(
        full_line["value"] / cpu["composite_volumes_per_sec"], 2)


def test_quick_line_has_bench_py_quick_names(quick_line):
    want = _r05_keys()
    for name in NOT_QUICK:
        want["detail"].pop(name)
    assert _keys(quick_line) == want
    assert quick_line["detail"]["kernels"]["switches"] == "off"
    assert quick_line["detail"]["host_canary_sec"] is None
    assert quick_line["value"] > 0


ROWS = {
    "composite": lambda line: [line["value"], line["detail"]["train_step_sec"],
                               line["detail"]["whole_volume_infer_sec"]],
    "config2_augmented": lambda line: list(
        line["detail"]["config2_augmented"].values()),
    "config4_isensee": lambda line: list(
        line["detail"]["config4_isensee"].values()),
    "config5_dp": lambda line: [line["detail"]["config5_dp"][k] for k in
                                ("dp_step_sec_cpu8", "devices")],
    "direct": lambda line: [line["detail"]["direct_volume_infer_sec"]],
    "serve_case": lambda line: [line["detail"][k] for k in (
        "serve_case_sec", "serve_case_resample_sec",
        "serve_case_resample_device_sec")],
    "serve_backlog": lambda line: [
        line["detail"]["serve_backlog_sec_per_case"]],
    "prob_batch": lambda line: [line["detail"][
        f"prob_batch_sec_per_case_{t}"] for t in ("f32", "f16", "u8")],
    "distort": lambda line: [line["detail"][
        f"train_step_b{b}_aug{d}_sec"] for b in (1, 8)
        for d in ("", "_distort")],
    "batched": lambda line: [line["detail"][k.format(b)] for b in (8, 27)
                             for k in ("train_step_b{}_sec",
                                       "train_patches_per_sec_b{}")],
    "real_epoch": lambda line: [line["detail"]["real_epoch"][k] for k in (
        "epoch_patches_per_sec", "epoch_steps", "epoch_batch_size")],
    "tta": lambda line: [line["detail"][f"tta_{m}{d}_volume_sec"]
                         for m in ("flips", "permute")
                         for d in ("", "_direct")],
}


@pytest.mark.parametrize("row", ROWS)
def test_row_gives_positive_finite_numbers(full_line, row):
    values = ROWS[row](full_line)
    assert values and all(isinstance(v, (int, float)) and math.isfinite(v)
                          and v > 0 for v in values), values
    if row == "config5_dp":
        assert math.isfinite(full_line["detail"]["config5_dp"]["loss"])
        assert full_line["detail"]["config5_dp"]["devices"] == 2
    if row == "real_epoch":
        assert full_line["detail"]["real_epoch"]["device_case_cache"] in (
            True, False)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_batch_equals_bench_py(seed):
    got = bench._make_batch(np.random.default_rng(seed))
    want = root_bench._make_batch(np.random.default_rng(seed))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == (1, 1) + root_bench.PATCH
        np.testing.assert_array_equal(a, b)
    # the batched rows draw the same formula at batch B (bench.py:152)
    rng = np.random.default_rng(seed)
    y = (rng.random((8, 1) + root_bench.PATCH) > 0.7).astype(np.float32)
    x = (y * 2 + rng.normal(0, 0.3, y.shape)).astype(np.float32)
    got = bench._make_batch(np.random.default_rng(seed), batch=8)
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], y)


P, V = root_bench.PATCH, root_bench.VOLUME
RUN = os.path.join("bench_run", "run")
# each Config(...) call of bench.py with its literal keyword arguments (the
# env-read use_pallas_conv at its default "0"), beside the port's config
CONFIG_CALLS = {
    "composite unet (:65)": (
        lambda: bench.composite_config("unet", False),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          patch_shape=P, image_shape=V, batch_size=1,
                          augment=False, flip=False, permute=False,
                          contrast=None, compute_dtype="bfloat16",
                          use_pallas_conv=False, initial_learning_rate=1e-5)),
    "composite augmented (:65)": (
        lambda: bench.composite_config("unet", True),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          patch_shape=P, image_shape=V, batch_size=1,
                          augment=True, flip=True, permute=True,
                          contrast=0.1, compute_dtype="bfloat16",
                          use_pallas_conv=False, initial_learning_rate=1e-5)),
    "composite isensee (:65)": (
        lambda: bench.composite_config("isensee", False),
        lambda: JaxConfig(model_name="isensee", depth=5, n_base_filters=16,
                          patch_shape=P, image_shape=V, batch_size=1,
                          augment=False, flip=False, permute=False,
                          contrast=None, compute_dtype="bfloat16",
                          use_pallas_conv=False, initial_learning_rate=1e-5)),
    "batched b27 (:146)": (
        lambda: bench.batched_config(27),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          patch_shape=P, batch_size=27,
                          compute_dtype="bfloat16",
                          initial_learning_rate=1e-5)),
    "real epoch (:204)": (
        lambda: bench.real_epoch_config("data.h5", RUN),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          image_shape=V, patch_shape=P, batch_size=8,
                          validation_batch_size=8, n_epochs=2,
                          compute_dtype="bfloat16",
                          initial_learning_rate=1e-5, data_file="data.h5",
                          training_patch_start_offset=(16, 16, 16),
                          validation_patch_overlap=0,
                          model_file=os.path.join(RUN, "model.ckpt"),
                          training_file=os.path.join(RUN, "t.pkl"),
                          validation_file=os.path.join(RUN, "v.pkl"),
                          training_log=os.path.join(RUN, "training.log"))),
    "tta (:264)": (
        lambda: bench.predictor_config(),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          patch_shape=P, image_shape=V,
                          compute_dtype="bfloat16")),
    "serve case (:329)": (
        lambda: bench.predictor_config(depth=4),
        lambda: JaxConfig(model_name="unet", depth=4, n_base_filters=32,
                          image_shape=V, patch_shape=P,
                          compute_dtype="bfloat16")),
    "serve backlog (:393)": (
        lambda: bench.predictor_config(depth=4),
        lambda: JaxConfig(model_name="unet", depth=4, n_base_filters=32,
                          image_shape=V, patch_shape=P,
                          compute_dtype="bfloat16")),
    "prob batch (:460)": (
        lambda: bench.predictor_config(),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          image_shape=V, patch_shape=P,
                          compute_dtype="bfloat16")),
    "distort b8 (:517)": (
        lambda: bench.distort_config(8, 0.25),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          patch_shape=P, batch_size=8, augment=True,
                          flip=True, permute=True, contrast=0.1,
                          distort=0.25, compute_dtype="bfloat16",
                          initial_learning_rate=1e-5)),
    "direct (:554)": (
        lambda: bench.direct_config(),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=32,
                          patch_shape=P, image_shape=V, batch_size=1,
                          compute_dtype="bfloat16")),
    "config5 dp (:597)": (
        lambda: bench.dp_config(),
        lambda: JaxConfig(model_name="unet", depth=3, n_base_filters=16,
                          patch_shape=(32, 32, 32), batch_size=8,
                          compute_dtype="float32", augment=True, flip=True,
                          permute=True, contrast=0.1)),
}
SWITCHES = ("use_pallas_conv", "use_pallas_dec0")


@pytest.mark.parametrize("call", CONFIG_CALLS)
def test_configs_equal_bench_py(call):
    port, jax = (dataclasses.asdict(make()) for make in CONFIG_CALLS[call])
    # the port's own Config fields aside, which the JAX Config does not have
    assert {k: v for k, v in port.items()
            if k not in SWITCHES + PORT_ONLY} == {
        k: v for k, v in jax.items() if k not in SWITCHES}
    assert not any(port[k] for k in SWITCHES)


def test_kernels_switch_sets_both_switches_and_keeps_the_rest():
    for off, on in ((bench.composite_config("isensee", False),
                     bench.composite_config("isensee", False, True)),
                    (bench.batched_config(8), bench.batched_config(8, True)),
                    (bench.predictor_config(depth=4),
                     bench.predictor_config(True, depth=4)),
                    (bench.distort_config(1, None),
                     bench.distort_config(1, None, True))):
        assert all(getattr(on, k) for k in SWITCHES)
        assert dataclasses.replace(on, use_pallas_conv=False,
                                   use_pallas_dec0=False) == off


def test_kernels_on_card_needs_every_kernel_of_the_family():
    idle = {"K1": 3, "K2": 4, "K3": 0}
    assert bench.kernels_detail(True, idle, "cpu") == {
        "switches": "on", "launches": idle}
    assert bench.kernels_detail(True, idle, "cuda", "isensee")[
        "switches"] == "on"
    with pytest.raises(RuntimeError, match="K3"):
        bench.kernels_detail(True, idle, "cuda")
    assert bench.kernels_detail(False, idle, "cuda")["switches"] == "off"


# bench.py:646-661: --config N's metric and the composite it runs
DISPATCH = {1: ("config1+3 composite", ("unet", False)),
            2: ("config2 augmented composite", ("unet", True)),
            3: ("config1+3 composite", ("unet", False)),
            4: ("config4 isensee composite", ("isensee", False)),
            5: ("config5 DP step", None)}


@pytest.mark.parametrize("config", DISPATCH)
def test_config_flag_dispatches_as_bench_py(monkeypatch, config):
    calls = []

    def composite(model_name, augment, **kw):
        calls.append((model_name, augment))
        return {"volumes_per_sec": 1.0, "train_step_sec": 0.5,
                "whole_volume_infer_sec": 0.25}

    def dp(**kw):
        calls.append("dp")
        return {"dp_step_sec_cpu8": 2.0, "loss": -0.5, "devices": 8,
                "note": "n"}

    monkeypatch.setattr(bench, "_composite", composite)
    monkeypatch.setattr(bench, "_config5_dp_cpu", dp)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--config", str(config), "--device", "cpu"])
    (line,) = out.getvalue().splitlines()
    line = json.loads(line)
    metric, call = DISPATCH[config]
    assert line["metric"].startswith(metric)
    if call is None:
        assert calls == ["dp"] and line["dp_step_sec_cpu8"] == 2.0
    else:
        assert calls == [call] and line["volumes_per_sec"] == 1.0
        assert line["kernels"]["switches"] == "off"


def test_entry_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the entry would run on it")
    proc = subprocess.run(
        [sys.executable, "-m", "fetal_mri_segmentation_tpu_torch.bench",
         "--quick"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "--device cpu" in proc.stderr
