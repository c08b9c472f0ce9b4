"""The port's bench: the root ``bench.py``'s rows on an NVIDIA GPU.

    python -m fetal_mri_segmentation_tpu_torch.bench [--config {1,2,3,4,5}]
        [--quick] [--kernels {off,on}] [--device {cuda,cpu}]

Prints ONE JSON line on stdout under the root ``bench.py``'s names, counts
and statistics (warnings go to stderr): the composite "volume-equivalent"
(8 batch-1 train steps on 64^3 patches of the depth-3, 32-filter U-Net +
one 128^3 sliding-window volume, overlap 16, Gaussian overlap-add, as a
pipelined stream of volumes with an async label fetch) as ``value`` in
volumes/s, and in ``detail`` the other configs' rows: ``config2_augmented``
(flip, permute, contrast 0.1 in the step), ``config4_isensee`` (depth 5, 16
filters), ``config5_dp`` (8 data-parallel ranks on the host's CPU, a host
canary: the card is not used), the direct and TTA predictors, the serving
rows (a case end to end, at scanner resolution on the host and on the card,
an 8-case ``watch_and_predict`` backlog), the probability-map batches, the
augmented and batched train steps and a real two-epoch training run from a
synthetic dataset of 24 cases of 128^3. ``vs_baseline`` divides ``value``
by ``baseline_cpu_keras.json``'s recorded ``composite_volumes_per_sec``.
``--quick`` measures the composite only; ``--config N`` one config.

The card by default: without CUDA, and without ``--device cpu``, the entry
exits non-zero. ``--kernels on`` turns on both kernel switches
(``use_pallas_conv`` / ``use_pallas_dec0``) for every row; off, the default,
leaves both off, as the JAX ``Config`` and ``bench.py`` do. The kernels are
built from ``csrc/`` at first use and a wrapper given a CUDA tensor
launches its kernel or raises, so a kernel that does not build or launch
fails the run. The line adds one name to ``bench.py``'s: ``detail.kernels``
= ``{"switches": "off" | "on", "launches": {"K1": n, "K2": n, "K3": n}}``,
each kernel's launches over the composite (K1 ``conv3x3``, K2
``conv3x3_flat``, K3 ``up_concat_conv3x3_kernel``; 0 on the CPU, where each
route runs its plain version); a ``--config`` 1-4 line carries the same
object as ``kernels``. ``detail.device`` is the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them ("cpu" with ``--device cpu``).

The timing protocol is ``bench.py``'s but for the TPU's workarounds: a host
clock around work that ends in ``torch.cuda.synchronize()``, after a
warm-up, replaces its forced readbacks, and ``direct_volume_infer_sec``
takes CUDA events over 10 forwards of distinct volumes after 2 warm-ups
(device time) in place of the in-jit scan. ``config5_dp`` runs 8 gloo
ranks, one process each, on the CPU where ``bench.py`` ran a virtual
8-device CPU mesh in one process. Every name keeps its meaning on the card.

Each row function takes its sizes as keyword arguments whose defaults are
``bench.py``'s (the tests run every row at 16^3-32^3 on the CPU). The
configs are built by the ``*_config`` functions, field for field those of
``bench.py``'s ``Config(...)`` calls but for the kernel switches.

Copies of root ``bench.py``: the constants ``PATCH``, ``VOLUME``,
``OVERLAP``, ``TRAIN_PATCHES_PER_VOLUME`` and ``_make_batch``
(``bench.py:45``, with the batch size as an argument); root ``bench.py``
imports JAX in every row, so the port imports nothing of it.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.data.build import (open_data_file,
                                                         write_data_to_file)
from fetal_mri_segmentation_tpu_torch.data.synthetic import (
    write_synthetic_dataset)
from fetal_mri_segmentation_tpu_torch.inference.predict import (
    make_device_preprocessor, predict_case, predict_cases_pipelined)
from fetal_mri_segmentation_tpu_torch.inference.serve import (
    watch_and_predict)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
from fetal_mri_segmentation_tpu_torch.ops import cuda_lib
from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
    make_dp_train_step, make_mesh, replicate_state)
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    free_port, initialize_distributed, rank_environment, run_ranks,
    shutdown_distributed)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_direct_predictor)
from fetal_mri_segmentation_tpu_torch.pipeline.device_cache import (
    maybe_build_device_cache)
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
    get_training_and_validation_generators)
from fetal_mri_segmentation_tpu_torch.training.loop import train_model
from fetal_mri_segmentation_tpu_torch.training.state import (
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
from fetal_mri_segmentation_tpu_torch.utils.nifti import save_nifti
from fetal_mri_segmentation_tpu_torch.utils.params import (from_flax,
                                                           init_flax_like)

PATCH = (64, 64, 64)
VOLUME = (128, 128, 128)
OVERLAP = 16
TRAIN_PATCHES_PER_VOLUME = 8
# bench.py's literals: the sliding window's patch batch, the scanner-
# resolution raw shape of the resampling rows, config 5's patch and ranks
PATCH_BATCH = 27
RAW_SHAPE = (170, 170, 110)
DP_PATCH = (32, 32, 32)
DP_RANKS = 8
DP_TIMEOUT_S = 900.0
ROOT = Path(__file__).resolve().parents[1]
KERNELS = {"K1": conv_ops.conv3x3, "K2": conv_ops.conv3x3_flat,
           "K3": dec_ops.up_concat_conv3x3_kernel}
# the kernels each family's forward reaches: Isensee2017 has no fused
# full-resolution decoder, so never K3
FAMILY_KERNELS = {"unet": ("K1", "K2", "K3"), "isensee": ("K1", "K2")}


def _make_batch(rng, patch=PATCH, batch: int = 1):
    """Copy of root ``bench.py::_make_batch``: a thresholded-uniform truth
    and a noisy bright copy of it, ``(batch, 1) + patch`` each."""
    y = (rng.random((batch, 1) + tuple(patch)) > 0.7).astype(np.float32)
    x = (y * 2 + rng.normal(0, 0.3, y.shape)).astype(np.float32)
    return x, y


# ---------------------------------------------------------------- configs
# One function per Config(...) call of bench.py (the line in brackets); the
# kernel switches are the port's.


def _switches(kernels: bool) -> dict:
    return dict(use_pallas_conv=kernels, use_pallas_dec0=kernels)


def composite_config(model_name: str, augment: bool, kernels: bool = False,
                     *, patch=PATCH, volume=VOLUME) -> Config:
    """``_composite`` (bench.py:65): the depth-3, 32-filter U-Net, or the
    reference Isensee2017 defaults (depth 5, 16 filters)."""
    depth, nbf = (3, 32) if model_name == "unet" else (5, 16)
    return Config(model_name=model_name, depth=depth, n_base_filters=nbf,
                  patch_shape=patch, image_shape=volume, batch_size=1,
                  augment=augment, flip=augment, permute=augment,
                  contrast=0.1 if augment else None,
                  compute_dtype="bfloat16", initial_learning_rate=1e-5,
                  **_switches(kernels))


def batched_config(batch: int, kernels: bool = False, *,
                   patch=PATCH) -> Config:
    """``_batched_train_steps`` (bench.py:146)."""
    return Config(model_name="unet", depth=3, n_base_filters=32,
                  patch_shape=patch, batch_size=batch,
                  compute_dtype="bfloat16", initial_learning_rate=1e-5,
                  **_switches(kernels))


def real_epoch_config(data_file: str, run_dir: str, kernels: bool = False,
                      *, patch=PATCH, volume=VOLUME) -> Config:
    """``_real_epoch_row`` (bench.py:204): two epochs, so the last log row
    is past the first epoch's warm-up."""
    return Config(model_name="unet", depth=3, n_base_filters=32,
                  image_shape=volume, patch_shape=patch, batch_size=8,
                  validation_batch_size=8, n_epochs=2,
                  compute_dtype="bfloat16", initial_learning_rate=1e-5,
                  data_file=data_file,
                  training_patch_start_offset=(16, 16, 16),
                  validation_patch_overlap=0,
                  model_file=os.path.join(run_dir, "model.ckpt"),
                  training_file=os.path.join(run_dir, "t.pkl"),
                  validation_file=os.path.join(run_dir, "v.pkl"),
                  training_log=os.path.join(run_dir, "training.log"),
                  **_switches(kernels))


def predictor_config(kernels: bool = False, *, patch=PATCH, volume=VOLUME,
                     depth: int = 3) -> Config:
    """The serving rows' U-Net: depth 3 for the TTA (bench.py:264) and
    probability-batch (:460) rows, depth 4 for the serving cases (:329) and
    the backlog (:393)."""
    return Config(model_name="unet", depth=depth, n_base_filters=32,
                  image_shape=volume, patch_shape=patch,
                  compute_dtype="bfloat16", **_switches(kernels))


def direct_config(kernels: bool = False, *, patch=PATCH,
                  volume=VOLUME) -> Config:
    """``_direct_volume_infer`` (bench.py:554)."""
    return Config(model_name="unet", depth=3, n_base_filters=32,
                  patch_shape=patch, image_shape=volume, batch_size=1,
                  compute_dtype="bfloat16", **_switches(kernels))


def distort_config(batch: int, distort, kernels: bool = False, *,
                   patch=PATCH) -> Config:
    """``_distort_step_rows`` (bench.py:517)."""
    return Config(model_name="unet", depth=3, n_base_filters=32,
                  patch_shape=patch, batch_size=batch, augment=True,
                  flip=True, permute=True, contrast=0.1, distort=distort,
                  compute_dtype="bfloat16", initial_learning_rate=1e-5,
                  **_switches(kernels))


def dp_config(*, patch=DP_PATCH) -> Config:
    """``_config5_dp_cpu`` (bench.py:597): fp32 on the CPU, so no kernel."""
    return Config(model_name="unet", depth=3, n_base_filters=16,
                  patch_shape=patch, batch_size=8, compute_dtype="float32",
                  augment=True, flip=True, permute=True, contrast=0.1)


# ---------------------------------------------------------------- helpers


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _release(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _model(config, device):
    """The configured model with random weights from seed 0."""
    model = build_model(config, device)
    model.load_state_dict(from_flax(init_flax_like(config, seed=0)))
    return model


def _trainer(config, device):
    """``(state, step)``: Adam at the config's rate; the step's generator
    (augmentation, dropout masks) seeded 1, as bench.py's PRNGKey(1)."""
    model = _model(config, device)
    generator = torch.Generator(device=device).manual_seed(1)
    return (create_train_state(model, config),
            make_train_step(model, config, generator=generator))


def _to(device, *arrays):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _step_seconds(step, state, x, y, n: int, device) -> float:
    """Mean seconds of ``n`` steps after one warm-up step."""
    step(state, x, y)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, x, y)
    _sync(device)
    return (time.perf_counter() - t0) / n


def _device_seconds(device, run) -> float:
    """Seconds of ``run()`` on the card's stream (CUDA events), or on the
    host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _croppable(rng, raw_shape) -> np.ndarray:
    """bench.py's scanner-like volume: foreground in a zero background, so
    the serving crop shrinks it."""
    vol = np.zeros(raw_shape, np.float32)
    box = tuple(slice(int(0.17 * n), int(0.80 * n)) for n in raw_shape)
    vol[box] = rng.normal(200, 50, [s.stop - s.start for s in box]
                          ).astype(np.float32)
    return vol


def kernels_detail(kernels: bool, launches: dict, device,
                   model_name: str = "unet") -> dict:
    """``detail.kernels``. With the switches on, on the card, each kernel
    the family's forward reaches must have launched: a composite that ran
    none of them did not measure the kernels."""
    if kernels and torch.device(device).type == "cuda":
        idle = [k for k in FAMILY_KERNELS[model_name] if not launches[k]]
        if idle:
            raise RuntimeError(f"--kernels on: {idle} never launched over "
                               f"the composite ({launches})")
    return {"switches": "on" if kernels else "off", "launches": launches}


def device_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------- rows


def _composite(model_name: str, augment: bool, n_reps: int = 5, *,
               device="cuda", kernels: bool = False, patch=PATCH,
               volume=VOLUME, overlap: int = OVERLAP,
               train_patches_per_volume: int = TRAIN_PATCHES_PER_VOLUME
               ) -> dict:
    """volumes/sec + component times for one model/aug settings: the
    median of 3 trials of ``n_reps`` x (``train_patches_per_volume``
    batch-1 steps + one async sliding-window volume), the labels fetched
    after each trial; then 20 steps, then one volume alone."""
    config = composite_config(model_name, augment, kernels, patch=patch,
                              volume=volume)
    state, train_step = _trainer(config, device)
    rng = np.random.default_rng(0)
    x, y = _to(device, *_make_batch(rng, patch))
    predictor = SlidingWindowPredictor(state.model, config, volume,
                                       overlap=overlap,
                                       patch_batch_size=PATCH_BATCH)
    vol = rng.normal(0, 1, (1,) + tuple(volume)).astype(np.float32)

    train_step(state, x, y)  # warm-up
    predictor.predict_labels(vol)
    _sync(device)
    trials = []
    for _ in range(3):
        outs = []
        t0 = time.perf_counter()
        for _ in range(n_reps):
            for _ in range(train_patches_per_volume):
                train_step(state, x, y)
            outs.append(predictor.predict_labels_async(vol))
        labels = [predictor.unpack_labels(o) for o in outs]
        _sync(device)
        trials.append((time.perf_counter() - t0) / n_reps)
        if any(lab.shape != tuple(volume) for lab in labels):
            raise RuntimeError(f"label maps {[lab.shape for lab in labels]}")
    dt = float(np.median(trials))

    t0 = time.perf_counter()
    for _ in range(20):
        train_step(state, x, y)
    _sync(device)
    train_step_sec = (time.perf_counter() - t0) / 20
    t0 = time.perf_counter()
    predictor.predict_labels(vol)
    _sync(device)
    infer_sec = time.perf_counter() - t0
    del state, train_step, predictor
    _release(device)
    return {"volumes_per_sec": round(1.0 / dt, 4),
            "train_step_sec": round(train_step_sec, 5),
            "whole_volume_infer_sec": round(infer_sec, 5)}


def _batched_train_steps(*, device="cuda", kernels: bool = False,
                         patch=PATCH, batches=(8, 27)) -> dict:
    """Throughput-shape train steps at B=8 and B=27: 10 steps after one
    warm-up each."""
    out = {}
    rng = np.random.default_rng(0)
    for b in batches:
        state, step = _trainer(batched_config(b, kernels, patch=patch),
                               device)
        x, y = _to(device, *_make_batch(rng, patch, b))
        dt = _step_seconds(step, state, x, y, 10, device)
        out[f"train_step_b{b}_sec"] = round(dt, 5)
        out[f"train_patches_per_sec_b{b}"] = round(b / dt, 2)
        del state, step
        _release(device)
    return out


def _real_epoch_row(*, device="cuda", kernels: bool = False, patch=PATCH,
                    volume=VOLUME, n_cases: int = 24) -> dict:
    """A real training run (generators, device case cache, steps,
    validation, checkpoint) for two epochs on a synthetic dataset of
    ``n_cases`` volumes, built once in a temporary directory (``.npy``
    memory maps, per-volume normalization, no crop): patches/s as the last
    training-log row records it."""
    with tempfile.TemporaryDirectory() as d:
        files = write_synthetic_dataset(os.path.join(d, "cases"),
                                        n_cases=n_cases, shape=volume)
        data_dir = os.path.join(d, "data")
        write_data_to_file(files, data_dir, image_shape=volume,
                           normalize="per_volume", crop=False)
        run_dir = os.path.join(d, "run")
        os.makedirs(run_dir)
        cfg = real_epoch_config(data_dir, run_dir, kernels, patch=patch,
                                volume=volume)
        data_file = open_data_file(data_dir)
        try:
            tg, n_t, vg, n_v = get_training_and_validation_generators(
                data_file, batch_size=cfg.batch_size, n_labels=1,
                training_keys_file=cfg.training_file,
                validation_keys_file=cfg.validation_file,
                data_split=0.875, overwrite=True,
                patch_shape=cfg.patch_shape,
                validation_batch_size=cfg.validation_batch_size,
                training_patch_start_offset=cfg.training_patch_start_offset,
                skip_blank=True, seed=0)
            model = _model(cfg, device)
            state = create_train_state(model, cfg)
            device_cache = None
            dc = maybe_build_device_cache(data_file, cfg, seed=0,
                                          device=device)
            if dc is not None:
                device_cache, tg, vg = dc
            train_model(model, state, cfg, tg, vg, n_t, n_v, verbose=False,
                        device_cache=device_cache)
            _sync(device)
        finally:
            data_file.close()
        with open(cfg.training_log) as f:
            row = list(csv.DictReader(f))[-1]
        n_train = len(pickle_load(cfg.training_file))
    del model, state, device_cache
    _release(device)
    return {"epoch_patches_per_sec": round(float(row["patches_per_sec"]), 2),
            "epoch_steps": n_t, "epoch_batch_size": cfg.batch_size,
            "device_case_cache": dc is not None,
            "note": f"full train_model run: generator + device case cache "
                    f"+ steps + validation + checkpoint, {n_train} cases "
                    f"{'x'.join(map(str, volume))}, "
                    f"{'x'.join(map(str, patch))} patches; the last of 2 "
                    f"epochs"}


def _tta_volume_secs(*, device="cuda", kernels: bool = False, patch=PATCH,
                     volume=VOLUME, overlap: int = OVERLAP) -> dict:
    """TTA cost per volume (single-shot wall over 2 distinct volumes after
    a warm-up): the 48-symmetry average and the 8-way flips, patch-level on
    the sliding window and volume-level on the direct predictor."""
    config = predictor_config(kernels, patch=patch, volume=volume)
    model = _model(config, device)
    rng = np.random.default_rng(0)
    predictors = {
        "tta_flips_volume_sec": SlidingWindowPredictor(
            model, config, volume, overlap=overlap,
            patch_batch_size=PATCH_BATCH, tta="flips"),
        "tta_permute_volume_sec": SlidingWindowPredictor(
            model, config, volume, overlap=overlap,
            patch_batch_size=PATCH_BATCH, tta="permute"),
        "tta_flips_direct_volume_sec": make_direct_predictor(
            model, config, tta="flips"),
        "tta_permute_direct_volume_sec": make_direct_predictor(
            model, config, tta="permute")}
    out = {}
    for key, predictor in predictors.items():
        vols = [rng.normal(0, 1, (1,) + tuple(volume)).astype(np.float32)
                for _ in range(3)]
        predictor.predict_labels(vols[0])  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for v in vols[1:]:
            predictor.predict_labels(v)
        _sync(device)
        out[key] = round((time.perf_counter() - t0) / (len(vols) - 1), 4)
    del model, predictors
    _release(device)
    return out


def _serve_case_sec(raw_shape=None, device_preprocess: bool = False,
                    n_cases: int = 4, croppable: bool = False, *,
                    device="cuda", kernels: bool = False, patch=PATCH,
                    volume=VOLUME) -> float:
    """Serving seconds per case (``predict_case``: NIfTI read, crop,
    resample, normalize, the direct forward, the label map's D2H and its
    NIfTI write), the median of the cases after the first; each case a
    different random volume. ``device_preprocess`` zooms and normalizes
    on the card (``ops/resample.py``); ``croppable`` embeds the foreground
    in a zero background."""
    raw_shape = tuple(raw_shape or volume)
    config = predictor_config(kernels, patch=patch, volume=volume, depth=4)
    model = _model(config, device)
    predictor = make_direct_predictor(model, config)
    device_pre = (make_device_preprocessor(model, config)
                  if device_preprocess else None)
    rng = np.random.default_rng(0)
    times = []
    with tempfile.TemporaryDirectory() as d:
        for i in range(n_cases):
            case = os.path.join(d, f"case_{i}")
            os.makedirs(case)
            vol = (_croppable(rng, raw_shape) if croppable else
                   rng.normal(0, 1, raw_shape).astype(np.float32))
            save_nifti(vol, os.path.join(case, "volume.nii.gz"))
            t0 = time.perf_counter()
            predict_case(case, os.path.join(d, "out", f"case_{i}"),
                         predictor, config, save_inputs=False,
                         device_pre=device_pre)
            _sync(device)
            times.append(time.perf_counter() - t0)
    del model, predictor, device_pre
    _release(device)
    return round(float(np.median(times[1:])), 5)


def _serve_backlog_sec_per_case(n_cases: int = 8, raw_shape=RAW_SHAPE, *,
                                device="cuda", kernels: bool = False,
                                patch=PATCH, volume=VOLUME) -> float:
    """The pipelined serving number: ``watch_and_predict`` over an
    ``n_cases`` backlog (``once=True``) with the direct predictor and
    device preprocessing, seconds per case, after a one-case warm-up
    sweep."""
    config = predictor_config(kernels, patch=patch, volume=volume, depth=4)
    model = _model(config, device)
    predictor = make_direct_predictor(model, config)
    device_pre = make_device_preprocessor(model, config)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        watch, out = os.path.join(d, "in"), os.path.join(d, "out")
        for i in range(n_cases):
            case = os.path.join(watch, f"case_{i}")
            os.makedirs(case)
            save_nifti(_croppable(rng, tuple(raw_shape)),
                       os.path.join(case, "volume.nii.gz"))
        warm = os.path.join(d, "warm")
        shutil.copytree(os.path.join(watch, "case_0"),
                        os.path.join(warm, "case_w"))
        nw = watch_and_predict(warm, out, config, predictor, once=True,
                               verbose=False, device_pre=device_pre)
        if nw != 1:
            # watch_and_predict quarantines a failing case instead of
            # raising: a cold backlog must not be timed as steady state
            raise RuntimeError(f"serve-backlog warm sweep predicted {nw}/1 "
                               "cases — refusing to time a cold backlog")
        _sync(device)
        t0 = time.perf_counter()
        n = watch_and_predict(watch, out, config, predictor, once=True,
                              verbose=False, device_pre=device_pre)
        _sync(device)
        dt = time.perf_counter() - t0
    if n != n_cases:
        raise RuntimeError(f"serve backlog predicted {n}/{n_cases} cases")
    del model, predictor, device_pre
    _release(device)
    return round(dt / n_cases, 5)


def _prob_batch_rows(n_cases: int = 8, *, device="cuda",
                     kernels: bool = False, patch=PATCH, volume=VOLUME,
                     overlap: int = OVERLAP) -> dict:
    """``--prob-map`` batch throughput: ``predict_cases_pipelined`` over
    ``n_cases`` cases with the probabilities moved as float32, float16 and
    uint8, seconds per case after a one-case warm-up."""
    config = predictor_config(kernels, patch=patch, volume=volume)
    model = _model(config, device)
    predictor = SlidingWindowPredictor(model, config, volume,
                                       overlap=overlap,
                                       patch_batch_size=PATCH_BATCH)
    rng = np.random.default_rng(0)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        cases = []
        for i in range(n_cases):
            case = os.path.join(d, f"case_{i}")
            os.makedirs(case)
            save_nifti(rng.normal(0, 1, volume).astype(np.float32),
                       os.path.join(case, "volume.nii.gz"))
            cases.append(case)
        for dtype, key in (("float32", "prob_batch_sec_per_case_f32"),
                           ("float16", "prob_batch_sec_per_case_f16"),
                           ("uint8", "prob_batch_sec_per_case_u8")):
            pairs = [(c, os.path.join(d, f"out_{dtype}", f"case_{i}"))
                     for i, c in enumerate(cases)]
            kw = dict(verbose=False, save_inputs=False,
                      output_label_map=False, prob_dtype=dtype)
            predict_cases_pipelined(pairs[:1], predictor, config, **kw)
            _sync(device)
            t0 = time.perf_counter()
            n = predict_cases_pipelined(pairs, predictor, config, **kw)
            _sync(device)
            out[key] = round((time.perf_counter() - t0) / n, 5)
    del model, predictor
    _release(device)
    return out


def _distort_step_rows(*, device="cuda", kernels: bool = False, patch=PATCH,
                       batches=(1, 8)) -> dict:
    """The augmented train step with and without scale distortion 0.25 at
    B=1 and B=8: 10 steps after one warm-up each."""
    rng = np.random.default_rng(0)
    out = {}
    for b in batches:
        for distort, key in ((None, f"train_step_b{b}_aug_sec"),
                             (0.25, f"train_step_b{b}_aug_distort_sec")):
            state, step = _trainer(
                distort_config(b, distort, kernels, patch=patch), device)
            x, y = _to(device, *_make_batch(rng, patch, b))
            out[key] = round(_step_seconds(step, state, x, y, 10, device), 5)
            del state, step
            _release(device)
    return out


def _direct_volume_infer(*, device="cuda", kernels: bool = False,
                         patch=PATCH, volume=VOLUME, n: int = 10,
                         warmup: int = 2) -> float:
    """One whole-volume forward and its label map (``predict --direct``):
    device seconds per forward (CUDA events) over ``n`` distinct volumes
    already on the card, after ``warmup`` others."""
    config = direct_config(kernels, patch=patch, volume=volume)
    model = _model(config, device)
    predictor = make_direct_predictor(model, config)
    rng = np.random.default_rng(0)
    vols = [torch.from_numpy(rng.normal(0, 1, (1,) + tuple(volume)).astype(
        np.float32)).to(device) for _ in range(warmup + n)]
    for v in vols[:warmup]:
        predictor.predict_labels_async(v)
    _sync(device)
    seconds = _device_seconds(device, lambda: [
        predictor.predict_labels_async(v) for v in vols[warmup:]])
    del model, predictor, vols
    _release(device)
    return round(seconds / n, 5)


def _dp_rank(rank: int, world: int, port: int, out_path: str, patch,
             steps: int) -> None:
    """One CPU rank of config 5: the data-parallel step on a global batch
    of 8, one warm-up then ``steps`` timed; rank 0 writes the result."""
    os.environ.update(rank_environment(rank, world, port))
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    try:
        cfg = dp_config(patch=patch)
        model = _model(cfg, "cpu")
        mesh = make_mesh(device="cpu")
        state = replicate_state(mesh, create_train_state(model, cfg))
        step = make_dp_train_step(
            model, cfg, mesh,
            generator=torch.Generator().manual_seed(rank + 1))
        x, y = _to("cpu", *_make_batch(np.random.default_rng(0), patch,
                                       cfg.batch_size))
        step(state, x, y, cfg.batch_size)
        t0 = time.perf_counter()
        for _ in range(steps):
            m = step(state, x, y, cfg.batch_size)
        loss = float(m["loss"])
        dt = (time.perf_counter() - t0) / steps
    finally:
        shutdown_distributed()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"dp_step_sec_cpu8": round(dt, 5), "loss": loss,
                       "devices": world,
                       "note": f"{world} gloo ranks on the host's CPU, one "
                               "process each; the card is not used"}, f)


def _config5_dp_cpu(*, ranks: int = DP_RANKS, patch=DP_PATCH,
                    steps: int = 5) -> dict:
    """Config 5: an 8-way data-parallel step on the CPU (depth 3, 16
    filters, 32^3, batch 8, fp32, augmentation), one process per rank: a
    pure-host canary."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dp.json")
        run_ranks(_dp_rank, ranks, (ranks, free_port(), out, tuple(patch),
                                    steps), DP_TIMEOUT_S)
        with open(out) as f:
            return json.load(f)


# ------------------------------------------------------------------- line


def counted(run):
    """``(run(), launches)``: the kernels' counts zeroed just before the run
    and read just after it."""
    for fn in KERNELS.values():
        fn.launches = 0
    out = run()
    return out, {k: fn.launches for k, fn in KERNELS.items()}


def collect(*, quick: bool = False, kernels: bool = False, device="cuda",
            patch=PATCH, volume=VOLUME, overlap: int = OVERLAP,
            n_reps: int = 5,
            train_patches_per_volume: int = TRAIN_PATCHES_PER_VOLUME,
            raw_shape=RAW_SHAPE, serve_cases: int = 4,
            backlog_cases: int = 8, prob_cases: int = 8,
            epoch_cases: int = 24, dp_ranks: int = DP_RANKS,
            dp_patch=DP_PATCH) -> dict:
    """Every row of the line into ``detail``, in bench.py's order, but for
    the names ``main`` adds (the device, the host's load and the canary)."""
    common = dict(device=device, kernels=kernels, patch=patch, volume=volume)
    with_overlap = dict(common, overlap=overlap)
    composite = dict(with_overlap, n_reps=n_reps,
                     train_patches_per_volume=train_patches_per_volume)
    base, launches = counted(lambda: _composite("unet", augment=False,
                                                **composite))
    detail = {"train_step_sec": base["train_step_sec"],
              "whole_volume_infer_sec": base["whole_volume_infer_sec"]}
    if not quick:
        detail["config2_augmented"] = _composite("unet", augment=True,
                                                 **composite)
        detail["config4_isensee"] = _composite("isensee", augment=False,
                                               **composite)
        detail["config5_dp"] = _config5_dp_cpu(ranks=dp_ranks,
                                               patch=dp_patch)
        detail["direct_volume_infer_sec"] = _direct_volume_infer(**common)
        detail["serve_case_sec"] = _serve_case_sec(n_cases=serve_cases,
                                                   **common)
        detail["serve_case_resample_sec"] = _serve_case_sec(
            raw_shape=raw_shape, croppable=True, n_cases=serve_cases,
            **common)
        detail["serve_case_resample_device_sec"] = _serve_case_sec(
            raw_shape=raw_shape, device_preprocess=True, croppable=True,
            n_cases=serve_cases, **common)
        detail["serve_backlog_sec_per_case"] = _serve_backlog_sec_per_case(
            n_cases=backlog_cases, raw_shape=raw_shape, **common)
        detail.update(_prob_batch_rows(n_cases=prob_cases, **with_overlap))
        detail.update(_distort_step_rows(device=device, kernels=kernels,
                                         patch=patch))
        detail.update(_batched_train_steps(device=device, kernels=kernels,
                                           patch=patch))
        detail["real_epoch"] = _real_epoch_row(n_cases=epoch_cases, **common)
        detail.update(_tta_volume_secs(**with_overlap))
    return {"base": base, "detail": detail,
            "kernels": kernels_detail(kernels, launches, device)}


def bench_line(load_before, *, quick: bool = False, kernels: bool = False,
               device="cuda", **sizes) -> dict:
    """The whole line: :func:`collect`, then the device, the host's load
    before and after, the canary and ``vs_baseline``."""
    rows = collect(quick=quick, kernels=kernels, device=device, **sizes)
    detail = rows["detail"]
    detail["device"] = device_name(device)
    load_after = os.getloadavg()
    detail["host_loadavg"] = {"before": [round(v, 2) for v in load_before],
                              "after": [round(v, 2) for v in load_after]}
    # the config-5 step is pure host compute: drift here is the host's
    detail["host_canary_sec"] = detail.get("config5_dp", {}).get(
        "dp_step_sec_cpu8")
    detail["kernels"] = rows["kernels"]
    busy = max(load_before[0], load_after[0])
    if busy > (os.cpu_count() or 1):
        print(f"bench: WARNING host loadavg {busy:.2f} above the "
              f"{os.cpu_count()} cores during the run — host-path rows "
              "(serve_*, prob_batch_*, host_canary_sec) are inflated",
              file=sys.stderr)
    value = rows["base"]["volumes_per_sec"]
    vs_baseline = None
    base_path = ROOT / "baseline_cpu_keras.json"
    if base_path.exists():
        cpu = json.loads(base_path.read_text())
        vs_baseline = round(value / cpu["composite_volumes_per_sec"], 2)
    return {"metric": "volumes/sec end-to-end fetal-brain seg (8x 64^3 "
                      "train steps + whole-volume Gaussian sliding-window "
                      "infer, pipelined stream)",
            "value": value, "unit": "volumes/sec",
            "vs_baseline": vs_baseline, "detail": detail}


CONFIG_ROWS = {1: ("config1+3 composite", "unet", False),
               3: ("config1+3 composite", "unet", False),
               2: ("config2 augmented composite", "unet", True),
               4: ("config4 isensee composite", "isensee", False)}


def config_line(config: int, *, kernels: bool = False, device="cuda",
                dp_ranks: int = DP_RANKS, dp_patch=DP_PATCH, **sizes) -> dict:
    """The line of ``--config N``: one composite, or config 5's rank step
    (on the CPU whatever ``device`` says, as in bench.py)."""
    if config == 5:
        return {"metric": "config5 DP step (8 gloo ranks on the CPU)",
                **_config5_dp_cpu(ranks=dp_ranks, patch=dp_patch)}
    metric, model_name, augment = CONFIG_ROWS[config]
    res, launches = counted(lambda: _composite(
        model_name, augment=augment, device=device, kernels=kernels,
        **sizes))
    return {"metric": metric, **res,
            "kernels": kernels_detail(kernels, launches, device, model_name)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="The port's bench: root bench.py's JSON line on the "
                    "card.")
    ap.add_argument("--config", type=int, choices=[1, 2, 3, 4, 5],
                    help="measure a single BASELINE config")
    ap.add_argument("--quick", action="store_true",
                    help="composite (configs 1+3) only")
    ap.add_argument("--kernels", choices=["off", "on"], default="off",
                    help="both kernel switches for every row")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> None:
    load_before = os.getloadavg()
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is false; this "
                         "bench measures the card (pass --device cpu to run "
                         "it on the CPU)")
    kernels = args.kernels == "on"
    # stdout carries the one JSON line: anything a row prints goes to stderr
    with contextlib.redirect_stdout(sys.stderr):
        if kernels and args.device == "cuda":
            cuda_lib.build()
        if args.config is not None:
            line = config_line(args.config, kernels=kernels,
                               device=args.device)
        else:
            line = bench_line(load_before, quick=args.quick, kernels=kernels,
                              device=args.device)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
