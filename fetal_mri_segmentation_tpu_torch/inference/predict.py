"""Per-case serving: ad-hoc NIfTI cases and the dataset's validation
split (port of ``fetal_mri_segmentation_tpu/inference/predict.py``).

``preprocess_case`` runs dataset ingest's preprocessing (shared background
crop, resample to ``config.image_shape``, the configured normalization) on
the host, or crops on the host and resamples and normalizes on the device
(``device_pre``, ``ops/resample.py::DevicePreprocessor``). ``predict_case``
predicts one case and writes the JAX package's per-case tree:
``data_<modality>.nii.gz``, ``truth.nii.gz`` when the case has one, and
``prediction.nii.gz`` (the label map, or with ``output_label_map=False``
the probability map). ``predict_cases_pipelined`` writes the same trees
for a sequence of cases with two stages in flight: case i+1's host
preprocessing and upload run while case i computes on the device, and
every NIfTI write runs on one worker thread.

``run_validation_cases`` predicts every case of the validation split
from the dataset (``data/build.py``, already preprocessed) into
``<output_dir>/<subject id or validation_case_<i>>/`` through the same
pipeline. ``load_serving_model`` loads the port's own checkpoint
(``training/checkpoint.py``) or an exported flax ``.npz``;
``load_global_moments`` reads a ``global`` dataset's training moments.

The predictors are the sliding window (``inference/sliding_window.py``) and
the direct whole-volume predictor (``parallel/spatial.py``), each with
optional test-time augmentation (``build_serving_predictor``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
from fetal_mri_segmentation_tpu_torch.data.normalize import normalize_case
from fetal_mri_segmentation_tpu_torch.inference.labelmaps import (
    label_map_dtype, prediction_to_image)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.ops.resample import DevicePreprocessor
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_direct_predictor)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.geometry import (
    process_case_images, resample_to_shape, zoomed_affine)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti, save_nifti
from fetal_mri_segmentation_tpu_torch.utils.params import (
    OPT_PREFIX, from_flax)
from fetal_mri_segmentation_tpu_torch.utils.residency import (
    _QUANT_SCALE, resolve_prob_transfer)

_GLOBAL_MOMENTS = (
    "normalization='global' needs the training dataset's (mean, std): pass "
    "global_moments (load_global_moments(config.data_file) reads them from "
    "a dataset that was built with normalization='global')")


def load_global_moments(data_file_path: str):
    """Training-distribution ``(mean, std)`` persisted by the dataset
    builder for ``normalization="global"`` (``meta.json`` of the port's
    layout, the attrs of the JAX package's HDF5 file); None when the
    dataset is absent or holds none."""
    if not os.path.exists(data_file_path):
        return None
    with open_data_file(data_file_path) as data_file:
        return data_file.global_moments


def resolve_case_files(path: str, config) -> tuple:
    """``(modality_files, truth_file_or_None)`` for a case directory
    (``<dir>/<modality>.nii[.gz]`` per training modality, plus
    ``truth.nii[.gz]`` when present) or a single one-modality NIfTI file.
    The JAX package's rule, copied: its module imports jax."""
    if os.path.isdir(path):
        files = []
        for m in config.training_modalities:
            for ext in (".nii.gz", ".nii"):
                p = os.path.join(path, m + ext)
                if os.path.exists(p):
                    files.append(p)
                    break
            else:
                raise FileNotFoundError(
                    f"{path}: missing modality file {m}.nii[.gz] "
                    f"(training_modalities={config.training_modalities})")
        truth = None
        for ext in (".nii.gz", ".nii"):
            p = os.path.join(path, "truth" + ext)
            if os.path.exists(p):
                truth = p
                break
        return files, truth
    if len(config.training_modalities) != 1:
        raise ValueError(
            f"{path}: a bare NIfTI file only works for single-modality "
            f"configs; this config trains on "
            f"{config.training_modalities} — pass the case DIRECTORY")
    return [path], None


def preprocess_case(input_path: str, config, *, crop: bool = True,
                    global_moments=None, device_pre=None):
    """Builder-identical preprocessing of one NIfTI case.

    Returns ``(data, affine, truth_image)``: the normalized (C, D, H, W)
    stack (float32 numpy on the host path; a device tensor in the
    preprocessor's dtype with ``device_pre``), the build-adjusted affine
    and the resampled truth NiftiImage or None. With ``device_pre`` the
    host only reads and crops; the truth is still resampled on the host
    (order 0 is cheap and keeps its bytes identical to the host path)."""
    files, truth_file = resolve_case_files(input_path, config)
    all_files = files + ([truth_file] if truth_file else [])
    # explicit: without a truth file the default ("last file is the label")
    # would nearest-resample the last modality
    label_indices = [len(all_files) - 1] if truth_file else []

    if device_pre is not None:
        # the device path normalizes with device_pre's own settings: a
        # mismatch would shift predictions into another intensity
        # distribution than training's
        if device_pre.normalization != config.normalization:
            raise ValueError(
                f"device_pre was built with normalization="
                f"{device_pre.normalization!r} but config.normalization="
                f"{config.normalization!r} — predictions would be shifted "
                "into a different intensity distribution than training")
        host_moments = getattr(device_pre, "_host_moments", None)
        if (global_moments is not None and host_moments is not None
                and not (np.allclose(global_moments[0], host_moments[0])
                         and np.allclose(global_moments[1],
                                         host_moments[1]))):
            raise ValueError(
                "device_pre's global normalization moments differ from the "
                "global_moments passed to preprocess_case — build the "
                "DevicePreprocessor with the same training moments")
        cropped = process_case_images(
            [load_nifti(f) for f in all_files], image_shape=None, crop=crop,
            label_indices=label_indices)
        old_shape = tuple(cropped[0].shape[:3])
        affine = (zoomed_affine(cropped[0].affine, old_shape,
                                config.image_shape)
                  if old_shape != tuple(config.image_shape)
                  else cropped[0].affine)
        data = device_pre([img.get_fdata(dtype=np.float32)
                           for img in cropped[:len(files)]])
        truth_image = None
        if truth_file:
            truth_image = cropped[-1]
            if tuple(truth_image.shape[:3]) != tuple(config.image_shape):
                truth_image = resample_to_shape(
                    truth_image, config.image_shape, "nearest")
        return data, affine, truth_image

    if config.normalization == "global" and global_moments is None:
        raise ValueError(_GLOBAL_MOMENTS)
    images = process_case_images(
        [load_nifti(f) for f in all_files], image_shape=config.image_shape,
        crop=crop, label_indices=label_indices)
    data = np.stack([img.get_fdata(dtype=np.float32)
                     for img in images[:len(files)]], axis=0)
    mean, std = global_moments if global_moments else (None, None)
    data = normalize_case(data, config.normalization, mean=mean, std=std)
    return data, images[0].affine, (images[-1] if truth_file else None)


def _direct_submit(target, fn, *args, **kwargs):
    fn(*args, **kwargs)


def _scale_binary_label(label_map, config):
    """Binary maps carry the configured label value (reference:
    prediction_to_image — data > threshold -> labels[0])."""
    if config.n_labels == 1 and config.labels:
        dt = label_map_dtype([config.labels[0]])
        return label_map.astype(dt) * dt.type(config.labels[0])
    return label_map


def _write_prediction(label_map, config, case_dir: str, affine,
                      submit=_direct_submit):
    """The one place the per-case label artifact is made (binary label
    scaling and the NIfTI write), for the per-case and pipelined paths."""
    label_map = _scale_binary_label(label_map, config).astype(
        label_map_dtype(config.labels or range(1, config.n_labels + 1)))
    path = os.path.join(case_dir, "prediction.nii.gz")
    submit(path, save_nifti, label_map, path, affine=affine)
    return label_map


def _write_probability(probability, config, out_dir: str, affine,
                       submit=_direct_submit, scl_slope: float = 1.0):
    """The one place the per-case probability artifact is made. With
    ``scl_slope != 1`` the array is a fixed-point map (uint8 / uint16)
    stored as it is with NIfTI value scaling: 4x / 2x smaller files and
    gzip time than float32, and every scl-aware reader (this package's
    loader, nibabel) returns the [0, 1] floats."""
    image = prediction_to_image(probability, affine, label_map=False,
                                labels=config.labels)
    path = os.path.join(out_dir, "prediction.nii.gz")
    submit(path, save_nifti, image, path, scl_slope=scl_slope)
    return probability


def _save_modality_f32(arr, path, affine):
    """Write one modality as float32; a device tensor is copied to the host
    here, inside the IO worker, off the serving loop."""
    if isinstance(arr, torch.Tensor):
        arr = arr.float().cpu().numpy()
    save_nifti(np.asarray(arr, dtype=np.float32), path, affine=affine)


def queue_input_writes(data, truth_image, config, out_dir, affine,
                       submit=_direct_submit) -> None:
    """Queue the per-case ``data_<modality>`` and ``truth`` NIfTI writes,
    shared by the per-case and pipelined paths."""
    for i, modality in enumerate(config.training_modalities):
        path = os.path.join(out_dir, f"data_{modality}.nii.gz")
        submit(path, _save_modality_f32, data[i], path, affine)
    if truth_image is not None:
        path = os.path.join(out_dir, "truth.nii.gz")
        submit(path, save_nifti,
               truth_image.get_fdata(dtype=np.float32).astype(np.uint8),
               path, affine=affine)


def predict_case(input_path: str, out_dir: str, predictor, config, *,
                 threshold: float = 0.5, save_inputs: bool = True,
                 crop: bool = True, global_moments=None, io_submit=None,
                 device_pre=None, output_label_map: bool = True):
    """Predict one NIfTI case and write its output tree; returns the
    written label map (or the probability map with
    ``output_label_map=False``). ``io_submit``: optional
    ``submit(target, fn, *args, **kwargs)`` that queues each write
    (``target`` is its destination path)."""
    data, affine, truth_image = preprocess_case(
        input_path, config, crop=crop, global_moments=global_moments,
        device_pre=device_pre)
    os.makedirs(out_dir, exist_ok=True)
    submit = io_submit if io_submit is not None else _direct_submit
    if save_inputs:
        queue_input_writes(data, truth_image, config, out_dir, affine,
                           submit)
    if not output_label_map:
        return _write_probability(predictor(data), config, out_dir, affine,
                                  submit)
    return _write_prediction(predictor.predict_labels(data, threshold),
                             config, out_dir, affine, submit)


def _drive_pipeline(case_stream, dispatch, finalize) -> int:
    """The two-stage overlap shared by the label and probability pipelines.

    ``case_stream`` yields ``(data, affine, out_dir, done_msg_or_None)``,
    preprocessing each case as it is pulled: that is what overlaps the
    previous case's device work. Each case is dispatched at once (its work
    enqueued on the device); case i is finalized (the D2H copy, which waits
    for it, and the queued write) after case i+1 is dispatched. The last
    dispatched case is finalized even when a later case's preprocessing
    raises, and then the original exception propagates."""
    n = 0
    pending = None  # (out_dev, out_dir, affine, done_msg)
    try:
        for data, affine, out_dir, msg in case_stream:
            out_dev = dispatch(data)
            if pending is not None:
                finalize(pending)
            pending = (out_dev, out_dir, affine, msg)
            n += 1
    except BaseException:
        if pending is not None:
            try:
                finalize(pending)
            except Exception:
                pass  # best effort: never mask the original error
        raise
    if pending is not None:
        finalize(pending)
    return n


def _msg_submit(submit, msg):
    """Wrap ``submit`` so ``msg`` prints from the IO worker after that
    case's prediction write has run, never before."""
    if msg is None:
        return submit

    def write_submit(target, fn, *a, _msg=msg, **kw):
        def run():
            fn(*a, **kw)
            print(_msg, flush=True)
        submit(target, run)
    return write_submit


def _drive_label_pipeline(case_stream, predictor, config, threshold,
                          submit) -> int:
    def finalize(p):
        out_dev, out_dir, affine, msg = p
        _write_prediction(predictor.unpack_labels(out_dev), config, out_dir,
                          affine, _msg_submit(submit, msg))

    return _drive_pipeline(
        case_stream,
        lambda data: predictor.predict_labels_async(data, threshold),
        finalize)


def _drive_prob_pipeline(case_stream, predictor, config, submit,
                         transfer_dtype: str = "float32") -> int:
    """Probability maps through the same overlap, with the reduced
    precision transfers: fp16 halves the D2H bytes (<= 4.9e-4), and the
    fixed-point uint8 / uint16 maps stay integer all the way to disk via
    NIfTI ``scl_slope``."""
    kind = resolve_prob_transfer(transfer_dtype)

    def finalize(p):
        out_dev, out_dir, affine, msg = p
        if kind in _QUANT_SCALE:
            _write_probability(out_dev.cpu().numpy(), config, out_dir,
                               affine, _msg_submit(submit, msg),
                               scl_slope=1.0 / _QUANT_SCALE[kind])
            return
        _write_probability(predictor.unpack_prob(out_dev), config, out_dir,
                           affine, _msg_submit(submit, msg))

    return _drive_pipeline(
        case_stream,
        lambda data: predictor.predict_prob_async(data, transfer_dtype),
        finalize)


def predict_cases_pipelined(cases, predictor, config, *,
                            threshold: float = 0.5, global_moments=None,
                            save_inputs: bool = True, device_pre=None,
                            verbose: bool = True,
                            output_label_map: bool = True,
                            prob_dtype: str = "float32") -> int:
    """Predict ``(input_path, out_dir)`` pairs with the two-stage pipeline:
    the same artifacts as :func:`predict_case` per case, with case i's host
    preprocessing and upload overlapping case i-1's device work, and every
    NIfTI write on one worker thread. Errors propagate (a CLI batch fails
    loudly), and cases finished before the failing one keep their files.
    ``output_label_map=False`` writes probability maps, moved to the host
    in ``prob_dtype``. Returns the number of cases predicted."""
    futures = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        def submit(target, fn, *a, **kw):
            futures.append(pool.submit(fn, *a, **kw))

        def stream():
            for path, out_dir in cases:
                data, affine, truth_image = preprocess_case(
                    path, config, global_moments=global_moments,
                    device_pre=device_pre)
                os.makedirs(out_dir, exist_ok=True)
                if save_inputs:
                    queue_input_writes(data, truth_image, config, out_dir,
                                       affine, submit)
                yield (data, affine, out_dir,
                       f"{path} -> {out_dir}/prediction.nii.gz"
                       if verbose else None)

        if output_label_map:
            n = _drive_label_pipeline(stream(), predictor, config,
                                      threshold, submit)
        else:
            n = _drive_prob_pipeline(stream(), predictor, config, submit,
                                     transfer_dtype=prob_dtype)
    for f in futures:  # surface any write error once all IO drained
        f.result()
    return n


def _load_case(case_index, out_dir, data_file, config, submit,
               save_inputs: bool):
    """Read one case from the dataset; queue the reference's input and
    truth NIfTIs."""
    os.makedirs(out_dir, exist_ok=True)
    affine = np.asarray(data_file.root.affine[case_index])
    # a copy: the dataset's memory map is read-only, and the predictor
    # stages the volume through pinned memory
    data = np.array(data_file.root.data[case_index], np.float32)
    if save_inputs:
        for i, modality in enumerate(config.training_modalities):
            path = os.path.join(out_dir, f"data_{modality}.nii.gz")
            submit(path, save_nifti, data[i], path, affine=affine)
        truth = np.asarray(data_file.root.truth[case_index][0])
        path = os.path.join(out_dir, "truth.nii.gz")
        submit(path, save_nifti, truth.astype(np.uint8), path, affine=affine)
    return data, affine


def run_validation_case(case_index: int, out_dir: str, data_file, config,
                        predictor, output_label_map: bool = True,
                        threshold: float = 0.5, save_inputs: bool = True,
                        io_submit=None) -> np.ndarray:
    """Predict one stored case; writes the reference's per-case output tree
    and returns the written label map (or the probability map).
    ``io_submit`` as in :func:`predict_case`."""
    submit = io_submit if io_submit is not None else _direct_submit
    data, affine = _load_case(case_index, out_dir, data_file, config, submit,
                              save_inputs)
    if output_label_map:
        return _write_prediction(predictor.predict_labels(data, threshold),
                                 config, out_dir, affine, submit)
    return _write_probability(predictor(data), config, out_dir, affine,
                              submit)


def _single_device_only(mesh, spatial_mesh) -> None:
    """``mesh`` / ``spatial_mesh`` carry a device count here (the port has
    no mesh object): more than one device raises by name."""
    if mesh is not None and int(mesh) > 1:
        raise NotImplementedError(
            f"mesh={mesh}: the patch grid sharded over devices is not "
            "ported yet (ROADMAP.md queue 1, DDP)")
    if spatial_mesh is not None and int(spatial_mesh) > 1:
        raise NotImplementedError(
            f"spatial_mesh={spatial_mesh}: depth-axis sharding is not "
            "ported yet (ROADMAP.md queue 1, spatial sharding over more "
            "than one device)")


def run_validation_cases(validation_keys_file: str, model, data_file, config,
                         output_dir: str = "prediction", overlap: int = 16,
                         threshold: float = 0.5,
                         output_label_map: bool = True, permute=False,
                         patch_batch_size: int = 8, mesh=None,
                         spatial_mesh=None, prob_dtype: str = "float32",
                         direct: bool = False, device=None) -> int:
    """Predict every validation case into ``output_dir/<subject id>`` (or
    ``validation_case_<i>`` for a dataset without ids). Reference:
    ``prediction.py::run_validation_cases``: the same output tree, one
    predictor reused across cases (all volumes share the dataset's
    ``image_shape``), the two-stage pipeline of
    :func:`predict_cases_pipelined` with the NIfTI writes on a worker pool.

    ``permute``: False | True/"permute" | "flips" (``resolve_tta``).
    ``direct`` runs one whole-volume forward per case (the JAX package's
    one-device spatial mesh). ``mesh`` and ``spatial_mesh`` are device
    counts here, and above one device they raise. Returns the number of
    cases."""
    _single_device_only(mesh, spatial_mesh)
    validation_indices = pickle_load(validation_keys_file)
    image_shape = tuple(data_file.root.data.shape[-3:])
    device = None if device is None else resolve_device(device)
    if direct:
        predictor = make_direct_predictor(model, config, tta=permute,
                                          device=device)
        predictor._check_shape(image_shape)
    else:
        predictor = SlidingWindowPredictor(
            model, config, image_shape=image_shape, overlap=overlap,
            patch_batch_size=patch_batch_size, device=device, tta=permute)
    subject_ids = data_file.subject_ids

    def case_dir_of(index):
        name = (subject_ids[index] if subject_ids
                else f"validation_case_{index}")
        return os.path.join(output_dir, name)

    futures = []
    with ThreadPoolExecutor(max_workers=2) as pool:
        def submit(target, fn, *a, **kw):
            futures.append(pool.submit(fn, *a, **kw))

        def stream():
            for index in validation_indices:
                case_dir = case_dir_of(index)
                data, affine = _load_case(index, case_dir, data_file, config,
                                          submit, save_inputs=True)
                yield data, affine, case_dir, None

        if output_label_map:
            n = _drive_label_pipeline(stream(), predictor, config, threshold,
                                      submit)
        else:
            n = _drive_prob_pipeline(stream(), predictor, config, submit,
                                     transfer_dtype=prob_dtype)
    for f in futures:  # surface any write error once all IO drained
        f.result()
    return n


def load_serving_model(config, params: Optional[str] = None,
                       device="cuda"):
    """Build the configured model on ``device`` and load its weights: with
    no ``params`` the model state of the port's own checkpoint at
    ``config.model_file`` (``training/checkpoint.py``), else the flattened
    flax params (and ``batch_stats``) that ``tools/export_params_npz.py``
    wrote as an ``.npz``."""
    path = params if params is not None else config.model_file
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path}: no weights to serve. Either train with python -m "
            "fetal_mri_segmentation_tpu_torch.train (it writes the "
            "checkpoint config.model_file, read when --params is not "
            "given), or pass --params PARAMS.npz (flattened flax params "
            "from tools/export_params_npz.py)")
    model = build_model(config, device)
    if params is None:
        payload = torch.load(path, map_location=resolve_device(device),
                             weights_only=True)
        state = payload["model"]
    else:
        with np.load(path) as flat:
            state = from_flax({k: flat[k] for k in flat.files
                               if not k.startswith(OPT_PREFIX)})
    model.load_state_dict(state)
    return model


def make_device_preprocessor(model, config, moments=None):
    """The serving ingest's ``DevicePreprocessor`` for ``model``: on the
    model's device, staged and handed over in the model's dtype (a bf16
    model uploads the raw volume in bf16, half the bytes, and the predictor
    casts nothing). ``normalization="global"`` takes ``moments``, or reads
    them from ``config.data_file``."""
    if config.normalization == "global" and moments is None:
        moments = load_global_moments(config.data_file)
        if moments is None:
            raise ValueError(_GLOBAL_MOMENTS)
    dtype = (torch.bfloat16 if model.dtype == torch.bfloat16
             else torch.float32)
    return DevicePreprocessor(
        config.image_shape, config.normalization, moments=moments,
        compute_dtype=dtype, transfer_dtype=dtype,
        device=next(model.parameters()).device)


def resolve_tta(tta: bool, tta_mode):
    """``--tta`` / ``--tta-mode`` as the predictor's ``tta`` argument
    (False | "permute" | "flips"): ``--tta-mode`` implies ``--tta``, and
    bare ``--tta`` is the 48-symmetry average."""
    return tta_mode or ("permute" if tta else False)


def build_serving_predictor(model, config, *, direct: bool = False,
                            tta=False, overlap: int = 16,
                            patch_batch_size: int = 8, device=None):
    """One predictor factory for both serving entry points: the sliding
    window, or with ``direct`` the whole-volume forward. ``tta``: False |
    True/"permute" | "flips", patch-level for the sliding window and
    volume-level for the direct predictor. The direct geometry (dims
    divisible by 2^(depth-1), a cube for "permute") is checked here against
    ``config.image_shape``, so a server refuses a bad combination at start
    and not case by case."""
    device = None if device is None else resolve_device(device)
    if direct:
        predictor = make_direct_predictor(model, config, tta=tta,
                                          device=device)
        predictor._check_shape(tuple(config.image_shape))
        return predictor
    return SlidingWindowPredictor(
        model, config, image_shape=config.image_shape, overlap=overlap,
        patch_batch_size=patch_batch_size, device=device, tta=tta)
