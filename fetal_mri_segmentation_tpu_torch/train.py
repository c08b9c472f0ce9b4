"""Training entry point of the port, on the GPU by default.

    python -m fetal_mri_segmentation_tpu_torch.train --config CFG \\
        [--data-dir DIR] [--model {unet,isensee}] [--overwrite] [--seed N]
        [--init-params FILE.npz] [--profile LOGDIR] [--device cuda]
    python -m fetal_mri_segmentation_tpu_torch.train --smoke [--device cpu]

Port of the root ``train.py``, step for step: build the dataset from
``<data_dir>/<case>/{<modality>.nii.gz..., truth.nii.gz}`` unless it exists
(or ``--overwrite``), build the model, make a fresh state from ``--seed``
or resume ``config.model_file`` with the generators fast-forwarded to the
checkpoint's epoch, create the generators (the split is pickled to
``config.training_file`` / ``validation_file``) and train. The dataset is
the port's directory layout (``data/build.py``); an HDF5 file of the JAX
package at ``config.data_file`` is read where h5py is installed.

``--init-params FILE.npz`` starts from the variables, and the Adam moments
when the file holds them, that ``tools/export_params_npz.py`` wrote from a
checkpoint of the JAX package. ``--profile LOGDIR`` writes a
``torch.profiler`` trace of the run. ``--smoke`` trains a tiny model for
two epochs on synthetic cases it writes itself. Not ported, each refused by
name: ``--from-keras`` (Keras interop), more than one device (DDP, spatial
sharding) and the device-resident case cache.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys
import time
from typing import Optional

import torch

from fetal_mri_segmentation_tpu_torch.config import Config, check_supported
from fetal_mri_segmentation_tpu_torch.data.build import (
    dataset_bytes, open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
    get_training_and_validation_generators)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import CheckpointIO
from fetal_mri_segmentation_tpu_torch.training.loop import train_model
from fetal_mri_segmentation_tpu_torch.training.state import (
    create_train_state)
from fetal_mri_segmentation_tpu_torch.utils.params import (
    from_flax, init_flax_like, load_npz_train_state)
from fetal_mri_segmentation_tpu_torch.utils.profiling import trace


def fetch_training_data_files(data_dir: str, modalities, truth_name="truth"):
    """Glob per-case [mod1.nii.gz, ..., truth.nii.gz] lists.

    Reference: train.py::fetch_training_data_files.
    """
    training_data_files = []
    subject_ids = []
    for case_dir in sorted(glob.glob(os.path.join(data_dir, "*"))):
        if not os.path.isdir(case_dir):
            continue
        files = []
        ok = True
        for name in tuple(modalities) + (truth_name,):
            matches = (glob.glob(os.path.join(case_dir, name + ".nii.gz"))
                       or glob.glob(os.path.join(case_dir, name + ".nii")))
            if not matches:
                ok = False
                break
            files.append(matches[0])
        if ok:
            training_data_files.append(files)
            subject_ids.append(os.path.basename(case_dir))
    return training_data_files, subject_ids


def check_flags(config, *, from_keras=None) -> None:
    """The port's refusals of what it does not train with yet, before
    anything is built."""
    if from_keras:
        raise NotImplementedError(
            "--from-keras: Keras interop is not ported yet (ROADMAP.md "
            "queue 1, interop)")
    check_supported(config)  # more than one device, a fold tuple
    if config.device_case_cache == "on":
        raise NotImplementedError(
            "device_case_cache='on': the device-resident case cache is not "
            "ported yet (ROADMAP.md queue 1, the device case cache); the "
            "default 'auto' trains from the host pipeline")


def main(config, data_dir: str, overwrite: bool = False, verbose: bool = True,
         profile_dir: Optional[str] = None, seed: int = 0,
         from_keras: Optional[str] = None, *,
         init_params: Optional[str] = None, device: str = "cuda"):
    """Build the dataset if needed, then train ``config``'s model on
    ``device``; returns the final ``TrainState``."""
    check_flags(config, from_keras=from_keras)
    # one overwrite for both surfaces (the CLI argument and the config key):
    # train_model gates its restore on config.overwrite
    overwrite = bool(overwrite or config.overwrite)
    config.overwrite = overwrite

    # 1. dataset build (cached unless overwrite)
    if overwrite or not os.path.exists(config.data_file):
        files, subject_ids = fetch_training_data_files(
            data_dir, config.training_modalities)
        if not files:
            mods = ", ".join(f"{m}.nii[.gz]"
                             for m in (config.training_modalities
                                       or config.all_modalities))
            sys.exit(
                f"no cases found under {data_dir} — each case needs its own "
                f"directory containing {mods} AND truth.nii[.gz] "
                "(incomplete case dirs are skipped)")
        print(f"building {config.data_file} from {len(files)} cases...")
        t0 = time.perf_counter()
        write_data_to_file(files, config.data_file,
                           image_shape=config.image_shape,
                           subject_ids=subject_ids,
                           normalize=config.normalization)
        if verbose:
            print(f"built {config.data_file}: {len(files)} cases, "
                  f"{dataset_bytes(config.data_file)} bytes in "
                  f"{time.perf_counter() - t0:.4f} s", flush=True)
    data_file = open_data_file(config.data_file)

    try:
        # 2. model and state (train_model restores the checkpoint)
        ckpt_io = CheckpointIO(config.model_file)
        resuming = ckpt_io.exists() and not overwrite
        if init_params and resuming:
            sys.exit(
                f"--init-params {init_params}: a checkpoint already exists "
                f"at {config.model_file} — resuming it would ignore the "
                "file. Pass --overwrite to start from the file, or a fresh "
                "model_file")
        model = build_model(config, device)
        state = create_train_state(model, config)
        if init_params:
            with_adam = load_npz_train_state(state, init_params)
            if verbose:
                print(f"[init] {init_params}: variables"
                      + (f" and Adam state at step {state.step}, lr "
                         f"{state.learning_rate:g}" if with_adam else ""))
        elif not resuming:
            model.load_state_dict(from_flax(init_flax_like(config, seed)))
        # data-order exact resume: fast-forward the generators by the
        # start_epoch * steps batches the interrupted run consumed
        start_epoch = (ckpt_io.peek_epoch() or 0) if resuming else 0

        # 3. generators
        tg, n_train, vg, n_val = get_training_and_validation_generators(
            data_file, batch_size=config.batch_size, n_labels=config.n_labels,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            data_split=config.validation_split, overwrite=overwrite,
            labels=config.labels, patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=config.skip_blank, seed=seed,
            start_epoch=start_epoch)
        if verbose:
            print(f"training on {next(model.parameters()).device}; "
                  f"{n_train} steps/epoch, {n_val} val steps")

        # 4. train
        with (trace(profile_dir) if profile_dir
              else contextlib.nullcontext()):
            return train_model(model, state, config, tg, vg, n_train, n_val,
                               seed=seed, verbose=verbose)
    finally:
        data_file.close()


def run_smoke(tmpdir: Optional[str] = None, device: str = "cuda"):
    """Synthetic end to end: write cases, train a tiny model 2 epochs."""
    import tempfile

    from fetal_mri_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)

    tmpdir = tmpdir or os.path.join(tempfile.gettempdir(),
                                    "fetal_smoke_torch")
    os.makedirs(tmpdir, exist_ok=True)
    write_synthetic_dataset(os.path.join(tmpdir, "cases"), n_cases=4,
                            shape=(24, 24, 24))
    cfg = Config(image_shape=(16, 16, 16), patch_shape=(8, 8, 8),
                 validation_patch_overlap=2,
                 training_patch_start_offset=(2, 2, 2),
                 depth=2, n_base_filters=4, batch_size=4, n_epochs=2,
                 data_file=os.path.join(tmpdir, "data"),
                 model_file=os.path.join(tmpdir, "model.ckpt"),
                 training_file=os.path.join(tmpdir, "training_ids.pkl"),
                 validation_file=os.path.join(tmpdir, "validation_ids.pkl"),
                 training_log=os.path.join(tmpdir, "training.log"),
                 compute_dtype="float32", overwrite=True)
    cfg.save(os.path.join(tmpdir, "config.json"))
    main(cfg, os.path.join(tmpdir, "cases"), overwrite=True, device=device)
    print("smoke run complete; artifacts in", tmpdir)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", help="JSON config (reference key names)")
    ap.add_argument("--data-dir", default=None,
                    help="directory of per-case NIfTI folders (overrides "
                         "the config's data_dir; default: data)")
    ap.add_argument("--model", dest="model_name",
                    choices=["unet", "isensee"], default=None)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic end-to-end smoke run")
    ap.add_argument("--profile", metavar="LOGDIR", default=None,
                    help="write a torch.profiler trace of training")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for init, patch sampling and augmentation")
    ap.add_argument("--init-params", metavar="FILE_NPZ", default=None,
                    help="start from the variables (and Adam state) that "
                         "tools/export_params_npz.py wrote")
    ap.add_argument("--from-keras", metavar="MODEL_H5", default=None,
                    help="not ported yet")
    ap.add_argument("--device", default="cuda")
    return ap


if __name__ == "__main__":
    args = _parser().parse_args()
    if args.smoke:
        run_smoke(device=args.device)
        sys.exit(0)
    cfg = Config.load(args.config) if args.config else Config()
    if args.model_name:
        cfg.model_name = args.model_name
    if args.overwrite:
        cfg.overwrite = True
    main(cfg, args.data_dir or cfg.data_dir or "data",
         overwrite=cfg.overwrite, profile_dir=args.profile, seed=args.seed,
         from_keras=args.from_keras, init_params=args.init_params,
         device=args.device)
