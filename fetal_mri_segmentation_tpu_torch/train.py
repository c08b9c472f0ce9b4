"""Training entry point of the port, on the GPU by default.

    python -m fetal_mri_segmentation_tpu_torch.train --config CFG \\
        [--data-dir DIR] [--model {unet,isensee}] [--overwrite] [--seed N]
        [--init-params FILE.npz] [--profile LOGDIR] [--device cuda]
        [--share-devices]
    torchrun --nproc-per-node N -m fetal_mri_segmentation_tpu_torch.train ...
    python -m fetal_mri_segmentation_tpu_torch.train --smoke [--device cpu]

Port of the root ``train.py``, step for step: build the dataset from
``<data_dir>/<case>/{<modality>.nii.gz..., truth.nii.gz}`` unless it exists
(or ``--overwrite``), build the model, make a fresh state from ``--seed``
or resume ``config.model_file`` with the generators fast-forwarded to the
checkpoint's epoch, create the generators (the split is pickled to
``config.training_file`` / ``validation_file``) and train. The dataset is
the port's directory layout (``data/build.py``); an HDF5 file of the JAX
package at ``config.data_file`` is read where h5py is installed.

The device-resident case cache (``pipeline/device_cache.py``) is on by
default (``device_case_cache="auto"``): when the padded cases fit the
device's free memory they are uploaded once and every step feeds indices;
when only some fit, those stay resident and the rest host-stage; "on"
raises where "auto" would fall back to host staging, "off" keeps the host
pipeline. The run says which it chose.

More than one device trains data-parallel
(``parallel/data_parallel.py``), one process per device; with
``spatial_devices`` S > 1 on a hybrid mesh of N / S data rows of S ranks
that split each patch's depth (``parallel/spatial.py``; S must divide N).
Under a launcher (``torchrun``: ``WORLD_SIZE`` is set) this process is one
rank. Started alone with ``num_devices`` N > 1 (None: every visible card)
it builds the dataset and the kernels once and starts N ranks itself
(``torch.multiprocessing.spawn``). Rank 0 writes the checkpoint and the
log. ``--share-devices`` lets the ranks share cards where there are fewer
cards than ranks (over gloo: a check of the multi-rank path, no speed-up).

``--init-params FILE.npz`` starts from the variables, and the Adam moments
when the file holds them, that ``tools/export_params_npz.py`` wrote from a
checkpoint of the JAX package. ``--profile LOGDIR`` writes a
``torch.profiler`` Chrome trace of the run (``*.pt.trace.json``, with the
port's ``fetal.train.*`` ranges) and the port's span records beside it
(``*.spans.json``: name, request, start, end and host ms of each
``train.step`` and its phases; ``utils/profiling.py``). ``--smoke``
trains a tiny model for two epochs on synthetic cases it writes itself.
``--from-keras MODEL_H5`` takes the architecture, the weights and, where
the file holds them, the Adam state from a reference Keras ``.h5``
(``utils/keras_migrate.py``; needs h5py); it refuses to run over an
existing checkpoint without ``--overwrite``, as the root ``train.py``
does.
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
import torch.distributed as dist

from fetal_mri_segmentation_tpu_torch.config import Config, check_supported
from fetal_mri_segmentation_tpu_torch.data.build import (
    dataset_bytes, open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.models import mednext, swin_unetr
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import make_mesh
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    build_kernels_before_ranks, free_port, initialize_distributed,
    rank_environment, run_ranks, shutdown_distributed)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_hybrid_mesh)
from fetal_mri_segmentation_tpu_torch.pipeline.device_cache import (
    maybe_build_device_cache)
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
    get_training_and_validation_generators)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import CheckpointIO
from fetal_mri_segmentation_tpu_torch.training.loop import train_model
from fetal_mri_segmentation_tpu_torch.training.state import (
    create_train_state)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.keras_migrate import (
    derive_config_from_keras_h5, load_old_model)
from fetal_mri_segmentation_tpu_torch.utils.params import (
    from_flax, init_flax_like, load_npz_train_state)
from fetal_mri_segmentation_tpu_torch.utils.profiling import trace

# the families with no flax counterpart start from their own seeded init
OWN_INIT = {"swin_unetr": swin_unetr.init_parameters,
            "mednext": mednext.init_parameters}


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


def check_flags(config, *, from_keras=None, init_params=None) -> None:
    """Refusals before anything is built: two starting points at once, and
    a model the JAX package refuses (``config.py::check_supported``)."""
    if from_keras and init_params:
        raise ValueError("--from-keras and --init-params are two starting "
                         "points; pass one")
    check_supported(config)


def _build_dataset(config, data_dir: str, overwrite: bool,
                   verbose: bool) -> None:
    """Build ``config.data_file`` from the cases unless it exists (cached
    unless overwrite)."""
    if not (overwrite or not os.path.exists(config.data_file)):
        return
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


def _train(config, *, mesh, init_params, from_keras, device, seed, verbose,
           profile_dir):
    """Model, state, generators, cache and the loop, on one device or as
    one rank of ``mesh``; the dataset exists."""
    overwrite = config.overwrite
    is_main = mesh is None or mesh.rank == 0
    verbose = verbose and is_main
    data_file = open_data_file(config.data_file)
    try:
        # model and state (train_model restores the checkpoint)
        ckpt_io = CheckpointIO(config.model_file)
        resuming = ckpt_io.exists() and not overwrite
        start = (f"--init-params {init_params}" if init_params
                 else f"--from-keras {from_keras}" if from_keras else None)
        if start and resuming:
            sys.exit(
                f"{start}: a checkpoint already exists at "
                f"{config.model_file} — resuming it would ignore the file. "
                "Pass --overwrite to start from the file, or a fresh "
                "model_file")
        if from_keras:
            # the config was derived from the file in main
            model, state, _ = load_old_model(from_keras, config=config,
                                             verbose=verbose, derived=True,
                                             device=device)
        else:
            model = build_model(config, device)
            state = create_train_state(model, config)
            if init_params:
                with_adam = load_npz_train_state(state, init_params)
                if verbose:
                    print(f"[init] {init_params}: variables"
                          + (f" and Adam state at step {state.step}, lr "
                             f"{state.learning_rate:g}" if with_adam
                             else ""))
            elif not resuming and config.model_name in OWN_INIT:
                # no flax counterpart: the model's own seeded init
                OWN_INIT[config.model_name](model, seed)
            elif not resuming:
                model.load_state_dict(from_flax(init_flax_like(config,
                                                               seed)))
        # data-order exact resume: fast-forward the generators by the
        # start_epoch * steps batches the interrupted run consumed
        start_epoch = (ckpt_io.peek_epoch() or 0) if resuming else 0

        # generators; on a mesh rank 0 writes the split and the others
        # read it
        if not is_main:
            dist.barrier(group=mesh.group)
        tg, n_train, vg, n_val = get_training_and_validation_generators(
            data_file, batch_size=config.batch_size, n_labels=config.n_labels,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            data_split=config.validation_split,
            overwrite=overwrite and is_main,
            labels=config.labels, patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=config.skip_blank, seed=seed,
            start_epoch=start_epoch)
        if is_main and mesh is not None:
            dist.barrier(group=mesh.group)
        if verbose:
            where = (f"{mesh.size} ranks, {mesh.axis_names}" if mesh
                     is not None else str(next(model.parameters()).device))
            print(f"training on {where}; "
                  f"{n_train} steps/epoch, {n_val} val steps")

        # the device-resident case cache (a single device or a data mesh):
        # a resumed run pins the interrupted run's data-order mode, since
        # the decision otherwise reads the live free memory
        resume_order = None
        if resuming and start_epoch > 0:
            resume_order = (ckpt_io.peek_data_order()
                            or {"mode": "lockstep"})
        device_cache = None
        dc = maybe_build_device_cache(
            data_file, config, mesh=mesh, seed=seed,
            train_skip_batches=start_epoch * n_train,
            val_skip_batches=start_epoch * n_val,
            resume_data_order=resume_order, verbose=verbose,
            device=next(model.parameters()).device)
        if dc is not None:
            device_cache, tg, vg = dc

        with (trace(profile_dir) if profile_dir and is_main
              else contextlib.nullcontext()):
            return train_model(model, state, config, tg, vg, n_train, n_val,
                               mesh=mesh, seed=seed, verbose=verbose,
                               device_cache=device_cache)
    finally:
        data_file.close()


def _rank_main(local_rank: int, world: int, port: int, config_dict: dict,
               kwargs: dict) -> None:
    """One spawned rank: say where it stands, join the group, train."""
    os.environ.update(rank_environment(local_rank, world, port))
    _train_as_rank(Config.from_dict(config_dict), **kwargs)


def _train_as_rank(config, *, device, share_devices, **kwargs):
    initialize_distributed(device=device, share_devices=share_devices)
    try:
        n_spatial = config.spatial_devices or 1
        if n_spatial > 1:
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = make_hybrid_mesh(world // n_spatial, n_spatial,
                                    device=device,
                                    share_devices=share_devices)
        else:
            mesh = make_mesh(device=device, share_devices=share_devices)
        return _train(config, mesh=mesh if mesh.size > 1 else None,
                      device=mesh.device, **kwargs)
    finally:
        shutdown_distributed()


def _check_spatial(config, n_dev: int) -> None:
    """The JAX ``train.py``'s refusal, before anything is built."""
    n_spatial = config.spatial_devices or 1
    if n_spatial > 1 and n_dev % n_spatial != 0:
        sys.exit(f"spatial_devices={n_spatial} must divide the device count "
                 f"({n_dev}) — devices would sit idle")


def main(config, data_dir: str, overwrite: bool = False, verbose: bool = True,
         profile_dir: Optional[str] = None, seed: int = 0,
         from_keras: Optional[str] = None, *,
         init_params: Optional[str] = None, device: str = "cuda",
         share_devices: bool = False,
         rank_timeout_s: Optional[float] = None):
    """Build the dataset if needed, then train ``config``'s model on
    ``device``; returns the final ``TrainState`` (None where this process
    only started the ranks). ``share_devices``: see the module docstring.
    ``rank_timeout_s``: the ranks this process starts are killed, and the
    call raises, when they run longer."""
    if from_keras:
        # the MODEL config comes from the .h5 before anything reads it: the
        # dataset build globs its modalities, the generators use its patch
        config = derive_config_from_keras_h5(from_keras, base=config,
                                             verbose=verbose)
    check_flags(config, from_keras=from_keras, init_params=init_params)
    # one overwrite for both surfaces (the CLI argument and the config key):
    # train_model gates its restore on config.overwrite
    overwrite = bool(overwrite or config.overwrite)
    config.overwrite = overwrite
    kwargs = dict(init_params=init_params, from_keras=from_keras, seed=seed,
                  verbose=verbose, profile_dir=profile_dir)

    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        # one rank under a launcher: rank 0 builds what every rank reads
        world = int(os.environ["WORLD_SIZE"])
        if config.num_devices not in (None, world):
            raise ValueError(f"num_devices={config.num_devices} but the "
                             f"launcher started {world} processes")
        _check_spatial(config, world)
        initialize_distributed(device=device, share_devices=share_devices)
        if dist.get_rank() == 0:
            _build_dataset(config, data_dir, overwrite, verbose)
            build_kernels_before_ranks(config, device)
        dist.barrier()
        return _train_as_rank(config, device=device,
                              share_devices=share_devices, **kwargs)

    dev = resolve_device(device)
    cards = (torch.cuda.device_count()
             if dev.type == "cuda" and dev.index is None else 1)
    n_dev = config.num_devices or cards
    _check_spatial(config, n_dev)
    _build_dataset(config, data_dir, overwrite, verbose)
    if n_dev <= 1:
        return _train(config, mesh=None, device=device, **kwargs)
    if dev.type == "cuda" and n_dev > cards and not share_devices:
        # running on fewer devices than asked for must not pass silently
        raise ValueError(f"requested {n_dev} devices, have {cards}")
    build_kernels_before_ranks(config, device)
    run_ranks(_rank_main, n_dev,
              (n_dev, free_port(), config.to_dict(),
               dict(device=device, share_devices=share_devices, **kwargs)),
              rank_timeout_s)
    return None


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
                    help="write a torch.profiler Chrome trace of "
                         "training (*.pt.trace.json) and the port's spans "
                         "of each train step beside it (*.spans.json)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for init, patch sampling and augmentation")
    ap.add_argument("--init-params", metavar="FILE_NPZ", default=None,
                    help="start from the variables (and Adam state) that "
                         "tools/export_params_npz.py wrote")
    ap.add_argument("--from-keras", metavar="MODEL_H5", default=None,
                    help="start from a reference Keras .h5: architecture, "
                         "weights and Adam state (needs h5py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--share-devices", action="store_true",
                    help="let ranks share a card where num_devices exceeds "
                         "the cards (gloo; a check, not a speed-up)")
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
         device=args.device, share_devices=args.share_devices)
