"""Predict NIfTI cases with the port, on the GPU by default.

    python -m fetal_mri_segmentation_tpu_torch.predict --config CFG \\
        [--params PARAMS.npz] [--input CASE [CASE ...]]
        [--output-dir prediction]
        [--overlap N] [--patch-batch-size N] [--threshold T]
        [--direct] [--tta] [--tta-mode {permute,flips}]
        [--device-preprocess] [--prob-map]
        [--prob-dtype {float32,float16,uint8,uint16}] [--device cuda]
        [--num-devices N | --spatial-devices N] [--share-devices]
        [--from-keras MODEL_H5] [--export PATH]

Each CASE is a directory with ``<modality>.nii[.gz]`` files (and optionally
``truth.nii[.gz]``) or a single NIfTI file for one-modality configs. The
output tree is ``<output-dir>/<case>/prediction.nii.gz`` plus the
preprocessed ``data_<modality>`` and ``truth`` volumes, with the case names
of ``predict.py --input``. The cases run through a two-stage pipeline
(``inference/predict.py::predict_cases_pipelined``). Without ``--input``
every case of the validation split (``config.validation_file``) is
predicted from the dataset at ``config.data_file`` into
``<output-dir>/<subject id>/`` (``run_validation_cases``), as the root
``predict.py`` does. The weights come from the port's own checkpoint at
``config.model_file`` (written by ``python -m
fetal_mri_segmentation_tpu_torch.train``), or with ``--params`` from the
flattened flax params that ``tools/export_params_npz.py`` writes from a
checkpoint of the JAX package. ``normalization="global"`` reads the
training moments from the dataset, once. ``--device cuda`` on a machine
without CUDA raises.

``--direct`` runs one whole-volume forward instead of the patch grid;
``--tta`` averages over the 48 cube symmetries and ``--tta-mode flips``
over the 8 axis flips (``--tta-mode`` implies ``--tta``);
``--device-preprocess`` resamples and normalizes on the device;
``--prob-map`` writes the probability map, moved to the host in
``--prob-dtype`` (uint8 / uint16 stay integer on disk via NIfTI
``scl_slope``). ``--from-keras MODEL_H5`` takes the architecture and the
weights from a reference Keras ``.h5`` instead (``utils/keras_migrate.py``;
needs h5py). ``--export PATH`` writes the whole-volume label-map program
at ``config.image_shape`` as one portable artifact and predicts nothing
(``utils/export.py``: ``torch.export``; load it with
``load_predictor(PATH)``).

The validation-set path runs on several devices, one process each:
``--num-devices N`` shards the sliding window's patch grid over N ranks
(``parallel/distributed.py::make_sharded_predictor``), ``--spatial-devices
N`` the whole volume's depth (``parallel/spatial.py``, a 1 x N mesh; with
``--tta`` volume-level TTA). Under a launcher (``torchrun --nproc-per-node
N``: ``WORLD_SIZE`` is set) this process is one rank; started alone it
starts the N ranks itself (``torch.multiprocessing.spawn``), after building
the kernels once. ``--share-devices`` lets ranks share a card where there
are fewer cards than ranks (gloo: a check, no speed-up). Rank 0 writes the
tree.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
from fetal_mri_segmentation_tpu_torch.inference.predict import (
    build_serving_predictor, load_global_moments, load_serving_model,
    make_device_preprocessor, predict_cases_pipelined, resolve_tta,
    run_validation_cases, serving_weights)
from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import make_mesh
from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
    build_kernels_before_ranks, free_port, initialize_distributed,
    rank_environment, run_ranks, shutdown_distributed)
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
    make_hybrid_mesh)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.export import export_predictor
from fetal_mri_segmentation_tpu_torch.utils.io_utils import (
    case_name_from_path)
from fetal_mri_segmentation_tpu_torch.utils.keras_migrate import (
    derive_config_from_keras_h5, load_old_model)


def assign_output_names(paths: Sequence[str]):
    """Unique output-dir name per input path, in order: the basename without
    a trailing .nii[.gz]; duplicates get ``_2``, ``_3``, ... chosen against
    every name already assigned (the rule of ``predict.py``)."""
    assigned, names = set(), []
    for path in paths:
        base = case_name_from_path(path)
        name, n = base, 1
        while name in assigned:
            n += 1
            name = f"{base}_{n}"
        assigned.add(name)
        names.append(name)
    return names


def check_flags(inputs, *, device_preprocess=False, prob_map=False,
                prob_dtype="float32", export_path=None,
                num_devices=1, spatial_devices=1) -> None:
    """The root ``predict.py``'s flag validation, before any model is
    built."""
    multi = ((num_devices or 1) > 1) or ((spatial_devices or 1) > 1)
    if inputs and multi:
        raise ValueError(
            "--input is single-device; --num-devices/--spatial-devices "
            "apply to the validation-set path only")
    if (num_devices or 1) > 1 and (spatial_devices or 1) > 1:
        # run_validation_cases's own message, before any rank starts
        raise ValueError(
            "spatial_mesh and patch-grid mesh are mutually exclusive "
            "inference modes — pass one of --spatial-devices / "
            "--num-devices")
    if device_preprocess and not inputs:
        raise ValueError("--device-preprocess applies to raw-NIfTI ingest "
                         "(--input); the validation set is already "
                         "preprocessed inside the dataset")
    if prob_map and export_path:
        raise ValueError("--export serializes the LABEL-MAP program; "
                         "probability output (--prob-map) is not exportable")
    if prob_dtype != "float32" and not prob_map:
        raise ValueError("--prob-dtype applies to the probability-map "
                         "transfer only — pass --prob-map (label-map "
                         "output already uses the device-side label map)")


def _load_model(config, params, from_keras, device):
    """The serving model: from a Keras ``.h5`` (the config already derived
    from it), an exported ``.npz``, or the port's checkpoint."""
    if from_keras:
        return load_old_model(from_keras, config=config, with_optimizer=False,
                              verbose=False, derived=True, device=device)[0]
    return load_serving_model(config, params, device)


def _validation_set(config, model, *, output_dir, overlap, tta,
                    patch_batch_size, direct, prob_map, threshold,
                    prob_dtype, device, verbose, mesh=None,
                    spatial_mesh=None) -> int:
    with open_data_file(config.data_file) as data_file:
        n = run_validation_cases(
            config.validation_file, model, data_file, config,
            output_dir=output_dir, overlap=overlap, permute=tta,
            patch_batch_size=patch_batch_size, direct=direct,
            output_label_map=not prob_map, threshold=threshold,
            prob_dtype=prob_dtype, mesh=mesh, spatial_mesh=spatial_mesh,
            device=device)
    if verbose:
        print(f"predictions written under {output_dir}/")
    return n


def _predict_as_rank(config, params, *, num_devices, spatial_devices,
                     device, share_devices, verbose, from_keras=None,
                     **kwargs) -> int:
    """One rank of the validation-set prediction on N devices."""
    initialize_distributed(device=device, share_devices=share_devices)
    try:
        if (spatial_devices or 1) > 1:
            mesh, spatial_mesh = None, make_hybrid_mesh(
                1, spatial_devices, device=device,
                share_devices=share_devices)
            dev, rank = spatial_mesh.device, spatial_mesh.rank
        else:
            mesh, spatial_mesh = make_mesh(num_devices, device=device,
                                           share_devices=share_devices), None
            dev, rank = mesh.device, mesh.rank
        model = _load_model(config, params, from_keras, dev)
        return _validation_set(config, model, device=dev, mesh=mesh,
                               spatial_mesh=spatial_mesh,
                               verbose=verbose and rank == 0, **kwargs)
    finally:
        shutdown_distributed()


def _rank_main(local_rank: int, world: int, port: int, config_dict: dict,
               params, kwargs: dict) -> None:
    """One spawned rank: say where it stands, join the group, predict."""
    os.environ.update(rank_environment(local_rank, world, port))
    _predict_as_rank(Config.from_dict(config_dict), params, **kwargs)


def main(config: Config, params: Optional[str] = None,
         inputs: Optional[Sequence[str]] = None, output_dir: str = "prediction", overlap: Optional[int] = None,
         patch_batch_size: int = 8, threshold: float = 0.5,
         device: str = "cuda", verbose: bool = True, *, tta=False,
         direct: bool = False, device_preprocess: bool = False,
         prob_map: bool = False, prob_dtype: str = "float32",
         export_path: Optional[str] = None, from_keras: Optional[str] = None,
         num_devices: int = 1, spatial_devices: int = 1,
         share_devices: bool = False,
         rank_timeout_s: Optional[float] = None) -> Optional[int]:
    """Predict ``inputs``, or without them the dataset's validation split,
    into ``output_dir``; returns the number of cases (None where this
    process only started the ranks). ``params``: an exported ``.npz``, or
    None for the checkpoint at ``config.model_file``. ``tta``: False |
    True/"permute" | "flips" (``resolve_tta``). ``num_devices`` /
    ``spatial_devices`` above 1, ``share_devices``: see the module
    docstring; ``rank_timeout_s``: the ranks this process starts are
    killed, and the call raises, when they run longer. ``from_keras``: a
    reference Keras ``.h5`` in place of ``params``; ``export_path``: write
    the label-map program there (``utils/export.py``) and return None."""
    if from_keras:
        # architecture from the file's model_config, as the root
        # predict.py derives it before anything else
        config = derive_config_from_keras_h5(from_keras, base=config,
                                             verbose=verbose)
    if overlap is None:
        overlap = config.validation_patch_overlap
    check_flags(inputs, device_preprocess=device_preprocess,
                prob_map=prob_map, prob_dtype=prob_dtype,
                export_path=export_path,
                num_devices=num_devices, spatial_devices=spatial_devices)
    if export_path:
        export_predictor(_load_model(config, params, from_keras, device),
                         config, config.image_shape, export_path,
                         overlap=overlap, patch_batch_size=patch_batch_size,
                         threshold=threshold, tta=tta, direct=direct)
        if verbose:
            print(f"exported portable label-map program to {export_path}"
                  + (" (direct whole-volume mode)" if direct else ""))
        return None
    n_dev = max(num_devices or 1, spatial_devices or 1)
    kwargs = dict(output_dir=output_dir, overlap=overlap, tta=tta,
                  patch_batch_size=patch_batch_size, direct=direct,
                  prob_map=prob_map, threshold=threshold,
                  prob_dtype=prob_dtype, verbose=verbose)
    ranks = dict(num_devices=num_devices, spatial_devices=spatial_devices,
                 device=device, share_devices=share_devices,
                 from_keras=from_keras, **kwargs)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        # one rank under a launcher
        if n_dev != world:
            raise ValueError(f"--num-devices/--spatial-devices {n_dev} but "
                             f"the launcher started {world} processes")
        return _predict_as_rank(config, params, **ranks)
    if n_dev > 1:
        dev = resolve_device(device)
        cards = (torch.cuda.device_count()
                 if dev.type == "cuda" and dev.index is None else 1)
        if dev.type == "cuda" and n_dev > cards and not share_devices:
            # running on fewer devices than asked for must not pass silently
            raise ValueError(f"requested {n_dev} devices, have {cards}")
        if not from_keras:
            serving_weights(config, params)  # before any rank starts
        build_kernels_before_ranks(config, device)
        run_ranks(_rank_main, n_dev, (n_dev, free_port(), config.to_dict(),
                                      params, ranks), rank_timeout_s)
        return None
    model = _load_model(config, params, from_keras, device)
    if not inputs:
        return _validation_set(config, model, device=device, **kwargs)
    predictor = build_serving_predictor(
        model, config, direct=direct, tta=tta, overlap=overlap,
        patch_batch_size=patch_batch_size, device=device)
    # the training distribution's moments, loaded once and not per case
    moments = (load_global_moments(config.data_file)
               if config.normalization == "global" else None)
    device_pre = (make_device_preprocessor(model, config, moments=moments)
                  if device_preprocess else None)
    cases = [(path, os.path.join(output_dir, name))
             for path, name in zip(inputs, assign_output_names(inputs))]
    return predict_cases_pipelined(
        cases, predictor, config, threshold=threshold,
        global_moments=moments, device_pre=device_pre, verbose=verbose,
        output_label_map=not prob_map, prob_dtype=prob_dtype)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="experiment JSON")
    ap.add_argument("--params", default=None,
                    help="flattened flax params (.npz); default: the "
                         "port's checkpoint at the config's model_file")
    ap.add_argument("--input", nargs="+", default=None, metavar="CASE",
                    help="ad-hoc NIfTI cases; default: the dataset's "
                         "validation split")
    ap.add_argument("--output-dir", default="prediction")
    ap.add_argument("--overlap", type=int, default=None,
                    help="patch overlap (default: the config's "
                         "validation_patch_overlap)")
    ap.add_argument("--patch-batch-size", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--direct", action="store_true",
                    help="one whole-volume forward, no patch grid (dims "
                         "must divide 2^(depth-1))")
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation averaging (see --tta-mode)")
    ap.add_argument("--tta-mode", choices=["permute", "flips"], default=None,
                    help="implies --tta. permute = the 48 cube symmetries "
                         "(cubic patches or volume; the default with bare "
                         "--tta); flips = the 8 axis flips (any shape)")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="resample and normalize on the device (the host "
                         "reads and crops only)")
    ap.add_argument("--prob-map", action="store_true",
                    help="write the probability map instead of the label "
                         "map")
    ap.add_argument("--prob-dtype",
                    choices=["float32", "float16", "uint8", "uint16"],
                    default="float32",
                    help="with --prob-map: the device-to-host dtype; "
                         "uint8/uint16 stay integer on disk (NIfTI "
                         "scl_slope)")
    ap.add_argument("--export", metavar="PATH", default=None,
                    help="write the whole-volume label-map program as one "
                         "portable artifact (torch.export) and exit")
    ap.add_argument("--from-keras", metavar="MODEL_H5", default=None,
                    help="architecture and weights from a reference Keras "
                         ".h5 (needs h5py)")
    ap.add_argument("--num-devices", type=int, default=1,
                    help="shard the patch grid over N devices (the "
                         "validation-set path)")
    ap.add_argument("--spatial-devices", type=int, default=1,
                    help="one whole-volume forward per case, the depth "
                         "sharded over N devices (the validation-set path)")
    ap.add_argument("--share-devices", action="store_true",
                    help="let ranks share a card where there are fewer "
                         "cards than ranks (gloo; a check, not a speed-up)")
    ap.add_argument("--device", default="cuda")
    return ap


if __name__ == "__main__":
    args = _parser().parse_args()
    main(Config.load(args.config), args.params, args.input,
         output_dir=args.output_dir, overlap=args.overlap,
         patch_batch_size=args.patch_batch_size, threshold=args.threshold,
         device=args.device, tta=resolve_tta(args.tta, args.tta_mode),
         direct=args.direct, device_preprocess=args.device_preprocess,
         prob_map=args.prob_map, prob_dtype=args.prob_dtype,
         export_path=args.export, from_keras=args.from_keras,
         num_devices=args.num_devices, spatial_devices=args.spatial_devices,
         share_devices=args.share_devices)
