"""Streaming inference server of the port: watch a directory, predict new
cases on arrival, on the GPU by default (port of the root ``serve.py``).

    python -m fetal_mri_segmentation_tpu_torch.serve --config CFG \\
        [--params PARAMS.npz] --watch incoming/ [--output served]
        [--overlap N] [--patch-batch-size N] [--direct] [--tta]
        [--tta-mode {permute,flips}] [--poll S] [--once] [--threshold T]
        [--save-inputs] [--device-preprocess] [--stats-file PATH]
        [--device cuda]

Case layout: ``<watch>/<case>/<modality>.nii[.gz]`` (the train-time
layout), or bare ``.nii[.gz]`` files for single-modality configs.
Idempotent: a case with an existing ``prediction.nii.gz`` is skipped;
delete it to predict again. SIGINT and SIGTERM stop the server after the
current sweep. ``--once`` serves the backlog and exits, non-zero when a
prediction write failed. ``--stats-file`` keeps a JSON heartbeat with the
served counts and the p50/p95 case latency. The weights come from the
port's checkpoint at ``config.model_file``, or from ``--params`` (an
exported flax ``.npz``); ``normalization="global"`` reads the training
moments from ``config.data_file`` once, at start.
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.inference.predict import (
    build_serving_predictor, load_global_moments, load_serving_model,
    make_device_preprocessor, resolve_tta)
from fetal_mri_segmentation_tpu_torch.inference.serve import (
    watch_and_predict)


def main(config: Config, params: Optional[str], watch: str, output: str = "served",
         overlap: Optional[int] = None, patch_batch_size: int = 8,
         direct: bool = False, tta=False, poll: float = 1.0,
         once: bool = False, threshold: float = 0.5,
         save_inputs: bool = False, device_preprocess: bool = False,
         stats_file: Optional[str] = None, device: str = "cuda",
         verbose: bool = True) -> int:
    """Serve ``watch`` into ``output``; returns the number of cases served.
    ``tta``: False | True/"permute" | "flips" (``resolve_tta``)."""
    if overlap is None:
        overlap = config.validation_patch_overlap
    model = load_serving_model(config, params, device)
    predictor = build_serving_predictor(
        model, config, direct=direct, tta=tta, overlap=overlap,
        patch_batch_size=patch_batch_size, device=device)
    # the training distribution's moments, loaded once, shared by the
    # device preprocessor and the host path
    moments = (load_global_moments(config.data_file)
               if config.normalization == "global" else None)
    device_pre = (make_device_preprocessor(model, config, moments=moments)
                  if device_preprocess else None)

    stop = threading.Event()
    handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            handlers[sig] = signal.signal(sig, lambda *_: stop.set())
    if not once:
        print(f"[serve] watching {watch} -> {output} "
              f"({'direct' if direct else 'sliding-window'} mode, "
              f"poll {poll}s; Ctrl-C to stop)", flush=True)
    stats: dict = {}
    try:
        n = watch_and_predict(watch, output, config, predictor,
                              poll_interval=poll, once=once, stop=stop,
                              threshold=threshold, save_inputs=save_inputs,
                              stats=stats, stats_file=stats_file,
                              device_pre=device_pre, verbose=verbose,
                              moments=moments)
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    print(f"[serve] done: {n} case(s) predicted", flush=True)
    if once and stats.get("aux_write_failures"):
        # the predictions are on disk: report the lost copies, exit 0
        print(f"[serve] note: {stats['aux_write_failures']} auxiliary "
              f"--save-inputs write(s) were lost on otherwise-served cases "
              f"— see log above", flush=True)
    if once and stats.get("write_failures"):
        # lost predictions: a --once run must not exit 0 claiming success
        raise SystemExit(
            f"[serve] {stats['write_failures']} case(s) predicted but "
            f"their prediction writes FAILED — see log above")
    return n


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="experiment JSON")
    ap.add_argument("--params", default=None,
                    help="flattened flax params (.npz); default: the "
                         "port's checkpoint at the config's model_file")
    ap.add_argument("--watch", required=True,
                    help="directory to watch for incoming cases")
    ap.add_argument("--output", default="served")
    ap.add_argument("--overlap", type=int, default=None,
                    help="sliding-window patch overlap (default: the "
                         "config's validation_patch_overlap)")
    ap.add_argument("--patch-batch-size", type=int, default=8)
    ap.add_argument("--direct", action="store_true",
                    help="one whole-volume forward, no patch grid (dims "
                         "must divide 2^(depth-1))")
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation averaging (see --tta-mode)")
    ap.add_argument("--tta-mode", choices=["permute", "flips"], default=None,
                    help="implies --tta. permute = the 48 cube symmetries "
                         "(the default with bare --tta); flips = the 8 axis "
                         "flips (any shape)")
    ap.add_argument("--poll", type=float, default=1.0,
                    help="poll interval in seconds")
    ap.add_argument("--once", action="store_true",
                    help="process the current backlog and exit")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--save-inputs", action="store_true",
                    help="also write the preprocessed data_<modality> and "
                         "truth NIfTIs per case")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="resample and normalize on the device (the host "
                         "reads and crops only)")
    ap.add_argument("--stats-file", default=None, metavar="PATH",
                    help="an atomically replaced JSON heartbeat after every "
                         "sweep (counts, quarantine, p50/p95/max latency)")
    ap.add_argument("--device", default="cuda")
    return ap


if __name__ == "__main__":
    args = _parser().parse_args()
    main(Config.load(args.config), args.params, args.watch,
         output=args.output, overlap=args.overlap,
         patch_batch_size=args.patch_batch_size, direct=args.direct,
         tta=resolve_tta(args.tta, args.tta_mode), poll=args.poll,
         once=args.once, threshold=args.threshold,
         save_inputs=args.save_inputs,
         device_preprocess=args.device_preprocess,
         stats_file=args.stats_file, device=args.device)
