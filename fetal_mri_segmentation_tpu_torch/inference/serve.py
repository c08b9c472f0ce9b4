"""Streaming serving: watch a directory, predict new cases as they arrive
(port of ``fetal_mri_segmentation_tpu/inference/serve.py``).

One process holds the model on the device and serves every case dropped
into the watch directory with the ad-hoc path (``inference/predict.py``:
builder-identical preprocessing, no HDF5 ingest).

Case protocol:
- a case is a subdirectory of the watch dir holding
  ``<modality>.nii[.gz]`` per ``config.training_modalities``, or a bare
  ``*.nii[.gz]`` file for single-modality configs;
- in continuous mode a case is picked up once all its modality files exist
  and their sizes and mtimes have been stable for one poll interval (no
  half-written upload is read); ``once`` processes the backlog without
  that guard;
- output goes to ``<output_dir>/<case_name>/prediction.nii.gz``; a case is
  skipped when that file exists (idempotent restarts); a failing case is
  quarantined and retried when its files change or after a backoff.

Every predictor of the port has the async surface, so a sweep's backlog is
pipelined: case i's work is enqueued on the device, case i+1's host
preprocessing and upload run while it computes, then case i's label map is
copied back; the NIfTI writes run on one worker thread.
"""

from __future__ import annotations

import collections
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from fetal_mri_segmentation_tpu_torch.inference.predict import (
    _write_prediction, preprocess_case, queue_input_writes)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import (
    atomic_json_dump, case_name_from_path)

_case_name = case_name_from_path  # shared with predict --input naming


def discover_cases(watch_dir: str, config,
                   collisions: Optional[list] = None,
                   present: Optional[set] = None) -> Dict[str, str]:
    """Map case name -> input path for every complete case in the watch dir.

    A case's name derives only from its own entry, so names (and output
    directories and quarantine keys) are stable across sweeps. Entries whose
    names collide (``foo/`` beside ``foo.nii.gz``, or ``foo.nii`` beside
    ``foo.nii.gz``) are all excluded and reported through ``collisions``.
    ``present``, when given, gets every case name whose entry exists at all
    (incomplete and colliding ones too), so the caller can tell a deleted
    case from one that is transiently not servable."""
    found: Dict[str, list] = {}
    for entry in sorted(os.listdir(watch_dir)):
        path = os.path.join(watch_dir, entry)
        if os.path.isdir(path):
            if present is not None:
                present.add(_case_name(path))
            complete = all(
                any(os.path.exists(os.path.join(path, m + ext))
                    for ext in (".nii.gz", ".nii"))
                for m in config.training_modalities)
            if complete:
                found.setdefault(_case_name(path), []).append(path)
        elif (entry.endswith((".nii", ".nii.gz"))
              and len(config.training_modalities) == 1):
            if present is not None:
                present.add(_case_name(path))
            found.setdefault(_case_name(path), []).append(path)
    cases = {n: ps[0] for n, ps in found.items() if len(ps) == 1}
    if collisions is not None:
        collisions.extend(n for n, ps in sorted(found.items())
                          if len(ps) > 1)
    return cases


def _signature(path: str) -> Tuple:
    """(file, size, mtime) tuples of a case: two equal polls in a row are
    required before predicting, so half-uploaded NIfTIs are never read."""
    if os.path.isfile(path):
        st = os.stat(path)
        return ((path, st.st_size, st.st_mtime),)
    out = []
    for f in sorted(os.listdir(path)):
        p = os.path.join(path, f)
        if os.path.isfile(p):
            st = os.stat(p)
            out.append((f, st.st_size, st.st_mtime))
    return tuple(out)


def watch_and_predict(watch_dir: str, output_dir: str, config, predictor, *,
                      poll_interval: float = 1.0, once: bool = False,
                      require_stable: bool = True, threshold: float = 0.5,
                      save_inputs: bool = False,
                      retry_backoff: float = 60.0,
                      stop: Optional[object] = None,
                      stats: Optional[dict] = None,
                      stats_file: Optional[str] = None,
                      verbose: bool = True, device_pre=None,
                      moments=None) -> int:
    """Serve until ``stop.is_set()`` (or forever; one sweep with ``once``).

    Returns the number of cases predicted and durably written.
    ``predictor`` is a sliding-window or direct predictor of the port.
    ``save_inputs=False`` keeps the hot path to one NIfTI write. A failing
    case (a failed prediction write too, e.g. a full disk) is quarantined
    and retried when its files change or after ``retry_backoff`` seconds.
    ``stats`` is filled with ``{"predicted", "write_failures",
    "aux_write_failures"}``: lost predictions, and lost ``save_inputs``
    copies of otherwise served cases. ``stats_file`` gets an atomically
    replaced JSON heartbeat after every sweep: uptime, counts, quarantine
    size and p50/p95/max case latency over the last 512 served cases. A
    case's latency is its own work (preprocess, upload, dispatch, D2H,
    write queueing); the time it waits in the pipeline while the next case
    is preprocessed is left out. A failing stats write is reported once and
    never stops serving. ``moments``: the training set's (mean, std) for
    ``normalization="global"``."""
    os.makedirs(output_dir, exist_ok=True)
    pending_sigs: Dict[str, Tuple] = {}
    failed: Dict[str, Tuple] = {}  # name -> (signature, monotonic time)
    n_done = 0
    n_write_failed = 0      # lost predictions (case not served)
    n_aux_write_failed = 0  # lost save_inputs copies (case served)
    # the writes of a sweep drain at its end: a case counts as served once
    # its prediction write landed (writes are atomic, utils/nifti.py)
    pool = ThreadPoolExecutor(max_workers=1)
    inflight = []  # (name, out_dir, seconds, [(future, target)], signature)
    warned_collisions = set()
    latencies = collections.deque(maxlen=512)
    t_start = time.monotonic()
    n_sweeps = 0
    last_served = None
    stats_write_warned = False

    def write_stats_file():
        nonlocal stats_write_warned
        if stats_file is None:
            return
        lat = sorted(latencies)

        def pct(q):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(q * (len(lat) - 1)))], 4)

        payload = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "uptime_sec": round(time.monotonic() - t_start, 1),
            "sweeps": n_sweeps,
            "predicted": n_done,
            "write_failures": n_write_failed,
            "aux_write_failures": n_aux_write_failed,
            "quarantined": len(failed),
            "awaiting_stability": len(pending_sigs),
            "last_served": last_served,
            "latency_sec": {"n": len(lat), "p50": pct(0.5),
                            "p95": pct(0.95),
                            "max": lat[-1] if lat else None},
        }
        try:
            atomic_json_dump(payload, stats_file)
        except OSError as e:
            if not stats_write_warned:
                stats_write_warned = True
                print(f"[serve] stats file unwritable ({e}) — continuing "
                      "without heartbeat", flush=True)

    def drain_writes():
        nonlocal n_done, n_write_failed, n_aux_write_failed, last_served
        for name, odir, dt, futs, sig in inflight:
            errs = [(path, f.exception()) for f, path in futs]
            errs = [(p, e) for p, e in errs if e is not None]
            pred_errs = [(p, e) for p, e in errs
                         if os.path.basename(p) == "prediction.nii.gz"]
            if pred_errs:
                e = pred_errs[0][1]
                # not served: no durable prediction exists. Un-count it and
                # quarantine it, so a full disk does not recompute the same
                # prediction every poll.
                n_done -= 1
                n_write_failed += 1
                failed[name] = (sig, time.monotonic())
                print(f"[serve] WRITE FAILED {name}: "
                      f"{type(e).__name__}: {e} (atomic writes leave no "
                      f"partial artifact; retried when the files change "
                      f"or after {retry_backoff:.0f}s)", flush=True)
            elif errs:
                # only save_inputs copies were lost; the prediction landed
                n_aux_write_failed += 1
                latencies.append(dt)
                last_served = name
                lost = ", ".join(os.path.basename(p) for p, _ in errs)
                e = errs[0][1]
                print(f"[serve] {name} served, but input copies lost "
                      f"({lost}): {type(e).__name__}: {e}", flush=True)
            else:
                latencies.append(dt)
                last_served = name
                if verbose:
                    print(f"[serve] {name} -> {odir}/prediction.nii.gz "
                          f"({dt:.2f}s)", flush=True)
        inflight.clear()

    def quarantine(name, sig, exc, case_futs):
        for f, _ in case_futs:  # settle any already queued writes
            f.exception()
        failed[name] = (sig, time.monotonic())
        pending_sigs.pop(name, None)
        print(f"[serve] FAILED {name}: {type(exc).__name__}: {exc} "
              f"(quarantined — retries when the files change or "
              f"after {retry_backoff:.0f}s)", flush=True)

    def finalize(p):
        nonlocal n_done
        name, odir, sig, host_sec, out_dev, affine, futs = p
        t1 = time.perf_counter()
        try:
            label_map = predictor.unpack_labels(out_dev)
        except Exception as e:  # a device error surfaces at the D2H copy
            quarantine(name, sig, e, futs)
            return
        _write_prediction(
            label_map, config, odir, affine,
            lambda target, fn, *a, **kw: futs.append(
                (pool.submit(fn, *a, **kw), target)))
        n_done += 1
        pending_sigs.pop(name, None)
        inflight.append((name, odir, host_sec + time.perf_counter() - t1,
                         futs, sig))

    try:
        while True:
            collisions: list = []
            present: set = set()
            try:
                discovered = discover_cases(watch_dir, config, collisions,
                                            present)
            except OSError as e:
                # a transiently unreadable watch dir must not stop a long
                # running server; with ``once`` it is the operator's one
                # chance to see the problem
                if once:
                    raise
                print(f"[serve] watch dir unreadable: {type(e).__name__}: "
                      f"{e} (retrying next poll)", flush=True)
                if stop is not None and stop.is_set():
                    return n_done
                time.sleep(poll_interval)
                continue

            # prune the state of cases whose entry is gone entirely; a
            # quarantined case that is transiently unservable (a name
            # collision, an incomplete re-upload) keeps its backoff
            for d in (pending_sigs, failed):
                for k in [k for k in d if k not in present]:
                    del d[k]
            warned_collisions &= set(collisions)

            pending = None  # (name, out_dir, sig, host_sec, out_dev,
            #                  affine, futs)
            for name, path in discovered.items():
                out_dir = os.path.join(output_dir, name)
                if os.path.exists(os.path.join(out_dir,
                                               "prediction.nii.gz")):
                    continue
                try:
                    sig = _signature(path)
                except OSError:
                    # files vanished or were renamed since discovery
                    pending_sigs.pop(name, None)
                    continue
                if name in failed:
                    fsig, ftime = failed[name]
                    if (fsig == sig
                            and time.monotonic() - ftime < retry_backoff):
                        continue  # unchanged and inside its backoff
                    del failed[name]
                if require_stable and not once:
                    if pending_sigs.get(name) != sig:
                        pending_sigs[name] = sig  # first sighting or still
                        continue                  # changing: wait a poll
                t0 = time.perf_counter()
                case_futs: list = []

                def submit(target, fn, *a, _futs=case_futs, **kw):
                    # ``target``, the write's destination, tells a lost
                    # prediction from a lost save_inputs copy
                    _futs.append((pool.submit(fn, *a, **kw), target))

                try:
                    data, affine, truth_image = preprocess_case(
                        path, config, global_moments=moments,
                        device_pre=device_pre)
                    os.makedirs(out_dir, exist_ok=True)
                    if save_inputs:
                        queue_input_writes(data, truth_image, config,
                                           out_dir, affine, submit)
                    out_dev = predictor.predict_labels_async(data, threshold)
                except Exception as e:  # one bad case must not stop serving
                    quarantine(name, sig, e, case_futs)
                    continue
                host_sec = time.perf_counter() - t0
                if pending is not None:
                    finalize(pending)
                pending = (name, out_dir, sig, host_sec, out_dev, affine,
                           case_futs)
            if pending is not None:
                finalize(pending)
            for c in collisions:
                if c not in warned_collisions:
                    warned_collisions.add(c)
                    print(f"[serve] SKIPPED colliding cases named {c!r}: "
                          f"multiple watch-dir entries map to the same case "
                          f"name — rename one to serve them", flush=True)
            drain_writes()
            n_sweeps += 1
            if stats is not None:
                stats.update(predicted=n_done, write_failures=n_write_failed,
                             aux_write_failures=n_aux_write_failed)
            write_stats_file()
            if once or (stop is not None and stop.is_set()):
                return n_done
            time.sleep(poll_interval)
    finally:
        pool.shutdown(wait=True)
