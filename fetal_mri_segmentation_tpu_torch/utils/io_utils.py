"""Pickle helpers — the split-index files are part of the public surface.
A copy of ``fetal_mri_segmentation_tpu/utils/io_utils.py``, kept in the
port so that the port imports nothing of the JAX package.

Reference: unet3d/utils/utils.py::pickle_dump / pickle_load (used for
training_ids.pkl / validation_ids.pkl).
"""

from __future__ import annotations

import pickle


def pickle_dump(item, out_file: str) -> None:
    with open(out_file, "wb") as f:
        pickle.dump(item, f)


def pickle_load(in_file: str):
    with open(in_file, "rb") as f:
        return pickle.load(f)


def case_name_from_path(path: str) -> str:
    """Case name for an input path: the basename with one TRAILING
    ``.nii``/``.nii.gz`` stripped (suffix-only — ``scan.nii.gz.bak`` stays
    ``scan.nii.gz.bak``, and a mid-string occurrence is never touched).

    The single source of the on-disk output-directory name for ad-hoc
    inputs — shared by serve.py's watch loop and predict.py --input so the
    two serving surfaces cannot derive different names for the same file.
    """
    import os

    name = os.path.basename(os.path.normpath(path))
    for suffix in (".nii.gz", ".nii"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def atomic_json_dump(payload, path: str) -> None:
    """Write JSON durably-atomically: temp file in the target directory,
    then os.replace — a reader never sees a partial file and a crash
    leaves either the old file or the new one (checkpoint sidecar, serve
    heartbeat)."""
    import json
    import os
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
