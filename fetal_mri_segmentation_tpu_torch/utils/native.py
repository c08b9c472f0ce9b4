"""ctypes bindings to the host data-path library (port of
``fetal_mri_segmentation_tpu/utils/native.py``): zero-padded patch copies,
weighted overlap-add, one-hot and blank checks in C++
(``native/fastloader.cpp``, the port's copy of the JAX package's
``native/fastloader.cpp``). Same public names as the JAX module; every
entry point returns None (``overlap_add``: False) where the library is
absent, and its callers then run numpy.

The library is built at first use with the system C++ compiler (``$CXX``,
else ``c++``, ``g++`` or ``clang++``) into
``build/torch_native/libfastloader-<hash>.so`` at the repository root,
named by a hash of the source, the flags and the machine, so a library of
another source is never loaded. Each build writes a file of its own and
moves it into place with ``os.replace``: processes that build at once (test
workers, rank processes) each finish with a whole library. Where no
compiler is found the library is absent (:func:`available` is False); a
compiler that fails, or a library that does not load, raises. This is host
code: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def compiler() -> Optional[str]:
    """Path of the C++ compiler that builds the library, or None."""
    for name in filter(None, (os.environ.get("CXX"), "c++", "g++",
                              "clang++")):
        found = shutil.which(name)
        if found:
            return found
    return None


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + (platform.machine(),)).encode())
    return BUILD_DIR / f"libfastloader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; returns its
    path. Raises where there is no compiler or the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, c++, g++, clang++) to "
                           f"build {SOURCE.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SOURCE.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    if not library_path().exists() and compiler() is None:
        return None
    lib = ctypes.CDLL(str(build()))

    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.extract_patch_f32.argtypes = [f32p, f32p] + [i64] * 10
    lib.extract_patches_batch_f32.argtypes = [f32p, f32p, i64, i64, i64, i64,
                                              i64p, i64, i64, i64, i64]
    lib.overlap_add_f32.argtypes = [f32p, f32p, f32p, f32p] + [i64] * 10
    lib.one_hot_f32.argtypes = [f32p, f32p, f64p, i64, i64]
    lib.any_nonzero_f32.argtypes = [f32p, i64]
    lib.any_nonzero_f32.restype = ctypes.c_int32
    for void in (lib.extract_patch_f32, lib.extract_patches_batch_f32,
                 lib.overlap_add_f32, lib.one_hot_f32):
        void.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def extract_patch(data: np.ndarray, patch_shape,
                  corner) -> Optional[np.ndarray]:
    """Zero-padded patch extraction; None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 3:
        data = data[None]
    C, D, H, W = data.shape
    pd, ph, pw = (int(s) for s in patch_shape)
    out = np.empty((C, pd, ph, pw), np.float32)
    cd, ch, cw = (int(c) for c in corner)
    lib.extract_patch_f32(data, out, C, D, H, W, cd, ch, cw, pd, ph, pw)
    return out


def extract_patches_batch(data: np.ndarray, patch_shape,
                          corners: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 3:
        data = data[None]
    C, D, H, W = data.shape
    pd, ph, pw = (int(s) for s in patch_shape)
    corners = np.ascontiguousarray(corners, np.int64)
    n = corners.shape[0]
    out = np.empty((n, C, pd, ph, pw), np.float32)
    lib.extract_patches_batch_f32(data, out, C, D, H, W, corners, n,
                                  pd, ph, pw)
    return out


def overlap_add(acc: np.ndarray, wsum: np.ndarray, patch: np.ndarray,
                weight: np.ndarray, corner) -> bool:
    lib = _load()
    if lib is None:
        return False
    C, D, H, W = acc.shape
    pd, ph, pw = patch.shape[-3:]
    if (wsum.shape != (D, H, W) or patch.shape != (C, pd, ph, pw)
            or weight.shape != (pd, ph, pw)):
        raise ValueError(f"overlap_add: acc {acc.shape}, wsum {wsum.shape}, "
                         f"patch {patch.shape}, weight {weight.shape}")
    cd, ch, cw = (int(c) for c in corner)
    lib.overlap_add_f32(acc, wsum,
                        np.ascontiguousarray(patch, np.float32),
                        np.ascontiguousarray(weight, np.float32),
                        C, D, H, W, cd, ch, cw, pd, ph, pw)
    return True


def any_nonzero(data: np.ndarray) -> Optional[bool]:
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.float32)
    return bool(lib.any_nonzero_f32(data.reshape(-1), data.size))
