"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled with plain ``nvcc -shared`` into one shared
library with a C interface and loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. The library goes to ``build/torch_kernels/`` at
the repository root, named by a hash of the sources, and is built at the
first launch of any kernel (or by calling :func:`build`). Every pointer and
the stream cross the boundary as ``c_void_p``; each C entry point launches
on the stream it is given and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the Hopper "
                       "kernels are compiled from csrc/ at first use")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libfetal_kernels-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a unless the library is current.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.fetal_conv3x3_bf16.argtypes = [_P, _P, _P, _P] + [_I] * 7 + [_F, _P]
    lib.fetal_conv3x3_bf16.restype = _I
    lib.fetal_dec0_bf16.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
    lib.fetal_dec0_bf16.restype = _I
    return lib


ACTIVATIONS = {"none": 0, "relu": 1, "leaky_relu": 2}


def check_launch(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require_cuda_bf16(name: str, **tensors: torch.Tensor) -> None:
    """Validate kernel operands: on one CUDA device, bf16 (``bias`` fp32),
    contiguous and 16-byte aligned. Raises instead of falling back."""
    device = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not a CUDA "
                             "device")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: operands on {device} and {t.device}")
        device = t.device
        want = torch.float32 if key == "bias" else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}; the Hopper kernel "
                            f"takes {want} (bf16 compute only on the card)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
