"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled with plain ``nvcc`` (one process per source, run
in parallel) and linked with ``nvcc -shared`` into one shared library with a
C interface, loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds. The library goes to ``build/torch_kernels/`` at
the repository root, named by a hash of the sources, and is built at the
first launch of any kernel (or by calling :func:`build`). Every pointer and
the stream cross the boundary as ``c_void_p``, the tile plans
(``ops/tiling.py``) as arrays of integers. Each C entry point encodes its
TMA tensor maps with ``cuTensorMapEncodeTiled``, which it looks up at run
time with ``cudaGetDriverEntryPoint`` (so the build links nothing but the
CUDA runtime), launches on the stream it is given and returns 0, the launch's
``cudaGetLastError()``, or an encode error; :func:`check_launch` raises on
anything but 0.
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


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / name).exists():
        return str(Path(CUDA_HOME) / "bin" / name)
    raise RuntimeError(f"{name} not found on PATH or under CUDA_HOME: the "
                       "Hopper kernels are compiled from csrc/ at first use")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libfetal_kernels-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a unless the library is current.

    One ``nvcc -c`` per source, all started together, then one link. The
    compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = cuda_tool()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v", "-c",
               "-Xcompiler", "-fPIC", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        text = proc.communicate()[0]
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{text}")
    objs = [str(obj) for obj, _ in jobs]
    if not failed:
        tmp = out.with_name(f"{tag}.so.tmp")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SPECS, _INTS = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    # (map specs, geometry, bias, y, bn[, kb], blocks, act, slope, stream)
    lib.fetal_conv3x3_bf16.argtypes = [_SPECS, _INTS, _P, _P] + [_I] * 4 + [
        _F, _P]
    lib.fetal_dec0_bf16.argtypes = [_SPECS, _INTS, _P, _P] + [_I] * 3 + [
        _F, _P]
    lib.fetal_conv3x3_bf16.restype = lib.fetal_dec0_bf16.restype = _I
    return lib


ACTIVATIONS = {"none": 0, "relu": 1, "leaky_relu": 2}
# csrc/igemm.cuh::kNoEncoder, kEncodeError
_NO_ENCODER, _ENCODE_ERROR = 99999, 100000


def check_launch(name: str, err: int) -> None:
    if err == _NO_ENCODER:
        raise RuntimeError(f"{name}: cudaGetDriverEntryPoint found no "
                           "cuTensorMapEncodeTiled")
    if err >= _ENCODE_ERROR:
        index, result = divmod(err - _ENCODE_ERROR, 1000)
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed for "
                           f"tensor map {index} with CUresult {result}")
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def cached(t: torch.Tensor, key, make):
    """``make(t)``, computed once per version of ``t`` and kept on ``t``.

    A kernel's prepared operand (a transposed or pre-summed weight) lives as
    long as the tensor it came from. It is made again after an in-place
    change to ``t`` (which bumps ``t._version``: optimizer steps,
    ``load_state_dict``, ``copy_``), a new storage or a move to another
    device. Writes through ``t.data`` bypass the version counter and are
    not seen. An inference tensor has no version counter and cannot be
    changed outside inference mode; its first result stands."""
    stamp = (None if t.is_inference() else t._version, t.data_ptr(),
             t.device, t.dtype)
    store = t.__dict__.setdefault("_fetal_prepared", {})
    hit = store.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    value = make(t)
    store[key] = (stamp, value)
    return value


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
