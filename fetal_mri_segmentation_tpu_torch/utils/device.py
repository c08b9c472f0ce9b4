"""Device selection without silent fallback."""

from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device on a machine without
    CUDA raises instead of moving the work to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {str(device)!r}: the port runs on 'cpu' "
                         "or 'cuda'")
    return dev


def device_table(make):
    """``functools.cache`` for a constant table kept per device (a fresh
    host-to-device copy on every call would stall the host), except while
    ``torch.export`` traces: a table made then is a fake tensor, which the
    cache would hand to every later call. The traced program holds its own
    copy as a constant instead."""
    cached = functools.cache(make)

    @functools.wraps(make)
    def table(*args):
        if torch.compiler.is_compiling():
            return make(*args)
        return cached(*args)

    return table
