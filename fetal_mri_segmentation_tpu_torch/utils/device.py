"""Device selection without silent fallback."""

from __future__ import annotations

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
