"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit) and the least time a piece of work could take on it.

``bound_ms`` is a copy of ``chip_smoke.py::bound_ms`` of the repository's
root (with its constants ``PEAK_BF16_FLOPS`` and ``HBM_BYTES_PER_S``)."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_ms(flop: float, nbytes: float):
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes (each input read once,
    each output written once) over the HBM rate; and which of the two."""
    ops, mem = flop / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")
