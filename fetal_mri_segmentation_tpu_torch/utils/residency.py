"""Serving options shared by the two predictors (port of the placement-free
part of ``fetal_mri_segmentation_tpu/utils/residency.py``).

The TTA-mode and probability-transfer spellings, the in-program
fixed-point quantization of a probability map and its host-side
dequantization, one implementation for the sliding-window and the direct
predictor so the two cannot drift. The JAX module's ``ResidentParamsMixin``
and ``host_round_for_model`` have no counterpart: the port's model holds
its weights on the device, and :func:`stage_to_device` stages a volume in
the model's dtype for both predictors.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def normalize_tta_mode(tta: Union[bool, str, None]) -> Optional[str]:
    """A predictor's ``tta`` argument as None | "permute" | "flips":
    False/None -> no TTA, True -> "permute" (the reference's
    ``predict(permute=True)`` 48-symmetry average), strings validated."""
    mode = tta if isinstance(tta, str) else ("permute" if tta else None)
    if mode not in (None, "permute", "flips"):
        raise ValueError(f"unknown TTA mode {mode!r} "
                         "(expected 'permute' or 'flips')")
    return mode


def is_fp16_transfer(transfer_dtype) -> bool:
    """True when ``transfer_dtype`` asks for the fp16 probability transfer
    (half the D2H bytes; max quantization ~4.9e-4 on [0, 1])."""
    return str(transfer_dtype) in ("float16", "fp16", "half")


# probability-transfer quantization scales: probabilities live in [0, 1], so
# a fixed-point integer transfer is exact to 0.5/scale: uint8 cuts the D2H
# bytes 4x against fp32 (max error 2.0e-3), uint16 2x (7.6e-6)
_QUANT_SCALE = {"uint8": 255.0, "uint16": 65535.0}


def resolve_prob_transfer(transfer_dtype) -> str:
    """``transfer_dtype`` as "float32" | "float16" | "uint8" | "uint16"."""
    s = str(transfer_dtype)
    if s in ("float32", "fp32", "single", "None"):
        return "float32"
    if is_fp16_transfer(s):
        return "float16"
    if s in ("uint8", "u8"):
        return "uint8"
    if s in ("uint16", "u16"):
        return "uint16"
    raise ValueError(f"unknown probability transfer dtype {transfer_dtype!r}"
                     " (expected float32, float16, uint8 or uint16)")


def quantize_prob(prob: torch.Tensor, kind: str) -> torch.Tensor:
    """Fixed-point quantization of a [0, 1] probability map on its device:
    ``round(clip(p, 0, 1) * scale)``, half to even as ``jnp.round``, so only
    the integer volume crosses the D2H link. torch has no uint16 arithmetic
    on every device, so the rounded values (at most 65535) pass through
    int32 and are stored as uint16."""
    scale = _QUANT_SCALE[kind]
    q = torch.round(prob.float().clamp(0.0, 1.0) * scale)
    if kind == "uint8":
        return q.to(torch.uint8)
    return q.to(torch.int32).to(torch.uint16)


def transfer_prob(prob: torch.Tensor, transfer_dtype) -> torch.Tensor:
    """A float32 probability map in the resolved transfer dtype, on its
    device (no synchronization)."""
    kind = resolve_prob_transfer(transfer_dtype)
    if kind == "float32":
        return prob
    if kind == "float16":
        return prob.to(torch.float16)
    return quantize_prob(prob, kind)


def stage_to_device(data, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A volume on ``device`` in the model's ``dtype``, with no
    synchronization. A tensor already on the card (the device
    preprocessor's output) is cast in place, with no host round trip. A
    host array is rounded to ``dtype`` on the host (a bf16 model uploads
    half the bytes, with the values its first op would round to anyway)
    and copied from pinned memory without blocking: a copy from pageable
    memory would wait for the stream to drain, so case i+1's upload would
    wait for case i's compute."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.asarray(data, np.float32))
    if data.device.type == "cpu" and device.type == "cuda":
        return data.to(dtype).pin_memory().to(device, non_blocking=True)
    return data.to(device=device, dtype=dtype)


def unpack_prob_f32(out) -> np.ndarray:
    """An async probability result (a device tensor or an array) as float32
    (L, D, H, W) on the host, dequantizing fixed-point transfers by their
    dtype's scale. On the fp32 path the host array is already float32 and
    is not copied again."""
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    arr = np.asarray(out)
    scale = _QUANT_SCALE.get(str(arr.dtype))
    if scale is not None:
        return arr.astype(np.float32) / np.float32(scale)
    return arr.astype(np.float32, copy=False)
