"""The portable program: the whole-volume label-map program as one file.

Port of ``fetal_mri_segmentation_tpu/utils/export.py``. Where the JAX
package serializes its jitted program with ``jax.export``, the port
captures the predictor's device program with ``torch.export``: model graph,
weights (baked in), the sliding-window reconstruction (or the direct
whole-volume forward) and the label map, for one fixed image shape, with
the patch-grid loops unrolled. A consumer needs torch alone, not the
port's model classes or a checkpoint::

    # producer (has the port and the weights)
    export_predictor(model, config, image_shape, "model.fetal")

    # consumer
    predict = load_predictor("model.fetal", device="cuda")
    labels = predict(volume)  # (C, D, H, W) f32 -> (D, H, W) label map

``platforms`` carries JAX's rule over to the port's two targets. The JAX
package pins the parity decoder and no fold (``fold_override("off")``,
``decoder_form_override("parity")``) for every artifact that targets a
platform other than the TPU; the port targets only ``"cuda"`` and
``"cpu"``, so it pins both in every artifact it writes, and the artifact of
a fold config is the unfolded program. With ``"cpu"`` in the list (the
default ``["cuda", "cpu"]``) the trace also runs with both kernel switches
off, on the plain route, so the artifact holds stock ops only and runs on
either device. ``["cuda"]`` alone keeps the configured switches: the graph
then holds the Hopper kernels as the custom ops ``fetal::conv3x3`` and
``fetal::up_concat_conv3x3`` (``ops/conv3x3.py``, ``ops/dec0.py``), the
artifact runs on the card only, and its loader imports those two modules
to register them. Such an export needs the model on the card: it never
falls back to a portable artifact.

The file: the port's magic, a little-endian u32 metadata length, the JSON
metadata (the JAX package's keys plus ``"platforms"`` and the host label
map's ``"label_dtype"``), then the bytes of ``torch.export.save``.
"""

from __future__ import annotations

import contextlib
import io
import json
import struct
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

_MAGIC = b"FETALTORCH1"
PLATFORMS = ("cuda", "cpu")
# the ops modules that register the fetal:: custom ops of a CUDA artifact
_OPS_MODULES = ("fetal_mri_segmentation_tpu_torch.ops.conv3x3",
                "fetal_mri_segmentation_tpu_torch.ops.dec0")


class LabelProgram(nn.Module):
    """(C, D, H, W) fp32 volume -> (D, H, W) label map, on the predictor's
    device: what ``predict_labels_async`` enqueues, as one traceable
    forward. ``predictor`` is a ``SlidingWindowPredictor`` or, with
    ``direct``, a ``SpatialPredictor`` on one device."""

    def __init__(self, predictor, threshold: float, direct: bool):
        super().__init__()
        self.model = predictor.model
        self.predictor = predictor
        self.threshold = float(threshold)
        self.direct = direct

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        from fetal_mri_segmentation_tpu_torch.utils.packing import (
            device_label_map)

        p = self.predictor
        if self.direct:
            prob = p._probs(vol.to(p.model.dtype))
        else:
            padded = p._stage_volume(vol)
            acc = p.accumulate(padded, range(p.n_batches))
            crop = tuple(slice(int(b), int(b) + s)
                         for b, s in zip(p.pad_before, p.image_shape))
            prob = (acc / p.weight_sum)[crop].permute(3, 0, 1, 2)
        return device_label_map(prob, self.threshold, p.n_labels,
                                p.config.labels)


@contextlib.contextmanager
def _traceable(model: nn.Module, kernels: bool):
    """``model`` as the trace needs it, restored on exit: every conv block
    with its kernel switches as configured (``kernels``) or off, and the
    norm modules that carry flax's name "in" renamed "in_". The loaded
    program's code names every parameter by its attribute path, and a
    Python keyword there does not compile."""
    from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock

    blocks = [m for m in model.modules() if isinstance(m, ConvBlock)]
    saved = [(b.use_kernel_conv, b.use_kernel_dec0, b.norm_key)
             for b in blocks]
    for b in blocks:
        if not kernels:
            b.use_kernel_conv = b.use_kernel_dec0 = False
        if b.norm_key == "in":
            b._modules["in_"] = b._modules.pop("in")
            b.norm_key = "in_"
    try:
        yield
    finally:
        for b, (conv, dec0, key) in zip(blocks, saved):
            b.use_kernel_conv, b.use_kernel_dec0 = conv, dec0
            if key != b.norm_key:
                b._modules[key] = b._modules.pop(b.norm_key)
                b.norm_key = key


def _platforms(platforms: Optional[Sequence[str]]) -> list:
    plats = list(platforms) if platforms else list(PLATFORMS)
    unknown = [p for p in plats if p not in PLATFORMS]
    if unknown or len(set(plats)) != len(plats):
        raise ValueError(f"platforms {plats}: each of {list(PLATFORMS)} at "
                         "most once")
    return plats


def export_predictor(model, config, image_shape: Sequence[int], path: str,
                     overlap: int = 16, patch_batch_size: int = 27,
                     threshold: float = 0.5, tta: Union[bool, str] = False,
                     platforms: Optional[Sequence[str]] = None,
                     direct: bool = False) -> None:
    """Serialize the whole-volume label-map program of ``model`` (on its
    device) for volumes of ``image_shape`` to ``path``.

    ``tta`` bakes the symmetry average in (True/"permute": 48 members,
    "flips": 8), as ``predict --tta`` does; ``direct`` serializes the
    direct whole-volume forward instead of the sliding window, the volume
    checked here, at export time. ``platforms``: see the module docstring;
    ``["cuda"]`` raises unless ``model`` is on a CUDA device. A ``mednext``
    model raises: its program is not exported (``predict`` and ``serve``
    run it from the port's checkpoint)."""
    from fetal_mri_segmentation_tpu_torch.inference.labelmaps import (
        label_map_dtype)
    from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
        SlidingWindowPredictor)
    from fetal_mri_segmentation_tpu_torch.models.layers import (
        decoder_form_override, fold_override, set_spatial_group)
    from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
        make_direct_predictor)

    if config.model_name == "mednext":
        raise ValueError("mednext: predict --export is not supported; predict "
                         "and serve run the model from the port's checkpoint")
    plats = _platforms(platforms)
    device = next(model.parameters()).device
    if "cpu" not in plats and device.type != "cuda":
        raise RuntimeError(
            f"platforms={plats} keeps the Hopper kernels in the program, "
            f"which needs the model on a CUDA device, not {device}; "
            "export with the default platforms for a portable artifact")
    n_ch = len(config.training_modalities)
    image_shape = tuple(int(s) for s in image_shape)
    if direct:
        predictor = make_direct_predictor(model, config, tta=tta)
        # fail at export time with the curated errors, not in the consumer
        predictor._check_volume((n_ch,) + image_shape)
    else:
        predictor = SlidingWindowPredictor(
            model, config, image_shape=image_shape, overlap=overlap,
            patch_batch_size=patch_batch_size, tta=tta)
    model.eval()
    set_spatial_group(model, None)
    program = LabelProgram(predictor, threshold, direct)
    example = torch.zeros((n_ch,) + image_shape, dtype=torch.float32,
                          device=device)
    with _traceable(model, kernels="cpu" not in plats), torch.no_grad(), \
            fold_override("off"), decoder_form_override("parity"):
        exported = torch.export.export(program, (example,))
    labels = list(config.labels or range(1, int(config.n_labels) + 1))
    meta = {
        "image_shape": list(image_shape),
        "n_channels": n_ch,
        "n_labels": int(config.n_labels),
        "labels": labels,
        "threshold": threshold,
        "tta": tta,
        "direct": direct,
        # the port moves the label map unpacked (utils/packing.py)
        "packed_bits": False,
        "model_name": config.model_name,
        "platforms": plats,
        "label_dtype": np.dtype(label_map_dtype(labels)).name,
    }
    blob = io.BytesIO()
    torch.export.save(exported, blob)
    meta_blob = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(meta_blob)))
        f.write(meta_blob)
        f.write(blob.getvalue())


def load_predictor(path: str, device=None):
    """Load an artifact of :func:`export_predictor`; returns ``predict(vol)
    -> label map`` (a numpy array in the artifact's ``label_dtype``).
    ``predict.meta`` is the metadata and ``predict.program`` the loaded
    ``torch.export`` module on ``device``, for callers that keep tensors on
    the device.

    ``device``: where the program runs, "cuda" by default; a CPU device for
    a CUDA-only (``["cuda"]``) artifact raises. Needs torch alone, and for
    a CUDA-only artifact the port's two ops modules, which register the
    kernels' custom ops; it never imports the model classes. A file that
    is not such an artifact, or is truncated, raises ``ValueError``."""
    import importlib
    import zipfile

    device = torch.device("cuda" if device is None else device)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a fetal export artifact of the "
                             "PyTorch port")
        try:
            (meta_len,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(meta_len).decode())
            blob = f.read()
        except (struct.error, json.JSONDecodeError, UnicodeDecodeError,
                EOFError) as e:
            # a truncated or corrupt artifact behind a valid magic keeps
            # the documented ValueError contract
            raise ValueError(f"{path}: truncated or corrupt export artifact "
                             f"({type(e).__name__}: {e})") from e
    plats = meta.get("platforms", [])
    if device.type not in plats:
        raise ValueError(f"{path}: exported for {plats}; it cannot run on "
                         f"{device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' for a portable artifact")
    if "cpu" not in plats:
        for name in _OPS_MODULES:
            importlib.import_module(name)
    try:
        exported = torch.export.load(io.BytesIO(blob))
    except (zipfile.BadZipFile, EOFError, RuntimeError) as e:
        raise ValueError(f"{path}: truncated or corrupt export artifact "
                         f"({type(e).__name__}: {e})") from e
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(exported, device).module()
    label_dtype = np.dtype(meta["label_dtype"])

    def predict(vol_cdhw) -> np.ndarray:
        vol = torch.as_tensor(np.asarray(vol_cdhw, np.float32)).to(device)
        with torch.no_grad():
            out = program(vol)
        return out.cpu().numpy().astype(label_dtype)

    predict.meta = meta
    predict.program = program
    return predict
