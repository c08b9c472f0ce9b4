#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each (or one line per checked shape):

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, the device;
2. build: compiles the Hopper kernels from ``fetal_mri_segmentation_tpu_torch/
   csrc``, prints the seconds and ptxas's registers, spills and shared
   memory, and asserts from ``cuobjdump -sass`` that every instance of
   ``conv3x3_kernel`` and ``dec0_kernel`` issues ``HGMMA`` (wgmma);
3. kernels: each kernel against its plain PyTorch version at every shape
   the serving slice gives it (depth-4, 32-filter U-Net on a batch of 8 64^3
   patches), the same layers at the training path's batches (6 and 12),
   plus non-cubic and ragged-tile shapes that also cover the other
   activations, with the tolerance, both times, the kernel's TFLOP/s and
   the time of its one-off weight preparation;
4. slice: three synthetic ellipsoid NIfTI cases at a scanner-like raw shape
   through ``fetal_mri_segmentation_tpu_torch.predict.main`` with
   ``configs/fetal_unet.json``, both kernel switches on and random weights
   from a seed; the kernels' launch counts over that run; the same
   predictor with the switches off as the reference;
5. train: the same config at full width (batch 6 of 64^3 patches) through
   the port's train step: one step's gradients with the kernels on against
   the switches off (every parameter's relative L2 error and the loss) and
   that step's launch counts, the step's milliseconds, its forward and
   backward parts and its peak memory with the kernels on and off (and
   with TF32 off for the kernel route's fp32 backward convolutions), then
   ``train_model`` for two epochs on the three synthetic cases
   preprocessed into an in-memory data file, with augmentation, and the
   kernels' launch counts over that run: one forward's worth per step;
6. serve: the same config and weights through the serving surface. The
   on-device preprocessing of the three cases against the host's scipy
   path (and its seconds per case against the host's), then on one
   device-preprocessed case the direct predictor plain, with flips and
   with the 48 symmetries, and the sliding window with flips and with the
   48 symmetries, each against the switches off; ``predict.main`` with
   ``direct`` and ``device_preprocess`` on the three cases and with
   ``prob_map`` (float32 and uint8) on one; ``serve.main`` with ``once``
   and a stats file on a watch directory of the three cases. Every counted
   run's launches must be its forwards' worth exactly; each path prints
   its seconds per case with the kernels and without;
7. isensee: ``configs/fetal_isensee.json`` (Isensee2017, depth 5, 16 base
   filters, InstanceNorm + LeakyReLU blocks, dropout 0.3, 3 deep-supervision
   heads) with random weights from a seed. Each of its kernel shapes with
   activation "none" at the serving batch 8, the train batch 6, the
   validation batch 12 and the direct 128^3 volume at batch 1 (bound,
   plain and cuDNN times, share of the bound); the sliding window and the direct predictor on the three
   cases against the switches off, ``predict.main`` and ``serve.main
   --once --direct --device-preprocess``; one train step's gradients on
   against off from the same weights, batch and dropout masks, the step's
   times and peak memory on and off; ``train_model`` for two epochs (the
   loss falls, the checkpoint reloads bit for bit); and one batch-8 forward
   of the U-Net with InstanceNorm against the switches off, where the
   fused-decoder kernel runs with activation "none" before the norm. Every
   counted run's launches are exact: 6 / 8 / 0 per serving forward, 8 /
   10 / 0 per training forward, 6 / 4 / 3 for the U-Net;
8. experiment: ``configs/fetal_unet.json`` at full width with ``distort``
   0.25 and ``rotate`` 15 through the experiment path's entry points, on
   six synthetic cases: ``train.main`` builds the dataset in the port's
   directory layout, writes the split, trains two epochs (the loss falls)
   and writes the checkpoint; ``apply_scale`` and ``apply_rotation`` on the
   card against the CPU (x within ``RESAMPLE_TOL``, truth equal) and a
   train step's milliseconds with and without them; ``predict.main`` with
   no input and no params predicts the validation split from the
   checkpoint and the dataset through the sliding window and with
   ``direct`` (its probabilities and the switches-off path's each held to
   an fp32 model); ``evaluate.main`` scores that tree and
   ``ensemble.main`` merges two probability trees. Launches exactly 6 / 4
   / 3 per forward of each counted run.

The kernel phase also checks every kernel layer of the direct 128^3
forward at batch 1 and at the TTA chunks of 2 and 8, and prints each
shape's bound (the larger of its operations over
the bf16 peak and its bytes over the HBM rate) and the time of one cuDNN
convolution on the same inputs (``library_ms``).

Then one JSON line describing the kernels, and the last line
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero; without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel check tolerance: max|kernel - ref| <= REL_TOL * max|ref| + ABS_TOL.
# The kernel stores bf16 (relative rounding 2^-9) after an fp32 sum whose
# order differs from cuDNN's; the reference is fp32 on the same
# bf16-rounded inputs, so the expected error is one bf16 rounding of the
# output, about 0.2% of max|ref|. 1e-2 leaves a 5x margin and still catches
# a wrong tap, channel or parity, which moves outputs by O(max|ref|).
REL_TOL, ABS_TOL = 1e-2, 1e-2
# Slice tolerance on probabilities, kernels on against kernels off: the two
# paths round each of the 14 bf16 3^3 conv outputs at different places
# (after vs before the bias), a difference of up to one bf16 ulp per layer
# that compounds through the net; the sigmoid's slope is at most 1/4.
PROB_TOL = 2e-2

# Train-phase bounds, kernels on against off from the same weights and
# batch. The two forwards round each bf16 conv output at different places
# (PROB_TOL above), and the backward differs by design: the kernel route's
# VJP recomputes each pre-activation in fp32 where cuDNN's bf16 autograd
# keeps bf16 activations and gradients, so each layer's gradient carries a
# few bf16 roundings (2^-9 each) of difference; 5e-2 relative L2 leaves
# room for their growth through 15 layers and still fails a missing or
# misrouted gradient (relative error 1). The loss is a ratio of sums over
# 1.5M voxels, where those roundings average out.
GRAD_REL_TOL, LOSS_TOL = 5e-2, 1e-3
# Probabilities of a model with a norm after every conv (Isensee2017, the
# U-Net with InstanceNorm), kernels on against off. Each of Isensee's 23
# conv blocks ends in an fp32 InstanceNorm that scales every channel back to unit
# variance, so the one-bf16-ulp (2^-8) difference in where the two routes
# round a conv's output is not damped with depth as in the U-Net, and with
# random weights the summed heads leave most voxels near p = 0.5, where the
# sigmoid is steepest. Measured on the H100 (NVIDIA H100 80GB HBM3, 700 W):
# max|p_on - p_off| 0.0185 (sliding window) and 0.0227 (direct) over the
# three cases, every flipped label within 0.02 of 0.5; 5e-2 is twice the
# worst. Both paths are also held to an fp32 model on the same weights: the
# kernel route may be no further from it than twice the cuDNN path is.
NORM_PROB_TOL = 5e-2
# The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the full 700 W power limit): bf16 tensor cores and HBM3. A kernel's bound
# is the larger of its operations and its bytes over these.
PEAK_BF16_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12

B = 8  # patches per forward: the entry point's --patch-batch-size
# (entry point, layer, batch, D, H, W, C_in, C_out): every kernel conv of
# the depth-4/32 U-Net on 64^3 patches, then non-cubic shapes and shapes with
# a ragged tile in M, K (C_in past the last full K step) and N
CONV_SHAPES = [
    ("conv3x3_flat", "enc0_conv2", B, 64, 64, 64, 32, 64),
    ("conv3x3_flat", "enc1_conv1", B, 32, 32, 32, 64, 64),
    ("conv3x3_flat", "enc1_conv2", B, 32, 32, 32, 64, 128),
    ("conv3x3", "enc2_conv1", B, 16, 16, 16, 128, 128),
    ("conv3x3", "enc2_conv2", B, 16, 16, 16, 128, 256),
    ("conv3x3", "enc3_conv1", B, 8, 8, 8, 256, 256),
    ("conv3x3", "enc3_conv2", B, 8, 8, 8, 256, 512),
    ("conv3x3", "dec2_conv2", B, 16, 16, 16, 256, 256),
    ("conv3x3", "dec1_conv2", B, 32, 32, 32, 128, 128),
    ("conv3x3_flat", "dec0_conv2", B, 64, 64, 64, 64, 64),
    ("conv3x3_flat", "non-cubic", 2, 12, 20, 28, 32, 64),
    ("conv3x3_flat", "ragged", 3, 7, 9, 11, 24, 40),
    ("conv3x3_flat", "ragged-K", 1, 3, 5, 4, 40, 8),
    ("conv3x3", "ragged-N", 2, 5, 6, 20, 128, 200),
]
# (layer, batch, coarse D, H, W, C_up, C_skip, C_out) of the fused decoder
DEC_SHAPES = [
    ("dec2_conv1", B, 8, 8, 8, 512, 256, 256),
    ("dec1_conv1", B, 16, 16, 16, 256, 128, 128),
    ("dec0_conv1", B, 32, 32, 32, 128, 64, 64),
    ("non-cubic", 2, 3, 4, 5, 32, 16, 24),
    ("ragged", 3, 5, 3, 7, 24, 40, 40),
]
SLICE_LAYERS = {"enc", "dec"}
# kernel launches per forward of the U-Net: the slice layers above list
# each of its kernel layers once (6 conv3x3, 4 conv3x3_flat, 3 fused
# decoders); the kernel routes' backward launches none
PER_FORWARD = {entry: sum(e == entry and layer[:3] in SLICE_LAYERS
                          for e, layer, *_ in CONV_SHAPES)
               for entry in ("conv3x3", "conv3x3_flat")}
PER_FORWARD["up_concat_conv3x3_kernel"] = sum(
    layer[:3] in SLICE_LAYERS for layer, *_ in DEC_SHAPES)
# The training path's batches (configs/fetal_unet.json): the train step's
# batch_size and the eval step's validation_batch_size. They change the
# persistent kernels' tile counts, so every slice layer is checked at both
# too; labelled "train ...", they stay out of the serving sums.
TRAIN_BATCHES = (6, 12)
CONV_SHAPES += [(entry, f"train {layer}", tb, *rest)
                for entry, layer, _, *rest in CONV_SHAPES
                if layer[:3] in SLICE_LAYERS for tb in TRAIN_BATCHES]
DEC_SHAPES += [(f"train {layer}", tb, *rest)
               for layer, _, *rest in DEC_SHAPES
               if layer[:3] in SLICE_LAYERS for tb in TRAIN_BATCHES]
# The serve phase's shapes: the direct predictor runs every kernel layer on
# the whole 128^3 volume at batch 1 (twice the patch's extent per axis),
# and its test-time augmentation runs every layer again in chunks of 2
# (flips) and 8 (the 48 symmetries), where the full-resolution layers hold
# the largest tensors (8 x 128^3 x 64 bf16 is 2^31 bytes). Labelled
# "direct ..." and "tta<b> ...", they stay out of the serving sums.
DIRECT_BATCHES = (("direct", 1), ("tta2", 2), ("tta8", 8))
CONV_SHAPES += [(entry, f"{tag} {layer}", b, 2 * d, 2 * h, 2 * w, ci, co)
                for entry, layer, _, d, h, w, ci, co in CONV_SHAPES
                if layer[:3] in SLICE_LAYERS for tag, b in DIRECT_BATCHES]
DEC_SHAPES += [(f"{tag} {layer}", b, 2 * d, 2 * h, 2 * w, *rest)
               for layer, _, d, h, w, *rest in DEC_SHAPES
               if layer[:3] in SLICE_LAYERS for tag, b in DIRECT_BATCHES]
# the slice's blocks use relu; the extra shapes cover the other activations
ACTIVATION = {"non-cubic": "none", "ragged": "leaky_relu",
              "ragged-K": "leaky_relu", "ragged-N": "none"}
# Isensee2017 of configs/fetal_isensee.json (depth 5, 16 base filters) on
# 64^3 patches: (entry, layer, extent, C_in, C_out, launches per serving
# forward, per training forward) of each kernel shape. Every block is conv
# -> InstanceNorm -> LeakyReLU, so the kernels run with activation "none"
# and the norm follows in fp32. In training the up-sampling module is
# upsample-then-conv, at the shape of its level's loc1 (a second launch
# there); in eval it is the fused form with no skip, which the fused-decoder
# kernel does not take (a plain op, as in the JAX package). The stem, the
# stride-2 entries and the 1^3 blocks and heads stay on F.conv3d.
ISENSEE_LAYERS = [
    ("conv3x3_flat", "enc0_ctx", 64, 16, 16, 2, 2),
    ("conv3x3_flat", "enc1_ctx", 32, 32, 32, 2, 2),
    ("conv3x3_flat", "enc2_ctx", 16, 64, 64, 2, 2),
    ("conv3x3", "enc3_ctx", 8, 128, 128, 2, 2),
    ("conv3x3", "enc4_ctx", 4, 256, 256, 2, 2),
    ("conv3x3", "dec3_loc1", 8, 256, 128, 1, 2),
    ("conv3x3", "dec2_loc1", 16, 128, 64, 1, 2),
    ("conv3x3_flat", "dec1_loc1", 32, 64, 32, 1, 2),
    ("conv3x3_flat", "dec0_loc1", 64, 32, 16, 1, 2),
]
ISENSEE_PER_FORWARD, ISENSEE_PER_TRAIN = (
    {entry: sum(row[col] for row in ISENSEE_LAYERS if row[0] == entry)
     for entry in ("conv3x3", "conv3x3_flat")} for col in (5, 6))
ISENSEE_PER_FORWARD["up_concat_conv3x3_kernel"] = 0
ISENSEE_PER_TRAIN["up_concat_conv3x3_kernel"] = 0
# every shape at the serving batch (summed per forward), the train step's
# batch, the eval step's (validation_batch_size) and the direct predictor's
# whole 128^3 volume at batch 1
ISENSEE_BATCHES = (("serve", B, 1), ("train", 6, 1), ("val", 12, 1),
                   ("direct", 1, 2))
ISENSEE_SHAPES = [(entry, f"{tag} isensee {layer}", b, s * n, s * n, s * n,
                   ci, co)
                  for tag, b, s in ISENSEE_BATCHES
                  for entry, layer, n, ci, co, *_ in ISENSEE_LAYERS]
ACTIVATION.update({shape[1]: "none" for shape in ISENSEE_SHAPES})
KERNELS = {
    "conv3x3": ("fetal_mri_segmentation_tpu_torch/csrc/conv3x3.cu",
                "fetal_mri_segmentation_tpu/ops/pallas_conv.py:43"),
    "conv3x3_flat": ("fetal_mri_segmentation_tpu_torch/csrc/conv3x3.cu",
                     "fetal_mri_segmentation_tpu/ops/pallas_conv_flat.py:83"),
    "up_concat_conv3x3_kernel": (
        "fetal_mri_segmentation_tpu_torch/csrc/dec0.cu",
        "fetal_mri_segmentation_tpu/ops/pallas_dec0.py:123"),
}


def time_ms(torch, fn, iters: int = 10) -> float:
    """Mean device milliseconds per call: CUDA events around ``iters``
    calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(flop: float, nbytes: float):
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes (each input read once,
    each output written once) over the HBM rate; and which of the two."""
    ops, mem = flop / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def check(label, out, ref, stats, entry, weight, times, flop, nbytes):
    """Hold one kernel call against its plain version and record its times
    (``times``: ms, plain_ms, prep_ms and library_ms or None), added to the
    entry's sums ``weight`` times (the shape's launches per forward; 0
    leaves it out of the sums)."""
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = REL_TOL * scale + ABS_TOL
    bound, by = bound_ms(flop, nbytes)
    lib = times["library_ms"]
    print(f"kernel {entry} {label}: max|diff| {err:.6g} <= tol {tol:.6g} "
          f"(max|ref| {scale:.6g}); ms {times['ms']:.6g} plain_ms "
          f"{times['plain_ms']:.6g} library_ms "
          f"{'none' if lib is None else f'{lib:.6g}'} prep_ms "
          f"{times['prep_ms']:.6g}; {flop / times['ms'] / 1e9:.6g} TFLOP/s; "
          f"bound {bound:.6g} ms ({by}), {bound / times['ms']:.4f} of it",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{entry} {label}: max|diff| {err} > {tol}")
    s = stats.setdefault(entry, {"max_abs_err": 0.0, "ms": 0.0,
                                 "plain_ms": 0.0, "bound_ms": 0.0,
                                 "library_ms": None, "prep": 0.0,
                                 "ops_ms": 0.0, "bytes_ms": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if weight:
        s["ms"] += weight * times["ms"]
        s["plain_ms"] += weight * times["plain_ms"]
        s["prep"] += weight * times["prep_ms"]
        s["bound_ms"] += weight * bound
        s["ops_ms"] += weight * flop / PEAK_BF16_FLOPS * 1e3
        s["bytes_ms"] += weight * nbytes / HBM_BYTES_PER_S * 1e3
        if lib is not None:
            s["library_ms"] = (s["library_ms"] or 0.0) + weight * lib


def conv_case(torch, gen, stats, weight, entry, layer, b, d, h, w, ci,
              co) -> None:
    """One conv kernel shape against its plain version, with the kernel's,
    the plain version's and one cuDNN convolution's times."""
    import torch.nn.functional as F

    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops

    def normal(*shape, std=1.0):
        x = torch.randn(*shape, device="cuda", generator=gen) * std
        return x.to(torch.bfloat16)

    x = normal(b, d, h, w, ci)
    wt = normal(3, 3, 3, ci, co, std=(27 * ci) ** -0.5)
    bias = torch.randn(co, device="cuda", generator=gen) * 0.1
    op = getattr(conv_ops, entry)
    act = (ACTIVATION.get(layer, "relu"), 0.3)
    out = op(x, wt, bias, *act)
    torch.cuda.synchronize()
    ref = conv_ops.conv3x3_reference(x.float(), wt.float(), bias, *act)
    # the library yardstick: one cuDNN convolution with its bias (no
    # activation), on a channels-last view and weight prepared here
    x_lib = x.permute(0, 4, 1, 2, 3)
    w_lib = wt.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    b_lib = bias.to(torch.bfloat16)
    times = {
        # the K-major weight is made at the first call and kept with wt
        "ms": time_ms(torch, lambda: op(x, wt, bias, *act)),
        "plain_ms": time_ms(torch, lambda: conv_ops.conv3x3_reference(
            x, wt, bias, *act)),
        "library_ms": time_ms(torch, lambda: F.conv3d(
            x_lib, w_lib, b_lib, padding=1)),
        "prep_ms": time_ms(torch, lambda: wt.permute(
            4, 0, 1, 2, 3).contiguous())}
    check(f"{layer} {(b, d, h, w)} {ci}->{co} {act[0]}", out, ref, stats,
          entry, weight, times, 2 * b * d * h * w * 27 * ci * co,
          2 * (x.numel() + wt.numel() + out.numel()) + 4 * co)


def summarize(stats, title: str) -> None:
    """Print each entry's sums and record which bound they meet."""
    for entry, s in stats.items():
        ops, mem = s.pop("ops_ms"), s.pop("bytes_ms")
        s["bound_by"] = "operations" if ops >= mem else "bytes"
        lib = s["library_ms"]
        print(f"{title} sum {entry}: kernel {s['ms']:.6g} ms (+ one-off "
              f"weight preparation {s.pop('prep'):.6g} ms) against plain "
              f"{s['plain_ms']:.6g} ms, library "
              f"{'none' if lib is None else f'{lib:.6g} ms'}, bound "
              f"{s['bound_ms']:.6g} ms ({s['bound_by']}; operations term "
              f"{ops:.6g} ms, bytes term {mem:.6g} ms), "
              f"{s['bound_ms'] / s['ms']:.4f} of the bound", flush=True)


def kernel_phase(torch, stats) -> None:
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops

    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, std=1.0):
        x = torch.randn(*shape, device="cuda", generator=gen) * std
        return x.to(torch.bfloat16)

    for entry, layer, *shape in CONV_SHAPES:
        conv_case(torch, gen, stats, int(layer[:3] in SLICE_LAYERS), entry,
                  layer, *shape)

    entry = "up_concat_conv3x3_kernel"
    for layer, b, d, h, w, cu, cs, co in DEC_SHAPES:
        xd = normal(b, d, h, w, cu)
        skip = normal(b, 2 * d, 2 * h, 2 * w, cs)
        k = normal(3, 3, 3, cu + cs, co, std=(27 * (cu + cs)) ** -0.5)
        bias = torch.randn(co, device="cuda", generator=gen) * 0.1
        act = (ACTIVATION.get(layer, "relu"), 0.3)
        out = dec_ops.up_concat_conv3x3_kernel(xd, skip, k, bias, *act)
        torch.cuda.synchronize()
        ref = dec_ops.up_concat_conv3x3_reference(
            xd.float(), skip.float(), k.float(), bias, *act)
        times = {
            # the pre-summed K-major weights are made at the first call,
            # kept with k
            "ms": time_ms(torch, lambda: dec_ops.up_concat_conv3x3_kernel(
                xd, skip, k, bias, *act)),
            "plain_ms": time_ms(
                torch, lambda: dec_ops.up_concat_conv3x3_reference(
                    xd, skip, k, bias, *act)),
            # no one PyTorch call upsamples, concatenates and convolves
            "library_ms": None,
            "prep_ms": time_ms(torch, lambda: dec_ops.kernel_weights(k, cu))}
        check(f"{layer} {(b, d, h, w)} {cu}+{cs}->{co} {act[0]}", out, ref,
              stats, entry, int(layer[:3] in SLICE_LAYERS), times,
              2 * b * 8 * d * h * w * (8 * cu + 27 * cs) * co,
              2 * (xd.numel() + skip.numel() + k.numel() + out.numel())
              + 4 * co)
        del xd, skip, k, out, ref
    summarize(stats, "slice")


def wgmma_check(lib_path: Path) -> str:
    """Every compiled instance of the two conv kernels issues HGMMA (the
    SASS of wgmma.mma_async); a fall back to mma.sync fails here."""
    from fetal_mri_segmentation_tpu_torch.ops import cuda_lib

    sass = subprocess.run([cuda_lib.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        for kernel in ("conv3x3_kernel", "dec0_kernel"):
            if kernel in name:
                counts[name] = block.count("HGMMA")
    for kernel in ("conv3x3_kernel", "dec0_kernel"):
        if not any(kernel in name for name in counts):
            raise AssertionError(f"{kernel} is not in the SASS of {lib_path}")
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"no HGMMA in {missing}")
    return ", ".join(f"{name} {n}" for name, n in sorted(counts.items()))


def write_cases(directory: Path, n: int = 3, shape=(160, 160, 110)):
    """Synthetic fetal-brain-like cases: a noisy bright ellipsoid with its
    truth mask, anisotropic voxels, as <case>/volume.nii.gz + truth."""
    import numpy as np

    from fetal_mri_segmentation_tpu_torch.utils.nifti import save_nifti

    grids = np.mgrid[: shape[0], : shape[1], : shape[2]].astype(np.float32)
    paths = []
    for i in range(n):
        rng = np.random.default_rng(i)
        center = np.array(shape) / 2 + rng.uniform(-8, 8, 3)
        radii = np.array(shape) * rng.uniform(0.2, 0.3, 3)
        dist = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
        truth = (dist < 1).astype(np.uint8)
        vol = (truth * 2.0 + rng.normal(0, 0.3, shape)).astype(np.float32)
        case = directory / f"case_{i}"
        case.mkdir(parents=True)
        affine = np.diag([0.8, 0.8, 2.0, 1.0])
        save_nifti(vol, str(case / "volume.nii.gz"), affine=affine)
        save_nifti(truth, str(case / "truth.nii.gz"), affine=affine)
        paths.append(str(case))
    return paths


def slice_phase(torch, work: Path) -> dict:
    import dataclasses

    import numpy as np

    from fetal_mri_segmentation_tpu_torch import predict as entry
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        build_serving_predictor, load_serving_model, preprocess_case)
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti
    from fetal_mri_segmentation_tpu_torch.utils.params import init_flax_like

    config = Config.load(str(ROOT / "configs" / "fetal_unet.json"))
    config.use_pallas_conv = True
    config.use_pallas_dec0 = True
    params = work / "params.npz"
    np.savez(params, **init_flax_like(config, seed=0))
    inputs = write_cases(work / "cases")
    out_dir = work / "prediction"

    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    n = entry.main(config, str(params), inputs, output_dir=str(out_dir),
                   device="cuda", verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"slice: {n} cases of {config.image_shape} through "
          f"predict.main in {seconds:.4f} s ({seconds / n:.4f} s/case, "
          f"model build and first-call set-up included); launches "
          f"{launches}", flush=True)
    if n != len(inputs):
        raise AssertionError(f"predicted {n} of {len(inputs)} cases")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the slice")
    for path in inputs:
        pred = out_dir / Path(path).name / "prediction.nii.gz"
        label = np.asarray(load_nifti(str(pred)).get_fdata())
        if label.shape != tuple(config.image_shape):
            raise AssertionError(f"{pred}: shape {label.shape}")
        if not set(np.unique(label)) <= {0.0, 1.0}:
            raise AssertionError(f"{pred}: values {np.unique(label)}")

    # the same predictor with the switches off is the reference
    config_off = dataclasses.replace(config, use_pallas_conv=False,
                                     use_pallas_dec0=False)
    on = build_serving_predictor(
        load_serving_model(config, str(params), "cuda"), config,
        overlap=config.validation_patch_overlap, device="cuda")
    off = build_serving_predictor(
        load_serving_model(config_off, str(params), "cuda"), config_off,
        overlap=config.validation_patch_overlap, device="cuda")
    t0 = time.perf_counter()
    data, _, _ = preprocess_case(inputs[0], config)
    pre_s = time.perf_counter() - t0
    p_on = on.predict_probabilities(data)
    p_off = off.predict_probabilities(data)
    if p_on.shape != (config.n_labels,) + tuple(config.image_shape):
        raise AssertionError(f"probabilities shaped {tuple(p_on.shape)}")
    if not bool(torch.isfinite(p_on).all()):
        raise AssertionError("non-finite probabilities")
    diff = (p_on - p_off).abs().max().item()
    lab_on, lab_off = p_on[0] > 0.5, p_off[0] > 0.5
    far = (p_off[0] - 0.5).abs() >= PROB_TOL
    flips = int((lab_on != lab_off).sum().item())
    far_flips = int(((lab_on != lab_off) & far).sum().item())

    def case_seconds(predictor):
        predictor.predict_labels(data)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            predictor.predict_labels(data)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 3

    on_s, off_s = case_seconds(on), case_seconds(off)
    print(f"slice check: max|p_on - p_off| {diff:.6g} <= tol {PROB_TOL} "
          f"(p in [{p_on.min().item():.6g}, {p_on.max().item():.6g}], "
          f"{int(lab_on.sum().item())} foreground voxels); label flips "
          f"{flips}, {far_flips} with |p - 0.5| >= tol; per case: "
          f"preprocess {pre_s:.4f} s, predict_labels {on_s:.4f} s with "
          f"kernels, {off_s:.4f} s without", flush=True)
    if not diff <= PROB_TOL:
        raise AssertionError(f"kernel-on vs kernel-off: {diff} > {PROB_TOL}")
    if far_flips:
        raise AssertionError(f"{far_flips} label flips away from 0.5")
    return launches


def train_batch(config, seed: int = 0):
    """A channels-first batch of the config's patches: an ellipsoid truth
    per example and a noisy image, float32 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = tuple(config.patch_shape)
    grids = np.mgrid[: shape[0], : shape[1], : shape[2]].astype(np.float32)
    x, y = [], []
    for _ in range(config.batch_size):
        center = np.array(shape) / 2 + rng.uniform(-12, 12, 3)
        radii = np.array(shape) * rng.uniform(0.2, 0.35, 3)
        truth = sum(((g - c) / r) ** 2
                    for g, c, r in zip(grids, center, radii)) < 1
        y.append(truth[None].astype(np.float32))
        x.append((y[-1] * 2 + rng.normal(0, 0.3, y[-1].shape)).astype(
            np.float32))
    return np.stack(x), np.stack(y)


def train_phase(torch, work: Path) -> dict:
    import dataclasses
    import csv

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.data.memory import InMemoryDataFile
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu_torch.training.checkpoint import (
        CheckpointIO)
    from fetal_mri_segmentation_tpu_torch.training.loop import train_model
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        _forward, get_loss_fn, make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    # PyTorch's defaults: cuDNN may use TF32 for fp32 convolutions (the
    # kernel route's fp32 backward), matmuls stay fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    config = Config.load(str(ROOT / "configs" / "fetal_unet.json"))
    config.use_pallas_conv = True
    config.use_pallas_dec0 = True
    config_off = dataclasses.replace(config, use_pallas_conv=False,
                                     use_pallas_dec0=False)
    weights = from_flax(init_flax_like(config, seed=0))
    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)

    def zero_counts():
        for fn in counters:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counters}

    def fresh(cfg):
        model = build_model(cfg, "cuda")
        model.load_state_dict(weights)
        return model, create_train_state(model, cfg)

    x_np, y_np = train_batch(config)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()

    # gradient check: one step from the same weights and batch, no
    # augmentation, kernels on against off
    grads, losses = {}, {}
    for name, cfg in (("on", config), ("off", config_off)):
        model, state = fresh(dataclasses.replace(cfg, augment=False))
        step = make_train_step(model, dataclasses.replace(cfg, augment=False))
        zero_counts()
        metrics = step(state, x, y)
        torch.cuda.synchronize()
        step_launches = counts()
        want = PER_FORWARD if name == "on" else dict.fromkeys(PER_FORWARD, 0)
        print(f"train step {name}: launches {step_launches}", flush=True)
        if step_launches != want:
            raise AssertionError(f"one train step with the kernels {name} "
                                 f"launched {step_launches}, not {want}")
        losses[name] = float(metrics["loss"])
        grads[name] = {n: p.grad.float().clone()
                       for n, p in model.named_parameters()}
        del model, state, step
    worst, zero = ("", 0.0), []
    for n, g_off in grads["off"].items():
        g_on = grads["on"][n]
        if not bool((g_on != 0).any()):
            zero.append(n)
        rel = ((g_on - g_off).norm() / g_off.norm()).item()
        if rel > worst[1] or rel != rel:
            worst = (n, rel)
    print(f"train grad check: {len(grads['on'])} parameter tensors; largest "
          f"relative L2 error {worst[1]:.6g} ({worst[0]}) <= tol "
          f"{GRAD_REL_TOL}; loss {losses['on']:.6g} with kernels, "
          f"{losses['off']:.6g} without (|diff| "
          f"{abs(losses['on'] - losses['off']):.6g} <= tol {LOSS_TOL}); "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    if zero:
        raise AssertionError(f"zero gradient with the kernels on: {zero}")
    if not worst[1] <= GRAD_REL_TOL:
        raise AssertionError(f"gradient of {worst[0]}: relative error "
                             f"{worst[1]} > {GRAD_REL_TOL}")
    if not abs(losses["on"] - losses["off"]) <= LOSS_TOL:
        raise AssertionError(f"loss {losses['on']} against {losses['off']}")
    del grads

    # time and memory of the full step (augmentation on), and its parts
    def measure(label, cfg):
        model, state = fresh(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = make_train_step(model, cfg, generator=gen)
        loss_fn = get_loss_fn(cfg)
        step(state, x, y)  # makes the gradients and Adam's moments
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step_ms = time_ms(torch, lambda: step(state, x, y))
        peak = torch.cuda.max_memory_allocated()

        def forward():
            return loss_fn(y, _forward(model, x))

        fwd_ms = time_ms(torch, forward)
        fwd_bwd_ms = time_ms(torch, lambda: forward().backward())
        print(f"train step {label}: {step_ms:.6g} ms per step of "
              f"{cfg.batch_size}x{tuple(cfg.patch_shape)} (augmentation, "
              f"forward, loss, backward, Adam); forward + loss "
              f"{fwd_ms:.6g} ms, + backward {fwd_bwd_ms:.6g} ms (backward "
              f"{(fwd_bwd_ms - fwd_ms) / step_ms:.4f} of the step); peak "
              f"memory {peak / 2**30:.6g} GiB ({(peak - base) / 2**30:.6g} "
              f"GiB above the {base / 2**30:.6g} GiB of weights, gradients "
              f"and optimizer state); "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}",
              flush=True)
        del model, state
        torch.cuda.empty_cache()
        return step_ms

    on_ms = measure("kernels on", config)
    off_ms = measure("kernels off", config_off)
    torch.backends.cudnn.allow_tf32 = False
    on_fp32_ms = measure("kernels on, fp32 backward without TF32", config)
    torch.backends.cudnn.allow_tf32 = True
    print(f"train step: kernels on {on_ms:.6g} ms, off {off_ms:.6g} ms, on "
          f"without TF32 {on_fp32_ms:.6g} ms", flush=True)

    # the loop: two epochs on the synthetic cases, preprocessed into an
    # in-memory data file, with augmentation
    loop_cfg = dataclasses.replace(
        config, n_epochs=2, overwrite=False,
        model_file=str(work / "model.pt"),
        training_file=str(work / "training_ids.pkl"),
        validation_file=str(work / "validation_ids.pkl"),
        training_log=str(work / "training.log"))
    t0 = time.perf_counter()
    data_file = InMemoryDataFile.from_cases(write_cases(work / "cases"),
                                            loop_cfg)
    prep_s = time.perf_counter() - t0
    tg, n_t, vg, n_v = get_training_and_validation_generators(
        data_file, batch_size=loop_cfg.batch_size, n_labels=1,
        training_keys_file=loop_cfg.training_file,
        validation_keys_file=loop_cfg.validation_file,
        data_split=loop_cfg.validation_split, overwrite=True,
        labels=loop_cfg.labels, patch_shape=loop_cfg.patch_shape,
        validation_batch_size=loop_cfg.validation_batch_size,
        validation_patch_overlap=loop_cfg.validation_patch_overlap,
        training_patch_start_offset=loop_cfg.training_patch_start_offset,
        skip_blank=loop_cfg.skip_blank, seed=0)
    model, state = fresh(loop_cfg)
    zero_counts()
    t0 = time.perf_counter()
    state = train_model(model, state, loop_cfg, tg, vg, n_t, n_v, seed=0,
                        verbose=False)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = counts()
    # one forward per train and per validation step, in each epoch
    want = {name: n * loop_cfg.n_epochs * (n_t + n_v)
            for name, n in PER_FORWARD.items()}
    print(f"train loop: launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"train_model launched {launches}, not {want}")
    with open(loop_cfg.training_log) as f:
        rows = list(csv.DictReader(f))
    print("train loop: " + "; ".join(
        f"epoch {r['epoch']} loss {float(r['loss']):.6g} val_loss "
        f"{float(r['val_loss']):.6g} dice {float(r['dice_coefficient']):.6g}"
        f" {float(r['patches_per_sec']):.6g} patches/s" for r in rows)
        + f"; {n_t} + {n_v} steps per epoch, {loop_s:.4f} s for both "
        f"epochs, preprocessing {prep_s:.4f} s", flush=True)
    if [r["epoch"] for r in rows] != ["0", "1"]:
        raise AssertionError(
            f"training log epochs {[r['epoch'] for r in rows]}")
    if not float(rows[1]["loss"]) < float(rows[0]["loss"]):
        raise AssertionError("the training loss did not fall")
    best = CheckpointIO(loop_cfg.model_file)
    _, check = fresh(loop_cfg)
    _, epoch, best_val, _ = best.restore(check)
    if best_val != min(float(r["val_loss"]) for r in rows) or epoch not in (
            1, 2):
        raise AssertionError(f"best checkpoint: epoch {epoch}, {best_val}")
    final = CheckpointIO(str(work / "final.pt"))
    final.save(state, epoch=2, best_val=best_val)
    _, reloaded = fresh(loop_cfg)
    final.restore(reloaded)
    for (n, a), b in zip(model.named_parameters(),
                         reloaded.model.parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"reloaded {n} differs")
    print(f"train checkpoint: best of epoch {epoch} restored, the final "
          f"state reloaded into a fresh model with identical weights",
          flush=True)
    return launches


def serve_phase(torch, work: Path) -> dict:
    """The serving surface: the direct and TTA predictors, on-device
    preprocessing, the probability map and the watch server, each held to
    the kernels-off path and its launch count."""
    import dataclasses
    import json as json_mod

    import numpy as np

    from fetal_mri_segmentation_tpu_torch import predict as entry
    from fetal_mri_segmentation_tpu_torch import serve
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        build_serving_predictor, load_serving_model,
        make_device_preprocessor, predict_cases_pipelined, preprocess_case)
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.ops.resample import (
        DevicePreprocessor)
    from fetal_mri_segmentation_tpu_torch.utils.geometry import (
        process_case_images)
    from fetal_mri_segmentation_tpu_torch.utils.nifti import (
        load_nifti, save_nifti)
    from fetal_mri_segmentation_tpu_torch.utils.params import init_flax_like

    config = Config.load(str(ROOT / "configs" / "fetal_unet.json"))
    config.use_pallas_conv = True
    config.use_pallas_dec0 = True
    config_off = dataclasses.replace(config, use_pallas_conv=False,
                                     use_pallas_dec0=False)
    overlap = config.validation_patch_overlap
    params = work / "params.npz"
    np.savez(params, **init_flax_like(config, seed=0))
    watch = work / "watch"
    inputs = write_cases(watch)
    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)
    launches = {}

    def counted(label, forwards, run):
        """``run()`` with the counts set to 0 just before and read just
        after; they must be ``forwards`` forwards' worth."""
        for fn in counters:
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        want = {k: v * forwards for k, v in PER_FORWARD.items()}
        if got != want:
            raise AssertionError(f"serve {label}: launches {got}, not {want}")
        launches[label] = got
        return out

    def timed(fn, n=1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n

    # preprocessing: the host path (scipy) against the device path, fp32
    # (held to the host at the JAX tests' bound) and bf16 (what a bf16
    # model's serving path stages)
    model_on = load_serving_model(config, str(params), "cuda")
    model_off = load_serving_model(config_off, str(params), "cuda")
    pre32 = DevicePreprocessor(config.image_shape, config.normalization)
    pre16 = make_device_preprocessor(model_on, config)
    preprocess_case(inputs[0], config, device_pre=pre32)  # warm-up
    host_s, dev_s, worst, worst16 = [], [], -float("inf"), 0.0
    for path in inputs:
        t = time.perf_counter()
        host, host_aff, _ = preprocess_case(path, config)
        host_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        dev, dev_aff, _ = preprocess_case(path, config, device_pre=pre32)
        torch.cuda.synchronize()
        dev_s.append(time.perf_counter() - t)
        dev = dev.cpu().numpy()
        excess = np.abs(dev - host) - (5e-3 + 1e-3 * np.abs(host))
        worst = max(worst, float(excess.max()))
        if not np.allclose(dev_aff, host_aff, rtol=0, atol=1e-9):
            raise AssertionError(f"{path}: device affine {dev_aff} against "
                                 f"{host_aff}")
        dev16 = preprocess_case(path, config, device_pre=pre16)[0]
        worst16 = max(worst16, float(np.abs(
            dev16.float().cpu().numpy() - host).max() / host.std()))
    # where the device path's host time goes: the NIfTI reads (gunzip) and
    # the background crop, then the upload, resample and normalize
    t = time.perf_counter()
    images = [load_nifti(f"{inputs[0]}/{name}.nii.gz")
              for name in ("volume", "truth")]
    read_s = time.perf_counter() - t
    t = time.perf_counter()
    cropped = process_case_images(images, image_shape=None)
    crop_s = time.perf_counter() - t
    arrays = [cropped[0].get_fdata(dtype=np.float32)]
    zoom_ms = time_ms(torch, lambda: pre32(arrays))
    print(f"serve preprocess: per case host {np.mean(host_s):.4f} s "
          f"(scipy), device {np.mean(dev_s):.4f} s (read, crop, upload, "
          f"resample and normalize; of it NIfTI reads {read_s:.4f} s, crop "
          f"{crop_s:.4f} s, {zoom_ms:.4f} ms on the card "
          f"from {arrays[0].shape}); fp32 device path within atol 5e-3 + "
          f"rtol 1e-3 of the host (worst margin {-worst:.6g}), affine "
          f"within 1e-9; bf16 staging max |diff| {worst16:.6g} of the "
          f"host's std (bound 5e-2)", flush=True)
    if worst > 0:
        raise AssertionError(f"device preprocessing off the host by {worst} "
                             "beyond atol 5e-3 + rtol 1e-3")
    if not worst16 < 5e-2:
        raise AssertionError(f"bf16 device preprocessing {worst16} std off")

    data = preprocess_case(inputs[0], config, device_pre=pre16)[0]

    def compare(label, on, off, forwards, repeats):
        """The counted kernels-on run and the kernels-off run, each timed;
        a cheap path (``repeats`` > 0) is timed again over that many warm
        label-map runs, where one call's host clock is too short to read."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        p_on = counted(label, forwards, lambda: on.predict_probabilities(
            data))
        on_s = time.perf_counter() - t
        t = time.perf_counter()
        p_off = off.predict_probabilities(data)
        torch.cuda.synchronize()
        off_s = time.perf_counter() - t
        if repeats:
            on_s = timed(lambda: on.predict_labels(data), repeats)
            off_s = timed(lambda: off.predict_labels(data), repeats)
        if p_on.shape != (config.n_labels,) + tuple(config.image_shape):
            raise AssertionError(f"{label}: shape {tuple(p_on.shape)}")
        if not bool(torch.isfinite(p_on).all()):
            raise AssertionError(f"{label}: non-finite probabilities")
        diff = (p_on - p_off).abs().max().item()
        flip = (p_on[0] > 0.5) != (p_off[0] > 0.5)
        far = int((flip & ((p_off[0] - 0.5).abs() >= PROB_TOL)).sum().item())
        print(f"serve {label}: max|p_on - p_off| {diff:.6g} <= tol "
              f"{PROB_TOL}; label flips {int(flip.sum().item())}, {far} with "
              f"|p - 0.5| >= tol; {on_s:.4f} s per case with kernels, "
              f"{off_s:.4f} s without ("
              f"{f'{repeats} warm label-map runs' if repeats else 'one probability run'}"
              f"); launches {launches[label]}", flush=True)
        if not diff <= PROB_TOL or far:
            raise AssertionError(f"{label}: kernels on against off {diff}, "
                                 f"{far} far flips")
        return p_on

    # the predictors, on the device-preprocessed case: 27 patches in 4
    # batches of 8 for the sliding window, one forward per TTA chunk for the
    # direct predictor (flips in 4 chunks of 2, permute in 6 of 8)
    for label, kw, forwards, repeats in (
            ("direct", {"direct": True}, 1, 3),
            ("direct flips", {"direct": True, "tta": "flips"}, 4, 2),
            ("direct permute", {"direct": True, "tta": "permute"}, 6, 0),
            ("sliding flips", {"tta": "flips"}, 4 * 8, 0),
            ("sliding permute", {"tta": "permute"}, 4 * 48, 0)):
        on = build_serving_predictor(model_on, config, overlap=overlap,
                                     device="cuda", **kw)
        off = build_serving_predictor(model_off, config_off, overlap=overlap,
                                      device="cuda", **kw)
        compare(label, on, off, forwards, repeats)
        del on, off
        torch.cuda.empty_cache()

    # the pipelined stream with the direct predictor and the device
    # preprocessor already built: seconds per case end to end, and the
    # NIfTI writes it queues (the label map here; where the inputs are
    # saved, an fp32 volume per modality and the truth too)
    direct_on = build_serving_predictor(model_on, config, direct=True,
                                        device="cuda")
    out_dir = work / "stream"
    e2e = timed(lambda: predict_cases_pipelined(
        [(p, str(out_dir / Path(p).name)) for p in inputs], direct_on,
        config, device_pre=pre16, save_inputs=False,
        verbose=False)) / len(inputs)
    label = load_nifti(str(out_dir / "case_0" / "prediction.nii.gz"))
    write_s = timed(lambda: save_nifti(label.get_fdata().astype(np.uint8),
                                       str(work / "label.nii.gz"),
                                       affine=label.affine))
    vol_s = timed(lambda: save_nifti(host[0], str(work / "vol.nii.gz"),
                                     affine=label.affine))
    print(f"serve pipelined --direct --device-preprocess: {e2e:.4f} s per "
          f"case over {len(inputs)} cases, models built; one label-map "
          f"write {write_s:.4f} s, one fp32 volume write {vol_s:.4f} s",
          flush=True)
    del direct_on

    # predict --direct --device-preprocess on the three cases, on and off
    seconds = {}
    for name, cfg in (("on", config), ("off", config_off)):
        out_dir = work / f"direct_{name}"

        def run(cfg=cfg, out_dir=out_dir):
            return entry.main(cfg, str(params), inputs,
                              output_dir=str(out_dir), direct=True,
                              device_preprocess=True, device="cuda",
                              verbose=False)

        t = time.perf_counter()
        n = (counted("predict --direct", len(inputs), run) if name == "on"
             else run())
        seconds[name] = (time.perf_counter() - t) / n
        for path in inputs:
            label = load_nifti(str(out_dir / Path(path).name
                                   / "prediction.nii.gz")).get_fdata()
            if label.shape != tuple(config.image_shape) or not set(
                    np.unique(label)) <= {0.0, 1.0}:
                raise AssertionError(f"{out_dir}: label map {label.shape}")
    print(f"serve predict --direct --device-preprocess: {len(inputs)} "
          f"cases, {seconds['on']:.4f} s per case with kernels, "
          f"{seconds['off']:.4f} s without (model build included); launches "
          f"{launches['predict --direct']}", flush=True)

    # --prob-map, float32 and uint8 on one case (sliding window): the stored
    # integers reload within 2.0e-3 (half a step of 1/255) of the floats
    maps = {}
    for dtype in ("float32", "uint8"):
        out_dir = work / f"prob_{dtype}"

        def run(dtype=dtype, out_dir=out_dir):
            return entry.main(config, str(params), inputs[:1],
                              output_dir=str(out_dir), prob_map=True,
                              prob_dtype=dtype, device="cuda", verbose=False)

        t = time.perf_counter()
        counted(f"predict --prob-map {dtype}", 4, run)
        seconds[dtype] = time.perf_counter() - t
        maps[dtype] = load_nifti(str(out_dir / Path(inputs[0]).name
                                     / "prediction.nii.gz")).get_fdata()
    q_err = float(np.abs(maps["uint8"] - maps["float32"]).max())
    # the float32 map against the kernels-off sliding window on the same
    # host-preprocessed case
    off = build_serving_predictor(model_off, config_off, overlap=overlap,
                                  device="cuda")
    p_off = off.predict_probabilities(preprocess_case(inputs[0], config)[0])
    p_off = p_off[0].cpu().numpy()
    p_diff = float(np.abs(maps["float32"] - p_off).max())
    far = int(((maps["float32"] > 0.5) != (p_off > 0.5))[
        np.abs(p_off - 0.5) >= PROB_TOL].sum())
    print(f"serve predict --prob-map: uint8 reloads within {q_err:.6g} of "
          f"float32 (bound 2.0e-3); float32 within {p_diff:.6g} of the "
          f"kernels-off predictor (tol {PROB_TOL}), {far} far label flips; "
          f"{seconds['float32']:.4f} s float32, {seconds['uint8']:.4f} s "
          f"uint8 for one case (model build included)", flush=True)
    if not q_err <= 2.0e-3:
        raise AssertionError(f"uint8 probability map off by {q_err}")
    if not p_diff <= PROB_TOL or far:
        raise AssertionError(f"--prob-map against kernels off: {p_diff}, "
                             f"{far} far flips")

    # serve --once on the watch directory (sliding window, device
    # preprocessing), then its labels against the kernels-off predictor
    stats_file = work / "stats.json"
    n = counted("serve --once", 4 * len(inputs), lambda: serve.main(
        config, str(params), str(watch), output=str(work / "served"),
        once=True, device_preprocess=True, stats_file=str(stats_file),
        device="cuda", verbose=False))
    stats = json_mod.loads(stats_file.read_text())
    far = 0
    for path in inputs:
        x = preprocess_case(path, config, device_pre=pre16)[0]
        p_off = off.predict_probabilities(x)[0].cpu().numpy()
        got = load_nifti(str(work / "served" / Path(path).name
                             / "prediction.nii.gz")).get_fdata()
        far += int(((got > 0.5) != (p_off > 0.5))[
            np.abs(p_off - 0.5) >= PROB_TOL].sum())
    print(f"serve --once: {n} cases, latency p50 {stats['latency_sec']['p50']}"
          f" s, p95 {stats['latency_sec']['p95']} s; {far} label flips "
          f"against the kernels-off predictor with |p - 0.5| >= {PROB_TOL}; "
          f"launches {launches['serve --once']}", flush=True)
    if n != len(inputs) or stats["predicted"] != n or far:
        raise AssertionError(f"serve --once: {n} cases, stats {stats}, "
                             f"{far} far flips")
    return launches


def isensee_phase(torch, work: Path) -> dict:
    """Isensee2017 (configs/fetal_isensee.json) on the card, and the U-Net
    with InstanceNorm: the kernels at the Isensee shapes with activation
    "none", serving (sliding window and direct, ``predict`` and ``serve``),
    one train step's gradients and times, ``train_model``, and one U-Net
    forward that takes the fused-decoder kernel before a norm. Returns the
    launches of each counted run and the kernels' sums over one serving
    forward."""
    import csv
    import dataclasses

    import numpy as np

    from fetal_mri_segmentation_tpu_torch import predict as entry
    from fetal_mri_segmentation_tpu_torch import serve
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.data.memory import InMemoryDataFile
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        build_serving_predictor, load_serving_model, preprocess_case)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu_torch.training.checkpoint import (
        CheckpointIO)
    from fetal_mri_segmentation_tpu_torch.training.loop import train_model
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        _forward, get_loss_fn, make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    # the kernels at every Isensee shape, summed over one serving forward
    kernel_stats = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for entry_name, layer, *shape in ISENSEE_SHAPES:
        weight = 0
        if layer.startswith("serve "):
            weight = next(row[5] for row in ISENSEE_LAYERS
                          if layer.endswith(" " + row[1]))
        conv_case(torch, gen, kernel_stats, weight, entry_name, layer,
                  *shape)
    summarize(kernel_stats, "isensee serving forward")

    config = Config.load(str(ROOT / "configs" / "fetal_isensee.json"))
    config.use_pallas_conv = True
    config.use_pallas_dec0 = True
    config_off = dataclasses.replace(config, use_pallas_conv=False,
                                     use_pallas_dec0=False)
    overlap = config.validation_patch_overlap
    params = work / "params.npz"
    np.savez(params, **init_flax_like(config, seed=0))
    inputs = write_cases(work / "cases")
    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)
    launches = {}

    def counted(label, want, run):
        """``run()`` with the counts set to 0 just before and read just
        after; they must be ``want`` exactly."""
        for fn in counters:
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        if got != want:
            raise AssertionError(f"isensee {label}: launches {got}, not "
                                 f"{want}")
        launches[label] = got
        return out

    def forwards(n, table=ISENSEE_PER_FORWARD):
        return {k: v * n for k, v in table.items()}

    def timed(fn, n=1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n

    # serving: the sliding window (27 patches in 4 batches of 8) and the
    # direct predictor on the three host-preprocessed cases, kernels on
    # against off, both against an fp32 model (no TF32) on the same weights
    torch.backends.cudnn.allow_tf32 = False
    models = {"on": load_serving_model(config, str(params), "cuda"),
              "off": load_serving_model(config_off, str(params), "cuda"),
              "fp32": load_serving_model(dataclasses.replace(
                  config_off, compute_dtype="float32"), str(params), "cuda")}
    cases = [preprocess_case(path, config)[0] for path in inputs]
    for label, kw, n in (("sliding", {}, 4), ("direct", {"direct": True}, 1)):
        pred = {name: build_serving_predictor(
            model, config if name == "on" else config_off, overlap=overlap,
            device="cuda", **kw) for name, model in models.items()}
        diff, mean, to32, flips, far = 0.0, 0.0, {"on": 0.0, "off": 0.0}, 0, 0
        for data in cases:
            p_on = counted(label, forwards(n),
                           lambda: pred["on"].predict_probabilities(data))
            p_off = pred["off"].predict_probabilities(data)
            p32 = pred["fp32"].predict_probabilities(data)
            if p_on.shape != (config.n_labels,) + tuple(config.image_shape):
                raise AssertionError(f"isensee {label}: shape "
                                     f"{tuple(p_on.shape)}")
            if not bool(torch.isfinite(p_on).all()):
                raise AssertionError(f"isensee {label}: non-finite")
            diff = max(diff, (p_on - p_off).abs().max().item())
            mean = max(mean, (p_on - p_off).abs().mean().item())
            for name, p in (("on", p_on), ("off", p_off)):
                to32[name] = max(to32[name], (p - p32).abs().max().item())
            flip = (p_on[0] > 0.5) != (p_off[0] > 0.5)
            flips += int(flip.sum().item())
            far += int((flip & ((p_off[0] - 0.5).abs() >= NORM_PROB_TOL)
                        ).sum().item())
        on_s = timed(lambda: pred["on"].predict_labels(cases[0]), 3)
        off_s = timed(lambda: pred["off"].predict_labels(cases[0]), 3)
        print(f"isensee {label}: {len(cases)} cases, max|p_on - p_off| "
              f"{diff:.6g} <= tol {NORM_PROB_TOL} (largest per-case mean "
              f"{mean:.6g}); against the fp32 model max|p_on - p32| "
              f"{to32['on']:.6g}, max|p_off - p32| {to32['off']:.6g}; label "
              f"flips {flips}, {far} with |p - 0.5| >= tol; {on_s:.4f} s per "
              f"case with kernels, {off_s:.4f} s without (3 warm label-map "
              f"runs); launches per case {launches[label]}", flush=True)
        if not diff <= NORM_PROB_TOL or far:
            raise AssertionError(f"isensee {label}: kernels on against off "
                                 f"{diff}, {far} far flips")
        if not to32["on"] <= 2 * to32["off"]:
            raise AssertionError(f"isensee {label}: kernels {to32['on']} "
                                 f"from fp32, cuDNN {to32['off']}")
        del pred
    del models
    torch.cuda.empty_cache()

    # the entry points: predict (sliding window) and serve --once (direct,
    # device preprocessing) on the three cases
    t = time.perf_counter()
    n = counted("predict", forwards(4 * len(inputs)), lambda: entry.main(
        config, str(params), inputs, output_dir=str(work / "predicted"),
        device="cuda", verbose=False))
    predict_s = (time.perf_counter() - t) / len(inputs)
    t = time.perf_counter()
    served = counted("serve --once --direct", forwards(len(inputs)),
                     lambda: serve.main(
                         config, str(params), str(work / "cases"),
                         output=str(work / "served"), once=True, direct=True,
                         device_preprocess=True, device="cuda",
                         verbose=False))
    serve_s = (time.perf_counter() - t) / len(inputs)
    for out_dir in ("predicted", "served"):
        for path in inputs:
            label = load_nifti(str(work / out_dir / Path(path).name
                                   / "prediction.nii.gz")).get_fdata()
            if label.shape != tuple(config.image_shape) or not set(
                    np.unique(label)) <= {0.0, 1.0}:
                raise AssertionError(f"isensee {out_dir}: {label.shape}")
    print(f"isensee predict: {n} cases, {predict_s:.4f} s per case; serve "
          f"--once --direct --device-preprocess: {served} cases, "
          f"{serve_s:.4f} s per case (model builds included)", flush=True)
    if n != len(inputs) or served != len(inputs):
        raise AssertionError(f"isensee: predicted {n}, served {served}")

    # training: one step's gradients with the kernels on against off, from
    # the same weights, batch and dropout masks (the step's generator seeded
    # alike, no augmentation); cuDNN with PyTorch's default TF32, as in the
    # train phase
    torch.backends.cudnn.allow_tf32 = True
    weights = from_flax(init_flax_like(config, seed=0))

    def fresh(cfg):
        model = build_model(cfg, "cuda")
        model.load_state_dict(weights)
        return model, create_train_state(model, cfg)

    x_np, y_np = train_batch(config)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    grads, losses = {}, {}
    config_32 = dataclasses.replace(config_off, compute_dtype="float32")
    for name, cfg in (("on", config), ("off", config_off),
                      ("fp32", config_32)):
        cfg = dataclasses.replace(cfg, augment=False)
        model, state = fresh(cfg)
        step = make_train_step(
            model, cfg, generator=torch.Generator(device="cuda").manual_seed(0))
        want = (forwards(1, ISENSEE_PER_TRAIN) if name == "on"
                else dict.fromkeys(ISENSEE_PER_TRAIN, 0))
        # the fp32 reference in fp32 throughout (no TF32 in cuDNN)
        torch.backends.cudnn.allow_tf32 = name != "fp32"
        metrics = counted(f"train step {name}", want,
                          lambda: step(state, x, y))
        torch.backends.cudnn.allow_tf32 = True
        losses[name] = float(metrics["loss"])
        grads[name] = {n: p.grad.float().clone()
                       for n, p in model.named_parameters()}
        # a conv bias before a norm: the norm takes away any per-channel
        # constant, so its gradient is 0 up to rounding
        before_norm = {f"{n}.conv.bias" for n, m in model.named_modules()
                       if isinstance(m, ConvBlock) and m.norm_key}
        del model, state, step

    def rel(a, b, scale=None):
        return ((a - b).norm() / (b if scale is None else scale).norm()
                ).item()

    # each gradient of the kernel route is held to the fp32 model's: within
    # GRAD_REL_TOL of it, or no further from it than twice the cuDNN bf16
    # path is (InstanceNorm over the 64 voxels of a 4^3 sample amplifies
    # the bf16 forward's rounding in the deepest level's gradients)
    worst, worst_bias, on_off, zero = (None, 0.0), (None, 0.0), (None, 0.0), []
    for n, g32 in grads["fp32"].items():
        g_on, g_off = grads["on"][n], grads["off"][n]
        if n in before_norm:
            # held to the scale of its block's weight gradient
            scale = grads["fp32"][n[:-len("bias")] + "weight"]
            r = max(rel(g_on, g32, scale), rel(g_off, g32, scale))
            if not r <= worst_bias[1]:
                worst_bias = (n, r)
            continue
        if not bool((g_on != 0).any()):
            zero.append(n)
        r_on, r_off = rel(g_on, g32), rel(g_off, g32)
        margin = r_on / max(2 * r_off, GRAD_REL_TOL)
        if worst[0] is None or not margin <= worst[1][0]:
            worst = (n, (margin, r_on, r_off))
        if not rel(g_on, g_off) <= on_off[1]:
            on_off = (n, rel(g_on, g_off))
    n, (margin, r_on, r_off) = worst
    print(f"isensee train grad check: {len(grads['on'])} parameter tensors "
          f"against the fp32 model's; worst {n}: relative L2 {r_on:.6g} "
          f"with kernels, {r_off:.6g} without (bound max(2 x {r_off:.6g}, "
          f"{GRAD_REL_TOL})); kernels on against off at most "
          f"{on_off[1]:.6g} ({on_off[0]}); the {len(before_norm)} conv "
          f"biases before a norm within {worst_bias[1]:.6g} "
          f"({worst_bias[0]}) of their weight gradient's norm <= tol "
          f"{GRAD_REL_TOL}; loss {losses['on']:.6g} with kernels, "
          f"{losses['off']:.6g} without, {losses['fp32']:.6g} in fp32 (|on - "
          f"off| {abs(losses['on'] - losses['off']):.6g} <= tol {LOSS_TOL});"
          f" launches {launches['train step on']}", flush=True)
    if zero:
        raise AssertionError(f"zero gradient with the kernels on: {zero}")
    if not (margin <= 1 and worst_bias[1] <= GRAD_REL_TOL):
        raise AssertionError(f"isensee gradients: {worst}, {worst_bias}")
    if not abs(losses["on"] - losses["off"]) <= LOSS_TOL:
        raise AssertionError(f"loss {losses['on']} against {losses['off']}")
    del grads

    # time and memory of the full step (augmentation and dropout on), and
    # its parts (forward + loss with the step's dropout masks)
    step_ms = {}
    for label, cfg in (("on", config), ("off", config_off)):
        model, state = fresh(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = make_train_step(model, cfg, generator=gen)
        loss_fn = get_loss_fn(cfg)
        step(state, x, y)  # makes the gradients and Adam's moments
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step_ms[label] = time_ms(torch, lambda: step(state, x, y))
        peak = torch.cuda.max_memory_allocated()
        masks = model.dropout_masks(x.shape[0], gen)

        def forward():
            return loss_fn(y, _forward(model, x, masks))

        fwd_ms = time_ms(torch, forward)
        fwd_bwd_ms = time_ms(torch, lambda: forward().backward())
        print(f"isensee train step kernels {label}: {step_ms[label]:.6g} ms "
              f"per step of {cfg.batch_size}x{tuple(cfg.patch_shape)} "
              f"(augmentation, dropout, forward, loss, backward, Adam); "
              f"forward + loss {fwd_ms:.6g} ms, + backward {fwd_bwd_ms:.6g} "
              f"ms (backward {(fwd_bwd_ms - fwd_ms) / step_ms[label]:.4f} "
              f"of the step); peak memory {peak / 2**30:.6g} GiB "
              f"({(peak - base) / 2**30:.6g} GiB above the "
              f"{base / 2**30:.6g} GiB of weights, gradients and optimizer "
              f"state)", flush=True)
        del model, state, step
        torch.cuda.empty_cache()

    # the loop: two epochs on the synthetic cases, with augmentation and
    # dropout; one training forward per train step, one serving forward
    # per validation step
    loop_cfg = dataclasses.replace(
        config, n_epochs=2, overwrite=False,
        model_file=str(work / "model.pt"),
        training_file=str(work / "training_ids.pkl"),
        validation_file=str(work / "validation_ids.pkl"),
        training_log=str(work / "training.log"))
    data_file = InMemoryDataFile.from_cases(inputs, loop_cfg)
    tg, n_t, vg, n_v = get_training_and_validation_generators(
        data_file, batch_size=loop_cfg.batch_size, n_labels=1,
        training_keys_file=loop_cfg.training_file,
        validation_keys_file=loop_cfg.validation_file,
        data_split=loop_cfg.validation_split, overwrite=True,
        labels=loop_cfg.labels, patch_shape=loop_cfg.patch_shape,
        validation_batch_size=loop_cfg.validation_batch_size,
        validation_patch_overlap=loop_cfg.validation_patch_overlap,
        training_patch_start_offset=loop_cfg.training_patch_start_offset,
        skip_blank=loop_cfg.skip_blank, seed=0)
    model, state = fresh(loop_cfg)
    want = {k: loop_cfg.n_epochs * (n_t * ISENSEE_PER_TRAIN[k]
                                    + n_v * ISENSEE_PER_FORWARD[k])
            for k in ISENSEE_PER_TRAIN}
    t = time.perf_counter()
    state = counted("train_model", want, lambda: train_model(
        model, state, loop_cfg, tg, vg, n_t, n_v, seed=0, verbose=False))
    loop_s = time.perf_counter() - t
    with open(loop_cfg.training_log) as f:
        rows = list(csv.DictReader(f))
    print("isensee train loop: " + "; ".join(
        f"epoch {r['epoch']} loss {float(r['loss']):.6g} val_loss "
        f"{float(r['val_loss']):.6g} dice {float(r['dice_coefficient']):.6g}"
        f" {float(r['patches_per_sec']):.6g} patches/s" for r in rows)
        + f"; {n_t} + {n_v} steps per epoch, {loop_s:.4f} s for both "
        f"epochs; launches {launches['train_model']}", flush=True)
    if [r["epoch"] for r in rows] != ["0", "1"]:
        raise AssertionError(f"isensee log epochs {[r['epoch'] for r in rows]}")
    if not float(rows[1]["loss"]) < float(rows[0]["loss"]):
        raise AssertionError("isensee: the training loss did not fall")
    final = CheckpointIO(str(work / "final.pt"))
    final.save(state, epoch=2, best_val=float(rows[-1]["val_loss"]))
    reloaded, reloaded_state = fresh(loop_cfg)
    final.restore(reloaded_state)
    for (n, a), b in zip(model.state_dict().items(),
                         reloaded.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"isensee: reloaded {n} differs")
    print("isensee train checkpoint: the final state reloaded into a fresh "
          "model bit for bit", flush=True)
    del model, state, reloaded, reloaded_state
    torch.cuda.empty_cache()

    # the U-Net with InstanceNorm: one batch-8 forward, where every kernel
    # (the fused decoder too) runs with activation "none" before the norm
    unet = Config.load(str(ROOT / "configs" / "fetal_unet.json"))
    unet = dataclasses.replace(unet, instance_normalization=True,
                               use_pallas_conv=True, use_pallas_dec0=True,
                               batch_size=B)
    unet_off = dataclasses.replace(unet, use_pallas_conv=False,
                                   use_pallas_dec0=False)
    unet_weights = from_flax(init_flax_like(unet, seed=0))
    xu = torch.from_numpy(train_batch(unet)[0]).cuda().permute(
        0, 2, 3, 4, 1).contiguous()
    probs, fwd_ms = {}, {}
    for name, cfg in (("on", unet), ("off", unet_off)):
        model = build_model(cfg, "cuda")
        model.load_state_dict(unet_weights)
        with torch.inference_mode():
            if name == "on":
                probs[name] = counted("unet instance-norm forward",
                                      PER_FORWARD, lambda: model(xu))
            else:
                probs[name] = model(xu)
            fwd_ms[name] = time_ms(torch, lambda: model(xu))
        del model
    diff = (probs["on"] - probs["off"]).abs().max().item()
    flip = (probs["on"] > 0.5) != (probs["off"] > 0.5)
    far = int((flip & ((probs["off"] - 0.5).abs() >= NORM_PROB_TOL)).sum(
        ).item())
    print(f"isensee unet instance-norm forward {tuple(xu.shape)}: "
          f"max|p_on - p_off| {diff:.6g} <= tol {NORM_PROB_TOL}; label flips "
          f"{int(flip.sum().item())}, {far} with |p - 0.5| >= tol; "
          f"{fwd_ms['on']:.6g} ms with kernels, {fwd_ms['off']:.6g} ms "
          f"without; launches {launches['unet instance-norm forward']}",
          flush=True)
    if not bool(torch.isfinite(probs["on"]).all()) or not diff <= \
            NORM_PROB_TOL or far:
        raise AssertionError(f"unet instance-norm: {diff}, {far} far flips")
    return {"launches": launches, "kernels": kernel_stats}


# The resampling augmentations on the card against the same functions on the
# CPU, from the same factors and angles. The source coordinates are made of
# one fp32 rounding per operation on both (no fused multiply-add; the
# rotation matrix in float64, rounded once), and the trilinear sum adds its
# eight terms in one order, so the two agree to the last bits; 1e-5 on
# O(1) intensities leaves room for a device exp/sin that differs in its last
# ulp. The truth (nearest voxel) must be equal voxel for voxel.
RESAMPLE_TOL = 1e-5
# The experiment phase trains at 1e-4, not the config's 5e-4: from random
# weights on six cases, with scale and rotation on top of flip / permute /
# contrast, the config's rate falls into soft Dice's "predict nothing" basin
# in the second epoch (training dice 0.10 -> 0.03 -> 0.0001, with the kernels
# and without; NVIDIA H100 80GB HBM3, 700 W), where 2e-4 and below train
# steadily in every seed tried (tools/probe_torch_train_stability.py).
EXPERIMENT_LR = 1e-4


def experiment_phase(torch, work: Path) -> dict:
    """The experiment path at full width (``configs/fetal_unet.json``, both
    kernel switches on, ``distort`` 0.25 and ``rotate`` 15) through its
    entry points: ``train.main`` on six NIfTI cases (the native dataset is
    built, the split written, two epochs trained, the checkpoint written),
    the resampling augmentations on the card against the CPU and a train
    step's time with and without them, ``predict.main`` over the validation
    split from the checkpoint and the dataset (sliding window, then
    ``--direct``; the switches-off path and an fp32 model as the
    references), ``evaluate.main`` on
    that tree and ``ensemble.main`` over two probability trees. Launches
    are zeroed before and read after each counted run and must be its
    forwards' worth exactly."""
    import csv
    import dataclasses
    import importlib.util

    import numpy as np

    from fetal_mri_segmentation_tpu_torch import (
        ensemble, evaluate, predict as entry, train)
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.data.build import (
        dataset_bytes, open_data_file)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops import augment
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        get_number_of_patches, get_number_of_steps)
    from fetal_mri_segmentation_tpu_torch.training.checkpoint import (
        CheckpointIO)
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    torch.backends.cudnn.allow_tf32 = True  # as the train phase
    torch.backends.cuda.matmul.allow_tf32 = False
    config = Config.load(str(ROOT / "configs" / "fetal_unet.json"))
    config = dataclasses.replace(
        config, use_pallas_conv=True, use_pallas_dec0=True, distort=0.25,
        rotate=15.0, n_epochs=2, initial_learning_rate=EXPERIMENT_LR,
        data_file=str(work / "fetal_data"),
        model_file=str(work / "fetal_unet.ckpt"),
        training_file=str(work / "training_ids.pkl"),
        validation_file=str(work / "validation_ids.pkl"),
        training_log=str(work / "training.log"))
    config_off = dataclasses.replace(config, use_pallas_conv=False,
                                     use_pallas_dec0=False)
    config_fp32 = dataclasses.replace(config_off, compute_dtype="float32")
    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)
    launches = {}

    def counted(name, forwards, run):
        """Zero the counts, run, read them: exactly ``forwards`` forwards'
        worth of launches."""
        for fn in counters:
            fn.launches = 0
        t = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches[name] = {fn.__name__: fn.launches for fn in counters}
        want = {k: n * forwards for k, n in PER_FORWARD.items()}
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]}, not "
                                 f"{want} ({forwards} forwards)")
        return result, seconds

    # 1. train.main: dataset, split, two epochs, checkpoint
    n_cases = 6
    write_cases(work / "cases", n=n_cases)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    state = train.main(config, str(work / "cases"), seed=0, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches["train.main"] = {fn.__name__: fn.launches for fn in counters}
    with open_data_file(config.data_file) as data_file:
        shape = tuple(data_file.root.data.shape)
        ids = data_file.subject_ids
        validation = pickle_load(config.validation_file)
        training = pickle_load(config.training_file)
        n_v = get_number_of_steps(get_number_of_patches(
            data_file, validation, config.patch_shape,
            patch_overlap=config.validation_patch_overlap,
            skip_blank=config.skip_blank), config.validation_batch_size)
    n_t = state.step // config.n_epochs
    if shape != (n_cases, 1) + tuple(config.image_shape) or ids != [
            f"case_{i}" for i in range(n_cases)]:
        raise AssertionError(f"dataset {shape}, ids {ids}")
    if (len(training), len(validation)) != (4, 2) or set(training) & set(
            validation):
        raise AssertionError(f"split {training} / {validation}")
    want = {k: n * config.n_epochs * (n_t + n_v)
            for k, n in PER_FORWARD.items()}
    with open(config.training_log) as f:
        rows = list(csv.DictReader(f))
    print(f"experiment train.main: dataset {shape} float32 in the native "
          f"layout, {dataset_bytes(config.data_file)} bytes; split "
          f"{len(training)} + {len(validation)} cases; {n_t} + {n_v} steps "
          f"per epoch; " + "; ".join(
              f"epoch {r['epoch']} loss {float(r['loss']):.6g} val_loss "
              f"{float(r['val_loss']):.6g} {float(r['patches_per_sec']):.6g}"
              f" patches/s" for r in rows)
          + f"; {train_s:.4f} s in all; launches {launches['train.main']}",
          flush=True)
    if launches["train.main"] != want or state.step != 2 * n_t or n_t <= 0:
        raise AssertionError(f"train.main launched {launches['train.main']}"
                             f", not {want}")
    if [r["epoch"] for r in rows] != ["0", "1"] or not float(
            rows[1]["loss"]) < float(rows[0]["loss"]):
        raise AssertionError(f"training log {rows}")
    if CheckpointIO(config.model_file).peek_epoch() not in (1, 2):
        raise AssertionError("no checkpoint with its epoch sidecar")
    del state
    torch.cuda.empty_cache()

    # 2. the resampling augmentations: the card against the CPU on one
    # batch, then a train step's time with and without them
    x_np, y_np = train_batch(config)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    factors = augment.draw_scale_factors(gen, x.shape[0], config.distort)
    angles = augment.draw_rotation_angles(gen, x.shape[0], config.rotate)
    worst = 0.0
    for name, fn, p in (("apply_scale", augment.apply_scale, factors),
                        ("apply_rotation", augment.apply_rotation, angles)):
        gx, gy = fn(x, y, p)
        cx, cy = fn(x.cpu(), y.cpu(), p.cpu())
        err = (gx.cpu() - cx).abs().max().item()
        differ = int((gy.cpu() != cy).sum().item())
        moved = int((gy != y).sum().item())
        ms = time_ms(torch, lambda: fn(x, y, p))
        print(f"experiment {name}: card against CPU on "
              f"{tuple(x.shape)}: max|x diff| {err:.6g} <= tol "
              f"{RESAMPLE_TOL}, {differ} truth voxels differ ({moved} moved "
              f"by the transform); {ms:.6g} ms on the card", flush=True)
        if not err <= RESAMPLE_TOL or differ or not moved:
            raise AssertionError(f"{name}: x {err}, truth {differ}")
        if gx.dtype != torch.float32 or gx.shape != x.shape:
            raise AssertionError(f"{name}: {gx.dtype} {tuple(gx.shape)}")
        worst = max(worst, err)
    weights = from_flax(init_flax_like(config, seed=0))
    step_ms = {}
    for name, cfg in (
            ("all augmentations", config),
            ("no scale or rotation",
             dataclasses.replace(config, distort=None, rotate=None)),
            ("all augmentations, kernels off", config_off)):
        model = build_model(cfg, "cuda")
        model.load_state_dict(weights)
        step_state = create_train_state(model, cfg)
        step = make_train_step(
            model, cfg, generator=torch.Generator(device="cuda").manual_seed(0))
        step_ms[name] = time_ms(torch, lambda: step(step_state, x, y))
        del model, step_state, step
        torch.cuda.empty_cache()
    print("experiment train step of "
          f"{config.batch_size}x{tuple(config.patch_shape)}: "
          + ", ".join(f"{v:.6g} ms with {k}" for k, v in step_ms.items()),
          flush=True)

    # 3. predict.main over the validation split, from the checkpoint and
    # the dataset: no --input, no --params. 27 patches of 64^3 per case in
    # batches of 8 are 4 forwards; --direct is 1.
    cases = [ids[i] for i in validation]
    per_case = {}
    for mode, forwards in (("sliding", 4), ("direct", 1)):
        direct = mode == "direct"
        out = work / f"prediction_{mode}"
        n, seconds = counted(
            f"predict {mode}", forwards * len(cases),
            lambda: entry.main(config, output_dir=str(out), direct=direct,
                               device="cuda", verbose=False))
        per_case[mode] = seconds / n
        if n != len(cases) or sorted(os.listdir(out)) != sorted(cases):
            raise AssertionError(f"{out}: {n} cases, {os.listdir(out)}")
        for case in cases:
            files = sorted(os.listdir(out / case))
            label = load_nifti(str(out / case / "prediction.nii.gz"))
            if files != ["data_volume.nii.gz", "prediction.nii.gz",
                         "truth.nii.gz"] or tuple(label.shape) != tuple(
                    config.image_shape) or not set(np.unique(
                        label.get_fdata())) <= {0.0, 1.0}:
                raise AssertionError(f"{out / case}: {files}")
        # probabilities with the kernels, with the switches off and from an
        # fp32 model, all from the checkpoint. Trained weights spread the
        # logits, so the two bf16 paths sit further apart than PROB_TOL
        # allows for random weights (0.0234 through the sliding window, of
        # which cuDNN's bf16 path is 0.0202 from fp32 and the kernel route
        # 0.0105; NVIDIA H100 80GB HBM3, 700 W): each is held to the fp32
        # model, the kernel route no further from it than twice the other.
        counted(f"predict {mode} --prob-map", forwards * len(cases),
                lambda: entry.main(config, output_dir=str(
                    work / f"prob_{mode}_on"), direct=direct, prob_map=True,
                    device="cuda", verbose=False))
        for fn in counters:
            fn.launches = 0
        for name, cfg in (("off", config_off), ("fp32", config_fp32)):
            entry.main(cfg, output_dir=str(work / f"prob_{mode}_{name}"),
                       direct=direct, prob_map=True, device="cuda",
                       verbose=False)
        if any(fn.launches for fn in counters):
            raise AssertionError("the switches are off and a kernel ran")
        diff = err_on = err_off = 0.0
        far = 0
        for case in cases:
            p_on, p_off, p_32 = (load_nifti(str(
                work / f"prob_{mode}_{k}" / case / "prediction.nii.gz")
                ).get_fdata() for k in ("on", "off", "fp32"))
            if not np.isfinite(p_on).all():
                raise AssertionError(f"{case}: non-finite probabilities")
            diff = max(diff, float(np.abs(p_on - p_off).max()))
            err_on = max(err_on, float(np.abs(p_on - p_32).max()))
            err_off = max(err_off, float(np.abs(p_off - p_32).max()))
            far += int(((p_on > 0.5) != (p_32 > 0.5))[
                np.abs(p_32 - 0.5) >= PROB_TOL].sum())
        print(f"experiment predict.main {mode} over the validation split "
              f"({len(cases)} cases, checkpoint and dataset): "
              f"{per_case[mode]:.4f} s per case, model load included; "
              f"against the fp32 model max|p_on - p32| {err_on:.6g}, "
              f"max|p_off - p32| {err_off:.6g} (bound max(2 x {err_off:.6g}"
              f", {PROB_TOL})), max|p_on - p_off| {diff:.6g}; {far} "
              f"label flips against fp32 with |p - 0.5| >= "
              f"{PROB_TOL}; launches {launches[f'predict {mode}']}",
              flush=True)
        if not err_on <= max(2 * err_off, PROB_TOL) or far:
            raise AssertionError(f"predict {mode} against the fp32 model: "
                                 f"{err_on} with the kernels, {err_off} "
                                 f"without, {far} far flips")

    # 4. evaluate on the sliding-window tree, ensemble over the two
    # probability trees
    scores = evaluate.main(str(work / "prediction_sliding"), [1],
                           str(work / "scores.csv"), plot=False,
                           surface_metrics=True)
    with open(work / "scores.csv") as f:
        table = list(csv.reader(f))
    dice = {case: row["label_1_dice"] for case, row in scores.items()}
    optional = {m: importlib.util.find_spec(m) is not None
                for m in ("matplotlib", "pandas", "h5py")}
    print(f"experiment evaluate.main: scores.csv with {len(table) - 1} rows, "
          f"columns {table[0][1:]}; hard Dice {dice}; installed here: "
          f"{optional}", flush=True)
    if sorted(scores) != sorted(cases) or len(table) != len(cases) + 1 or \
            not all(np.isfinite(v) for v in dice.values()):
        raise AssertionError(f"scores {scores}")
    n = ensemble.main([str(work / "prob_sliding_on"),
                       str(work / "prob_direct_on")],
                      str(work / "ensemble"), labels=[1], save_prob=True)
    merged = load_nifti(str(work / "ensemble" / cases[0]
                            / "prediction.nii.gz")).get_fdata()
    if n != len(cases) or not set(np.unique(merged)) <= {0.0, 1.0} or \
            merged.shape != tuple(config.image_shape):
        raise AssertionError(f"ensemble: {n} cases, {np.unique(merged)}")
    print(f"experiment ensemble.main: {n} cases from the sliding-window and "
          f"direct probability trees, {int(merged.sum())} foreground voxels "
          f"in {cases[0]}", flush=True)
    return launches


def main() -> None:
    start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from fetal_mri_segmentation_tpu_torch.ops import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    torch.backends.cudnn.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    ptxas = [line.strip() for line in
             lib_path.with_suffix(".log").read_text().splitlines()
             if any(k in line for k in ("entry function", "registers",
                                        "spill", "warning"))]
    print(f"build: {time.perf_counter() - t0:.4f} s -> {lib_path.name}; "
          f"ptxas: {' | '.join(ptxas)}",
          flush=True)
    print(f"build: HGMMA instructions per kernel: {wgmma_check(lib_path)}",
          flush=True)

    stats = {}
    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    kernel_phase(torch, stats)
    seconds["kernels"] = time.perf_counter() - t0
    results = {}
    for name, phase in (("slice", slice_phase), ("train", train_phase),
                        ("serve", serve_phase), ("isensee", isensee_phase),
                        ("experiment", experiment_phase)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            results[name] = phase(torch, Path(work))
        seconds[name] = time.perf_counter() - t0
    (launches, train_launches, serve_launches, isensee,
     experiment) = results.values()
    print("phase seconds: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in seconds.items())
          + f"; {time.perf_counter() - start:.4f} since the script started",
          flush=True)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "train_launches": train_launches[name],
                "serve_launches": {path: counts[name] for path, counts
                                   in serve_launches.items()},
                "isensee_launches": {path: counts[name] for path, counts
                                     in isensee["launches"].items()},
                "isensee_forward": isensee["kernels"].get(name),
                "experiment_launches": {path: counts[name] for path, counts
                                        in experiment.items()},
                **stats[name]}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
