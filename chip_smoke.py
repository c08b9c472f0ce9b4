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
   kernels' launch counts over that run: one forward's worth per step.

Then one JSON line describing the kernels, and the last line
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero; without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
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
# the slice's blocks use relu; the extra shapes cover the other activations
ACTIVATION = {"non-cubic": "none", "ragged": "leaky_relu",
              "ragged-K": "leaky_relu", "ragged-N": "none"}
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


def check(label, out, ref, stats, entry, is_slice, ms, plain_ms, prep_ms,
          flop):
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = REL_TOL * scale + ABS_TOL
    print(f"kernel {entry} {label}: max|diff| {err:.6g} <= tol {tol:.6g} "
          f"(max|ref| {scale:.6g}); ms {ms:.6g} plain_ms {plain_ms:.6g} "
          f"prep_ms {prep_ms:.6g}; {flop / ms / 1e9:.6g} TFLOP/s",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{entry} {label}: max|diff| {err} > {tol}")
    s = stats.setdefault(entry, {"max_abs_err": 0.0, "ms": 0.0,
                                 "plain_ms": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if is_slice:
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s.setdefault("prep", 0.0)
        s["prep"] += prep_ms


def kernel_phase(torch, stats) -> None:
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops

    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, std=1.0):
        x = torch.randn(*shape, device="cuda", generator=gen) * std
        return x.to(torch.bfloat16)

    for entry, layer, b, d, h, w, ci, co in CONV_SHAPES:
        x = normal(b, d, h, w, ci)
        wt = normal(3, 3, 3, ci, co, std=(27 * ci) ** -0.5)
        bias = torch.randn(co, device="cuda", generator=gen) * 0.1
        op = getattr(conv_ops, entry)
        act = (ACTIVATION.get(layer, "relu"), 0.3)
        out = op(x, wt, bias, *act)
        torch.cuda.synchronize()
        ref = conv_ops.conv3x3_reference(x.float(), wt.float(), bias, *act)
        # the K-major weight is made at the first call and kept with wt
        ms = time_ms(torch, lambda: op(x, wt, bias, *act))
        plain_ms = time_ms(torch, lambda: conv_ops.conv3x3_reference(
            x, wt, bias, *act))
        prep_ms = time_ms(torch, lambda: wt.permute(4, 0, 1, 2, 3).contiguous())
        check(f"{layer} {(b, d, h, w)} {ci}->{co} {act[0]}", out, ref, stats,
              entry, layer[:3] in SLICE_LAYERS, ms, plain_ms, prep_ms,
              2 * b * d * h * w * 27 * ci * co)
        del x, wt, out, ref

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
        # the pre-summed K-major weights are made at the first call, kept
        # with k
        ms = time_ms(torch, lambda: dec_ops.up_concat_conv3x3_kernel(
            xd, skip, k, bias, *act))
        plain_ms = time_ms(torch, lambda: dec_ops.up_concat_conv3x3_reference(
            xd, skip, k, bias, *act))
        prep_ms = time_ms(torch, lambda: dec_ops.kernel_weights(k, cu))
        check(f"{layer} {(b, d, h, w)} {cu}+{cs}->{co} {act[0]}", out, ref,
              stats, entry, layer[:3] in SLICE_LAYERS, ms, plain_ms, prep_ms,
              2 * b * 8 * d * h * w * (8 * cu + 27 * cs) * co)
        del xd, skip, k, out, ref
    for entry, s in stats.items():
        print(f"slice sum {entry}: kernel {s['ms']:.6g} ms (+ one-off weight "
              f"preparation {s.pop('prep', 0.0):.6g} ms) against plain "
              f"{s['plain_ms']:.6g} ms", flush=True)


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


def main() -> None:
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
    kernel_phase(torch, stats)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        launches = slice_phase(torch, Path(work))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        train_launches = train_phase(torch, Path(work))

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "train_launches": train_launches[name], **stats[name]}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
