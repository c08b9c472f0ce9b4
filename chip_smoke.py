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
6. parity: the port's bf16 training where the JAX package holds its own.
   The max-pool tie gradients (unfolded, folds (2, 2, 2) and (1, 2, 2);
   fp32 and bf16) on the card equal the CPU's bit for bit on the recipe's
   level-0 pool input with planted ties (the CPU tests hold those to
   JAX's); then ``PARITY_STEPS`` bf16 steps of the multi-class recipe's
   model (depth 3, 8 filters, batch 3 of 40^3) with the kernels on and
   off, each step's loss within ``PARITY_LOSS_RTOL`` of the card's fp32
   step's from the same seeded weights and batches, launches exactly
   ``QUALITY_PER_FORWARD`` per step with the kernels;
7. serve: the same config and weights through the serving surface. The
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
8. isensee: ``configs/fetal_isensee.json`` (Isensee2017, depth 5, 16 base
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
9. experiment: ``configs/fetal_unet.json`` at full width with ``distort``
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
   / 3 per forward of each counted run;
10. scale: the same config on six cases, training at scale. ``train.main``
   for two epochs with ``device_case_cache`` "on" against "off" from the
   same seed and weights (per-epoch loss and dice within
   ``SCALE_METRIC_TOL``, beside the spread of two host-staged runs), every
   batch of an epoch gathered on the card against the same batch staged
   from the host (x and y bit for bit); the cache's build seconds and
   bytes, the bytes a step sends to the card in each mode, the gather's
   milliseconds, patches/s of an epoch cached against host-staged and the
   step's peak memory with the cache resident; a partial cache (the
   epoch's multiset of patches against the host pipeline's, a run
   interrupted after one epoch and resumed against an uninterrupted one);
   then data-parallel training: one rank that joins an NCCL group through
   ``initialize_distributed``, and two ranks started as processes (sharing
   the card over gloo where there is one card, over NCCL on a card each
   where there are more), each holding ``make_dp_train_step`` on a global
   batch of 6 to the single-device step (loss, dice, every parameter's
   change, BatchNorm's buffers), and ``train.main`` with ``num_devices=2``
   and the cache on for two epochs. Launches exactly 6 / 4 / 3 per forward
   of every counted run, the ranks' own included. A rank's non-zero exit
   or its time limit fails the script;
11. spatial: multi-device inference and depth-axis spatial sharding on
   the same config. One-device references (the direct predictor and the
   sliding window on three 128^3 cases, the peak memory of a whole-volume
   forward and of a train step); ``halo_exchange`` and ``all_gather_cat``
   on CUDA tensors in an NCCL group of one rank; then two ranks (sharing
   the card over gloo, or on a card each over NCCL): the spatial predictor
   on a 1 x 2 mesh and the patch-grid sharded predictor on the data mesh
   against the one-device predictors (``PROB_TOL``, no label flip away
   from 0.5), the spatial predictor of ``configs/fetal_isensee.json``
   against its direct predictor (``NORM_PROB_TOL``: InstanceNorm's moments
   summed over the ranks, the stride-2 halo, 6 / 8 / 0 launches per
   forward) and the same with level 0 folded as ``SPATIAL_FOLD`` against
   the folded model's direct predictor (the one-row folded halo, the
   stride-2 entry's zero row, the folded InstanceNorm's moments summed over
   the ranks; 6 / 5 / 0 launches per forward), the 1 x 2 GSPMD train step against the single-device step
   (as the scale phase's), each rank's peak memory, and as a launcher
   starts them ``train.main`` with ``spatial_devices=2`` for two epochs
   and ``predict.main`` with ``spatial_devices=2`` and ``num_devices=2``
   over the validation split (probabilities against one device's); the
   spatial predictor on a (120, 128, 128) volume, whose 60-row slabs go
   odd at level 2 and are gathered whole there, against the direct
   predictor; then four ranks: the 2 x 2 hybrid step. Launches exactly 6 /
   4 / 3 per forward on every rank of every counted run;
12. interop: both configs at full width through the Keras mapping
   (``keras_export`` into a stand-in with Keras's ``layers`` /
   ``get_weights`` / ``set_weights`` surface, ``keras_import`` back: state
   dicts equal bit for bit; the imported U-Net serves the three cases with
   the kernels, labels equal the original's), then the portable program:
   ``export_predictor`` with ``["cuda"]`` (the kernels as custom ops in the
   graph) and the default platforms, sliding window and direct, Isensee2017
   with ``["cuda"]``, and ``predict.main`` with ``export_path``, every
   artifact loaded in a fresh process on the card that imports no model
   module: the ``["cuda"]`` programs against the live kernels-on predictors
   (``PROB_TOL`` / ``NORM_PROB_TOL``, no flip away from 0.5), the portable
   ones against the switches off, launches exactly the live path's per
   forward (none for a portable program), seconds per case and to load;
   and the host time of one launch through the public wrapper, the custom
   op alone and the ctypes launch alone;
13. fold: space-to-depth folding of the full-resolution level at full
   width, kernel switches on, bf16, weights from seed 0. The U-Net with
   each of ``FOLD_SETTINGS`` against the same weights unfolded, through
   the direct predictor and the sliding window on the three cases
   (probabilities within ``REL_TOL`` / ``ABS_TOL`` of their scale, the
   label agreement, no flip away from 0.5, launches exactly
   ``FOLD_PER_FORWARD`` per forward: the folded level-0 convs are stock
   convs), each forward's milliseconds beside the unfolded one's (switches
   on and off); the fused decoder's input-dilated form under
   ``decoder_form_override("dilated")`` against the parity form, switches
   off, both timed; Isensee2017 folded (1, 1, 2) dense against unfolded (a
   forward within ``NORM_PROB_TOL``, one train step's gradients each held
   to an fp32 model's); the U-Net's train step folded against unfolded
   (gradients within ``GRAD_REL_TOL``, both timed); ``train.main`` for one
   epoch with the fold, ``predict.main --direct`` from its checkpoint, and
   ``predict --export`` of the fold config, whose loaded program must be
   the unfolded program;
14. native: the host library (``utils/native.py``) must build from the
   port's ``native/fastloader.cpp`` and load; each entry point against
   numpy on a 160 x 160 x 110 case, with host microseconds; host-staged
   ``train_model`` patches/s with the library and with
   ``FETAL_TPU_NO_NATIVE=1``;
15. quality: the recipe of ``tools/torch_parity_dice.py`` (the root
   ``parity_dice.py``'s: a depth-3, 8-filter U-Net on twelve whole 32^3
   synthetic volumes, batch 3, lr 5e-4) at its full 30 epochs, bf16 with
   both kernel switches on, through ``train.main``, ``predict.main`` and
   ``evaluate.main``: the loss falls, no dice-collapse warning, the best
   checkpoint restores and the final state reloads bit for bit, the
   served model is the checkpoint's, a {0, 1} label map per validation
   case, ``scores.csv`` with its columns, the held-out mean hard Dice at
   least ``QUALITY_DICE_FLOOR``; then ``QUALITY_MC_EPOCHS`` epochs of
   ``tools/torch_multiclass_quality.py``'s recipe on ``QUALITY_MC_CASES``
   cases (the per-label dice columns in the log, the weighted-dice loss
   falls, label maps in {0, 1, 2, 4}). Launches exactly
   ``QUALITY_PER_FORWARD`` per train or validation step and per predicted
   batch. The full recipes are records the tools keep, not gates here;
16. bench: ``python -m fetal_mri_segmentation_tpu_torch.bench --quick`` as
   a subprocess with ``--kernels off`` and then ``on``: exit code 0, one
   JSON line with the root ``bench.py``'s quick names and
   ``detail.kernels``, a positive ``value``, ``detail.device`` the
   ``nvidia-smi`` line of the card, and the composite's launches exactly 0
   off and ``BENCH_LAUNCHES`` on.

The kernel phase also checks every kernel layer of the direct 128^3
forward at batch 1 and at the TTA chunks of 2 and 8, and the spatial
phase's halo'd slabs (a rank's 64 + 2 rows of the 128^3 volume, and of
the train step's 64^3 patches at batches 6 and 3; Isensee2017's on the
volume; the reshard case's slabs and whole levels), and prints each
shape's
bound (the larger of its operations over the bf16 peak and its bytes over
the HBM rate) and the time of one cuDNN convolution on the same inputs
(``library_ms``).

The norm phase, after the kernel phase, holds the fused InstanceNorm +
activation (``ops/instance_norm.py``, two launches a call) to its plain
twin at every norm shape of Isensee2017's serving forward (``NORM_SHAPES``:
levels 0-4 at the batch of 8 and the last batch of 3, level 0 folded (1,
1, 2)) and at the U-Net's InstanceNorm blocks of 32 and 64 channels, each
(sample, channel) with its own offset, spread and ramp, every element
within ``NORM_REL_TOL`` of its value plus ``NORM_ABS_TOL``, two launches a
call; prints each shape's ms against the old composite's
(``InstanceNorm._composite``) and its bound (6 bytes an element over the
HBM rate); the host microseconds of one norm call, fused and composite;
and one batch-8 forward of ``configs/fetal_isensee.json`` with the fused
norms against the composite (probabilities within ``NORM_PROB_TOL``, 54
launches), both timed, each held to an fp32 model on the composite (the
fused no further from it than twice the composite, or ``PROB_TOL``). The
same phase holds the kernel to its twin at Swin UNETR's settings (eps
1e-5, LeakyReLU 0.01, no affine) at every norm shape of its serving
forward (``SWIN_NORM_SHAPES``, activations "leaky_relu" and "none"), and
at MedNeXt's (eps 1e-5, affine, activation "none") at every norm shape of
the mednext preset's train step (``MEDNEXT_NORM_SHAPES``: batch 2, 128^3 x
32 down to 8^3 x 512, and the up blocks' odd extents 127^3 x 64 to 15^3 x
512). The norm training phase runs the fused norm's autograd Function
(two forward launches, three backward, two without affine) at every norm
shape of Isensee2017's train step, of Swin UNETR's at its batch of 4
without affine and of MedNeXt's (``NORM_TRAIN_SHAPES``), and sums each
step's 27 and 62 norms: dx, dscale and dbias against autograd
through the fp32 composite within ``NORM_GRAD_REL_TOL`` /
``NORM_GRAD_ABS_TOL`` and ``NORM_PARAM_TOL``, the launches counted, and the
CUDA-event ms of forward plus backward against the bf16 composite's and
the bound (each input read once, each output written once: 10 bytes an
element in bf16; the two-pass algorithm's traffic, 16, beside it); the
isensee phase's train step counts ``NORM_TRAIN_LAUNCHES`` with its fp32
reference on the composite. The swin phase after it runs one batch-4
96^3 forward of the swin_unetr preset, fused norms against the composite
in the same way, with ``SWIN_NORM_LAUNCHES`` (52) launches and
``SWIN_ATTN_CALLS`` SDPA attention calls, and one train step of it,
``SWIN_TRAIN_NORM_LAUNCHES`` fused norm launches (forward, backward)
against none with the norms on the composite. The mednext phase after
it runs the mednext preset (MedNeXt-L, kernel 5) at its published widths,
from the port's seeded init with each norm's scale and bias drawn:
one 128^3 forward against the plain fp32 reference ``reference/mednext.py``
on the card within ``MEDNEXT_LOGIT_TOL`` of max |logit| with
``MEDNEXT_NORM_LAUNCHES`` norm launches, one train step at batch 2
(``MEDNEXT_TRAIN_NORM_LAUNCHES`` norm launches, ``MEDNEXT_ADAM_LAUNCHES``
A1 launches, peak memory, device ms, the step's longest kernels), and
the kernels that run its depthwise convs forward and backward; alone:
``python3 -c "import torch, chip_smoke; chip_smoke.mednext_phase(torch)"``.
The isensee phase counts
the fused norm's launches of
its serving predictors (``NORM_LAUNCHES`` a forward: 216 a
sliding-window case), and the ``kernels`` line carries an
``instance_norm_act`` entry with the norm phase's shapes (``ms``,
``bound_ms``) and those counts.

The adam phase holds A1, the multi-tensor Keras Adam
(``ops/keras_adam.py``), to the eager update of one leaf at a time at the
leaf sets of the four models' train steps (``ADAM_MODELS``: Isensee2017's
114 leaves, the U-Net's 30, Swin UNETR's 151, MedNeXt-L's 516 in 7
launches): ``ADAM_STEPS`` steps from
the same weights and gradients with a learning-rate change after two, p,
m and v bit for bit, the launches (one for up to 80 leaves) and leaves
counted. Then it times three routes of the same update: A1, the same
operations in PyTorch's multi-tensor ``_foreach_`` ops, and the eager
update: host ms a step unprofiled, device ms by CUDA events and by the
profiler's kernels, kernels a step, beside A1's bound (``ADAM_BYTES`` a
parameter over the HBM rate). The train phase counts one A1 launch a U-Net
step (its gradient check's steps and ``train_model``), the isensee phase
two an Isensee2017 step, and the ``kernels`` line carries a ``keras_adam``
entry with the phase's numbers and those counts.

Then one JSON line describing the kernels, and the last line
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero; without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
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

# Norm phase tolerance, the fused kernel against its plain twin, element by
# element: |y - ref| <= NORM_REL_TOL * |ref| + NORM_ABS_TOL. The two take
# the same fp32 formula with the moments summed in another order, so their
# fp32 values differ by ~1e-6 of the terms; where they straddle a bf16
# rounding boundary the outputs differ by one bf16 step (2^-7 of the value
# at most), and the LeakyReLU's product rounds once more. The input gives
# each (sample, channel) its own offset, spread and ramp along the rows, so
# every statistics chunk has its own mean. A CPU model of the kernel's
# chunks at these shapes reads at most 0.49 of this tolerance in bf16 and
# 0.007 in fp32, and with one chunk dropped at least 3.6 of it, with
# another channel's or sample's moments at least 1e4.
NORM_REL_TOL, NORM_ABS_TOL = 2 ** -6, 1e-3
# (label, (batch, D, H, W), last axis, channels): Isensee2017's norms on
# 64^3 patches (16 base filters) at the serving batch of 8 and the last
# batch of 3 a case, level 0 folded (1, 1, 2), and the U-Net's
# InstanceNorm blocks of 32 and 64 channels at level 0
NORM_SHAPES = [(f"isensee L{lv} b{b}", (b, 64 >> lv, 64 >> lv, 64 >> lv),
                16 << lv, 16 << lv) for b in (8, 3) for lv in range(5)] + [
    ("isensee L0 fold112 b8", (8, 64, 64, 32), 32, 16),
    ("unet in32 b8", (8, 64, 64, 64), 32, 32),
    ("unet in64 b8", (8, 64, 64, 64), 64, 64)]
# Swin UNETR's residual blocks (the swin_unetr preset: feature size 48 on
# 96^3 patches, 4 a batch, the last batch of a case 3): InstanceNorm at eps
# 1e-5 without affine (ones and zeros buffers), LeakyReLU 0.01 after the
# first norm of a block and none after the others. (label, (batch, D, H,
# W), channels) of every norm shape of one forward: encoder1 and decoder1
# at 96^3, encoder2 and decoder2 at 48^3 (hidden state 0), then 24^3, 12^3
# and 6^3 (encoder3 / decoder3, encoder4 / decoder4, decoder5) and
# encoder10 on hidden state 4 at 3^3; plus 96 channels over 48^3 rows, a
# wider channel count at stage 1's row count
SWIN_NORM_EPS, SWIN_NORM_SLOPE = 1e-5, 0.01
SWIN_NORM_SHAPES = [(f"swin {n}^3 C{c} b{b}", (b, n, n, n), c)
                    for b in (4, 3) for n, c in (
                        (96, 48), (48, 48), (24, 96), (12, 192), (6, 384),
                        (3, 768))] + [("swin 48^3 C96 b4", (4, 48, 48, 48),
                                       96)]
# MedNeXt's GroupNorm(C, C) (the mednext preset: MedNeXt-L, kernel 5, 32
# base channels, batch 2 of 128^3 patches): affine InstanceNorm at eps
# 1e-5 with activation "none", after each block's depthwise conv. (label,
# (batch, D, H, W), channels, norms a forward) of every norm shape: the
# blocks of levels 0-3 and the bottleneck (encoder and decoder), the down
# blocks' at half their level's extent, and the up blocks' at the odd
# extent 2n - 1 of their transposed conv (127^3 x 64 down to 15^3 x 512)
MEDNEXT_NORM_EPS = 1e-5
MEDNEXT_NORM_SHAPES = [
    (f"mednext {n}^3 C{c} b2", (2, n, n, n), c, count)
    for n, c, count in ((128, 32, 6), (64, 64, 8), (32, 128, 16),
                        (16, 256, 16), (8, 512, 8),
                        (64, 32, 1), (32, 64, 1), (16, 128, 1), (8, 256, 1),
                        (127, 64, 1), (63, 128, 1), (31, 256, 1),
                        (15, 512, 1))]
# The training Function's gradients against autograd through the fp32
# composite (an fp32 norm on the same bf16 x, scale and bias), element by
# element: |dx - ref| <= NORM_GRAD_REL_TOL * |ref| + NORM_GRAD_ABS_TOL *
# max|ref|. Both take the same fp32 derivative and the same sign of the
# activation's input (rounding to bf16 keeps a sign), so dx differs by its
# one rounding to bf16 (half a bf16 step, 2^-9 of the value at most; the
# tolerance is a whole step) and by the fp32 sums' order in the mean terms
# (~1e-6 of them; the absolute term). dscale and dbias are fp32 sums of
# up to 1.6M products in another order: max|d - ref| <= NORM_PARAM_TOL *
# max|ref| (the sums cancel to ~sqrt(N) of their terms, so their rounding
# reads ~sqrt(N) * 2^-24 = 7e-5 of the result). The incoming gradient dy
# leans on x^ and on a per-channel offset, so that the two mean terms of
# dx are as large as dz: a kernel that dropped either term, or summed a
# chunk twice, misses by a share of max|ref|, not by a rounding.
NORM_GRAD_REL_TOL, NORM_GRAD_ABS_TOL, NORM_PARAM_TOL = 2 ** -7, 2 ** -10, 1e-3
# (label, (batch, D, H, W), channels, activation, eps, slope, affine,
# norms a train step): Isensee2017's norms in a train step (batch 6 of
# 64^3 patches, 16 base filters: six at each of levels 0-3, three at level
# 4), Swin UNETR's (``SWIN_NORM_SHAPES`` at the train step's batch of 4,
# no affine, both activations its blocks use; 96^3 x 48 down to 3^3 x
# 768, whose 768 channels a backward block covers in two row groups; not
# counted in a step) and MedNeXt's (``MEDNEXT_NORM_SHAPES``, its train
# step's batch of 2)
NORM_TRAIN_SHAPES = [
    (f"isensee train L{lv} b6", (6, 64 >> lv, 64 >> lv, 64 >> lv), 16 << lv,
     "leaky_relu", 1e-3, 0.3, True, 6 if lv < 4 else 3) for lv in range(5)
] + [(f"{label} {act}", shape, c, act, SWIN_NORM_EPS, SWIN_NORM_SLOPE,
      False, 0) for label, shape, c in SWIN_NORM_SHAPES if shape[0] == 4
     for act in ("leaky_relu", "none")] + [
    (label, shape, c, "none", MEDNEXT_NORM_EPS, 0.0, True, count)
    for label, shape, c, count in MEDNEXT_NORM_SHAPES]
NORM_HOST_CALLS = 300
# the fused norm's launches a serving forward of Isensee2017: two for each
# of its 27 norms (four forwards, 216 launches, a sliding-window case)
NORM_LAUNCHES = 54
# an Isensee2017 train step's fused norm launches (forward, backward): two
# and three for each of its 27 norms
NORM_TRAIN_LAUNCHES = (54, 81)
# the swin_unetr preset's serving forward: two for each of its 26 norms (3
# in each block whose channels change: encoder1 and the five up blocks; 2
# in encoder2, 3, 4 and 10), and its 8 Swin blocks' window attention on
# the SDPA route
SWIN_NORM_LAUNCHES, SWIN_ATTN_CALLS = 52, 8
# its train step's: two forward and two backward launches for each of the
# 26 norms (no affine: no parameter gradient, no third backward launch)
SWIN_TRAIN_NORM_LAUNCHES = (52, 52)
SWIN_CONFIG = "fetal_mri_segmentation_tpu_torch/configs/fetal_swin_unetr.json"
MEDNEXT_CONFIG = "fetal_mri_segmentation_tpu_torch/configs/fetal_mednext.json"
# the mednext preset (L, kernel 5): two forward launches for each of its 62
# norms (54 blocks, 4 down and 4 up blocks), three backward (affine: the
# parameters' gradient too)
MEDNEXT_NORM_LAUNCHES = 124
MEDNEXT_TRAIN_NORM_LAUNCHES = (124, 186)
# its 516 leaves in A1 launches of up to 80
MEDNEXT_ADAM_LAUNCHES = 7
# its bf16 forward of one 128^3 patch against the fp32 reference, as a
# share of max|logit|: every depthwise, 1^3 conv and GELU operand rounded
# to 8 bits of mantissa through 62 blocks
MEDNEXT_LOGIT_TOL = 0.05

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
# The spatial phase's halo'd slabs (parallel/spatial.py): on a mesh of
# SPATIAL_RANKS ranks that split the depth, every 3^3 conv of the U-Net runs
# on its rank's slab plus one row of each neighbour, and the fused decoder
# on its coarse slab plus one row and its skip plus two rows of each: the
# whole 128^3 volume at batch 1 (level 0: 64 + 2 rows of 128 x 128) and the
# train step's 64^3 patches at batch 6 (a 1 x 2 mesh) and 3 (2 x 2). Kept
# apart from the serving sums; the "halo-direct" shapes are one rank's
# whole-volume forward and are summed as such.
SPATIAL_RANKS = 2
HALO_BATCHES = (("halo-direct", 1, 2), ("halo-train6", 6, 1),
                ("halo-train3", 3, 1))  # (tag, batch, extent x the patch)
HALO_CONV_SHAPES = [
    (entry, f"{tag} {layer}", b, s * d // SPATIAL_RANKS + 2, s * h, s * w,
     ci, co)
    for tag, b, s in HALO_BATCHES
    for entry, layer, _, d, h, w, ci, co in CONV_SHAPES
    if layer[:3] in SLICE_LAYERS]
HALO_DEC_SHAPES = [
    (f"{tag} {layer}", b, s * d // SPATIAL_RANKS + 2, s * h, s * w, *rest)
    for tag, b, s in HALO_BATCHES
    for layer, _, d, h, w, *rest in DEC_SHAPES if layer[:3] in SLICE_LAYERS]
# The spatial phase's reshard case: a (120, 128, 128) volume on
# SPATIAL_RANKS ranks. A rank's 60-row slab halves to 30 and then 15 rows,
# which cannot be pooled: level 2 is gathered whole
# (models/layers.py::gather_level). Its encoder convs run on 15 + 2 rows,
# every coarser layer and its decoder level on the whole level on every
# rank, the finer levels on their slabs plus the halo. Labelled
# "halo-reshard", they stay out of the sums.
RESHARD_VOLUME = (120, 128, 128)
RESHARD_SLAB = RESHARD_VOLUME[0] // SPATIAL_RANKS
RESHARD_LEVEL = next(level for level in range(3)
                     if (RESHARD_SLAB >> level) % 2)


def reshard_rows(level: int, whole: bool) -> int:
    """Rows of a level of the reshard case: the whole level, or a rank's
    slab plus one halo row a side."""
    return (RESHARD_VOLUME[0] >> level if whole
            else (RESHARD_SLAB >> level) + 2)


HALO_CONV_SHAPES += [
    (entry, f"halo-reshard {layer}", 1, reshard_rows(
        int(layer[3]), int(layer[3]) > RESHARD_LEVEL or (
            layer.startswith("dec") and int(layer[3]) == RESHARD_LEVEL)),
     2 * h, 2 * w, ci, co)
    for entry, layer, _, d, h, w, ci, co in CONV_SHAPES
    if layer[:3] in SLICE_LAYERS]
HALO_DEC_SHAPES += [
    (f"halo-reshard {layer}", 1, reshard_rows(
        int(layer[3]) + 1, int(layer[3]) >= RESHARD_LEVEL), 2 * h, 2 * w,
     *rest)
    for layer, _, d, h, w, *rest in DEC_SHAPES if layer[:3] in SLICE_LAYERS]
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
# the spatial phase's Isensee2017 predictor: a rank's halo'd slab of the
# 128^3 volume (extent 2n, slab n + 2 rows on SPATIAL_RANKS = 2), batch 1
HALO_CONV_SHAPES += [
    (entry, f"halo-isensee {layer}", 1, 2 * n // SPATIAL_RANKS + 2, 2 * n,
     2 * n, ci, co) for entry, layer, n, ci, co, *_ in ISENSEE_LAYERS]
ACTIVATION.update({shape[1]: "none" for shape in HALO_CONV_SHAPES
                   if shape[1].startswith("halo-isensee")})
ACTIVATION["fold-dense isensee enc0_ctx"] = "none"
# The fold phase: configs/fetal_unet.json with level 0 space-to-depth
# folded (ops/fold.py) in each formulation, and fold (2, 2, 2). A folded
# level runs its convs as stock folded convs and never takes a kernel
# route, so a folded forward launches the unfolded forward's kernels less
# those of level 0: enc0_conv2 and dec0_conv2 (conv3x3_flat) and
# dec0_conv1 (the fused decoder).
FOLD_SETTINGS = (((1, 1, 2), "dense"), ((1, 1, 2), "parity"),
                 ((1, 1, 2), "parity_batched"), ((2, 2, 2), "parity"))
FOLD_PER_FORWARD = {entry: sum(e == entry and layer[:3] in SLICE_LAYERS
                               and layer[3] != "0"
                               for e, layer, *_ in CONV_SHAPES)
                    for entry in ("conv3x3", "conv3x3_flat")}
FOLD_PER_FORWARD["up_concat_conv3x3_kernel"] = sum(
    layer[:3] in SLICE_LAYERS and layer[3] != "0" for layer, *_ in DEC_SHAPES)
# Isensee2017 with level 0 folded: enc0_ctx (twice) and dec0_loc1 (and in
# training dec0_up at its shape) leave the kernels
ISENSEE_FOLD_PER_FORWARD, ISENSEE_FOLD_PER_TRAIN = (
    {entry: sum(row[col] for row in ISENSEE_LAYERS
                if row[0] == entry and row[1][3] != "0")
     for entry in ("conv3x3", "conv3x3_flat")} for col in (5, 6))
ISENSEE_FOLD_PER_FORWARD["up_concat_conv3x3_kernel"] = 0
ISENSEE_FOLD_PER_TRAIN["up_concat_conv3x3_kernel"] = 0
# Not on any path: the dense folded (1, 1, 2) level-0 convs at the serving
# batch, as the kernels would take them (a SAME 3^3 conv over the folded
# grid with the dense-embedded kernel, C_in = 2 C, C_out = 2 C_out; C_in a
# multiple of 128 to K1, else K2), timed beside cuDNN, for the
# narrow-channel item of the kernel queue
FOLD_DENSE_SHAPES = [
    ("conv3x3_flat", "fold-dense enc0_conv2", B, 64, 64, 32, 64, 128),
    ("conv3x3", "fold-dense dec0_conv2", B, 64, 64, 32, 128, 128),
    ("conv3x3_flat", "fold-dense isensee enc0_ctx", B, 64, 64, 32, 32, 32),
]
KERNELS = {
    "conv3x3": ("fetal_mri_segmentation_tpu_torch/csrc/conv3x3.cu",
                "fetal_mri_segmentation_tpu/ops/pallas_conv.py:43"),
    "conv3x3_flat": ("fetal_mri_segmentation_tpu_torch/csrc/conv3x3.cu",
                     "fetal_mri_segmentation_tpu/ops/pallas_conv_flat.py:83"),
    "up_concat_conv3x3_kernel": (
        "fetal_mri_segmentation_tpu_torch/csrc/dec0.cu",
        "fetal_mri_segmentation_tpu/ops/pallas_dec0.py:123"),
}
# the fused InstanceNorm + activation; no TPU kernel counterpart
NORM_SOURCE = "fetal_mri_segmentation_tpu_torch/csrc/instance_norm.cu"
# A1, the multi-tensor Keras Adam; no TPU kernel counterpart
ADAM_SOURCE = "fetal_mri_segmentation_tpu_torch/csrc/keras_adam.cu"
# the leaf sets A1 is held to: model, config, leaves, launches a step
ADAM_MODELS = (("isensee", "configs/fetal_isensee.json", 114, 2),
               ("unet", "configs/fetal_unet.json", 30, 1),
               ("swin_unetr", SWIN_CONFIG, 151, 2),
               ("mednext", MEDNEXT_CONFIG, 516, MEDNEXT_ADAM_LAUNCHES))
ADAM_STEPS = 5
# bytes a parameter of one update: p, g, m and v read; p, m and v written
ADAM_BYTES = 28


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


def dec_case(torch, gen, stats, weight, layer, b, d, h, w, cu, cs,
             co) -> None:
    """One fused-decoder shape (coarse b, d, h, w) against its plain
    version, with the kernel's and the plain version's times."""
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops

    def normal(*shape, std=1.0):
        x = torch.randn(*shape, device="cuda", generator=gen) * std
        return x.to(torch.bfloat16)

    entry = "up_concat_conv3x3_kernel"
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
        # the pre-summed K-major weights are made at the first call, kept
        # with k
        "ms": time_ms(torch, lambda: dec_ops.up_concat_conv3x3_kernel(
            xd, skip, k, bias, *act)),
        "plain_ms": time_ms(
            torch, lambda: dec_ops.up_concat_conv3x3_reference(
                xd, skip, k, bias, *act)),
        # no one PyTorch call upsamples, concatenates and convolves
        "library_ms": None,
        "prep_ms": time_ms(torch, lambda: dec_ops.kernel_weights(k, cu))}
    check(f"{layer} {(b, d, h, w)} {cu}+{cs}->{co} {act[0]}", out, ref,
          stats, entry, weight, times,
          2 * b * 8 * d * h * w * (8 * cu + 27 * cs) * co,
          2 * (xd.numel() + skip.numel() + k.numel() + out.numel()) + 4 * co)


def kernel_phase(torch, stats, halo_stats) -> None:
    """Every kernel shape of the earlier phases into ``stats`` (the serving
    forward's sums), then the spatial phase's halo'd slabs into
    ``halo_stats`` (one rank's whole-volume forward summed)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for entry, layer, *shape in CONV_SHAPES:
        conv_case(torch, gen, stats, int(layer[:3] in SLICE_LAYERS), entry,
                  layer, *shape)
    for layer, *shape in DEC_SHAPES:
        dec_case(torch, gen, stats, int(layer[:3] in SLICE_LAYERS), layer,
                 *shape)
    summarize(stats, "slice")
    for entry, layer, *shape in HALO_CONV_SHAPES:
        conv_case(torch, gen, halo_stats, int(layer.startswith(
            "halo-direct")), entry, layer, *shape)
    for layer, *shape in HALO_DEC_SHAPES:
        dec_case(torch, gen, halo_stats, int(layer.startswith(
            "halo-direct")), layer, *shape)
    summarize(halo_stats, "halo'd slab, one rank's whole-volume forward,")


def _norm_case(torch, gen, label, shape, width, c, activation="leaky_relu",
               dtype=None, eps=1e-3, slope=0.3, affine=True):
    """One fused norm shape against its plain twin and the composite.
    ``eps``, ``slope`` and ``affine``: the norm's settings (Isensee2017's by
    default; without affine its scale and bias stay ones and zeros)."""
    from fetal_mri_segmentation_tpu_torch.models.layers import InstanceNorm
    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act, instance_norm_act_reference)

    dtype = dtype or torch.bfloat16
    norm = InstanceNorm(c, dtype=dtype, device="cuda", eps=eps,
                        affine=affine)
    if affine:
        with torch.no_grad():
            norm.scale.copy_(1 + 0.5 * torch.randn(c, device="cuda",
                                                   generator=gen))
            norm.bias.copy_(0.5 * torch.randn(c, device="cuda",
                                              generator=gen))
    # over the (B, rows, C) view the kernel reads: each (sample, channel)
    # its own offset (far from zero, as after a conv with a bias), spread
    # and ramp along the rows, which the statistics chunks split in order
    b, fold = shape[0], width // c
    rows = math.prod(shape[1:]) * fold

    def per_pair():
        return torch.randn(b, 1, c, device="cuda", generator=gen)

    ramp = torch.linspace(-1.0, 1.0, rows, device="cuda").view(1, rows, 1)
    x = (4.0 * per_pair() + torch.exp(0.5 * per_pair()) * (
        torch.randn(b, rows, c, device="cuda", generator=gen)
        + 2.0 * per_pair() * ramp)).reshape(*shape, width).to(dtype)
    with torch.inference_mode():
        instance_norm_act.launches = 0
        y = norm(x, activation=activation, negative_slope=slope)
        torch.cuda.synchronize()
        launches = instance_norm_act.launches
        ref = instance_norm_act_reference(
            x.reshape(shape[0], -1, c), norm.scale, norm.bias, activation,
            slope, norm.epsilon).reshape(x.shape).float()
        diff = (y.float() - ref).abs()
        err = diff.max().item()
        share = (diff / (NORM_REL_TOL * ref.abs() + NORM_ABS_TOL)).max(
            ).item()
        ms = time_ms(torch, lambda: norm(x, activation=activation,
                                         negative_slope=slope))
        old_ms = time_ms(torch, lambda: norm._composite(
            x, False, fold, activation, slope))
    bound = 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    print(f"norm {label} {tuple(x.shape)} C={c} {activation} {dtype} eps "
          f"{eps} slope {slope} affine {affine}: "
          f"max|diff| {err:.6g}, {share:.4f} of the tolerance; launches "
          f"{launches}; ms {ms:.6g} composite_ms {old_ms:.6g}; bound "
          f"{bound:.6g} ms (bytes), {bound / ms:.4f} of it", flush=True)
    if not share <= 1 or launches != 2:
        raise AssertionError(f"norm {label}: {share} of the tolerance or "
                             f"launches {launches} != 2")
    return {"label": label, "ms": ms, "composite_ms": old_ms,
            "bound_ms": bound, "max_abs_err": err, "tol_share": share}


def _host_us(torch, fn, calls: int = NORM_HOST_CALLS) -> float:
    """Host microseconds a call of ``fn``: the enqueue alone, timed over
    ``calls`` calls after a synchronize, on a shape whose device work is
    far shorter than its enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def norm_phase(torch) -> dict:
    """The fused InstanceNorm + activation on the card (see the module
    docstring); returns the shapes' times and the host microseconds."""
    import dataclasses

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model, layers
    from fetal_mri_segmentation_tpu_torch.models.layers import InstanceNorm
    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [_norm_case(torch, gen, *case) for case in NORM_SHAPES]
    for act in ("relu", "none"):
        rows.append(_norm_case(torch, gen, f"isensee L1 b8 {act}",
                               (8, 32, 32, 32), 32, 32, act))
    rows.append(_norm_case(torch, gen, "isensee L2 b8 fp32", (8, 16, 16, 16),
                           64, 64, dtype=torch.float32))
    for b in (8, 3):
        total = sum(r["ms"] for r in rows[:10] if r["label"].endswith(
            f"b{b}"))
        old = sum(r["composite_ms"] for r in rows[:10]
                  if r["label"].endswith(f"b{b}"))
        print(f"norm isensee levels 0-4 at batch {b}, one norm each: fused "
              f"{total:.6g} ms, composite {old:.6g} ms", flush=True)
    for label, shape, c in SWIN_NORM_SHAPES:
        for act in ("leaky_relu", "none"):
            rows.append(_norm_case(
                torch, gen, f"{label} {act}", shape, c, c, act,
                eps=SWIN_NORM_EPS, slope=SWIN_NORM_SLOPE, affine=False))
    for label, shape, c, _ in MEDNEXT_NORM_SHAPES:
        rows.append(_norm_case(torch, gen, f"{label} none", shape, c, c,
                               "none", eps=MEDNEXT_NORM_EPS))

    # host cost of one norm call, on Isensee's level 4 (4^3 voxels x 256
    # channels a patch: a few microseconds of device work)
    norm = InstanceNorm(256, dtype=torch.bfloat16, device="cuda")
    x = torch.randn(8, 4, 4, 4, 256, device="cuda",
                    generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        fused_us = _host_us(torch, lambda: norm(
            x, activation="leaky_relu", negative_slope=0.3))
        old_us = _host_us(torch, lambda: norm._composite(
            x, False, 1, "leaky_relu", 0.3))
    print(f"norm host us a call (level 4, batch 8, {NORM_HOST_CALLS} calls):"
          f" fused {fused_us:.4f}, composite {old_us:.4f}", flush=True)

    # one batch-8 Isensee2017 forward, fused norms against the composite,
    # both held to an fp32 model on the composite (as the spatial phase
    # holds its Isensee predictor). The fused and the composite norm round
    # one output in a few hundred differently (one bf16 step), and each of
    # the 27 norms scales that back to unit variance: the same kind of
    # difference as kernels on against off, so NORM_PROB_TOL (PROB_TOL is
    # the U-Net's, where no norm undoes the damping with depth; this forward
    # measured 0.0215 against it on the H100)
    config = Config.load(str(ROOT / "configs" / "fetal_isensee.json"))
    weights = from_flax(init_flax_like(config, seed=0))
    model = build_model(config, "cuda").eval()
    model.load_state_dict(weights)
    model32 = build_model(dataclasses.replace(
        config, compute_dtype="float32"), "cuda").eval()
    model32.load_state_dict(weights)
    xb = torch.randn(8, *config.patch_shape, config.nb_channels,
                     device="cuda", generator=gen)
    with torch.inference_mode():
        instance_norm_act.launches = 0
        fused = model(xb).float()
        torch.cuda.synchronize()
        launches = instance_norm_act.launches
        fused_ms = time_ms(torch, lambda: model(xb))
        fused_host = _host_us(torch, lambda: model(xb), 20) / 1e3
        saved = layers._kernel_device
        layers._kernel_device = lambda t: False
        try:
            plain = model(xb).float()
            p32 = model32(xb).float()
            old_ms = time_ms(torch, lambda: model(xb))
            old_host = _host_us(torch, lambda: model(xb), 20) / 1e3
        finally:
            layers._kernel_device = saved
    diff = (fused - plain).abs().max().item()
    fused_32 = (fused - p32).abs().max().item()
    plain_32 = (plain - p32).abs().max().item()
    bound = max(2 * plain_32, PROB_TOL)
    print(f"norm isensee forward batch 8: max|p_fused - p_composite| "
          f"{diff:.6g} <= {NORM_PROB_TOL}; max|p - p_fp32| fused "
          f"{fused_32:.6g} <= {bound:.6g}, composite {plain_32:.6g}; "
          f"launches {launches}; device ms {fused_ms:.6g} against "
          f"{old_ms:.6g}; host ms a forward {fused_host:.6g} against "
          f"{old_host:.6g}", flush=True)
    if not (diff <= NORM_PROB_TOL and fused_32 <= bound
            and launches == NORM_LAUNCHES):
        raise AssertionError(f"norm isensee forward: {diff} > "
                             f"{NORM_PROB_TOL}, {fused_32} > {bound} or "
                             f"launches {launches} != {NORM_LAUNCHES}")
    return {"shapes": rows, "host_us": {"fused": fused_us,
                                        "composite": old_us},
            "forward_ms": {"fused": fused_ms, "composite": old_ms},
            "forward_host_ms": {"fused": fused_host, "composite": old_host}}


def _norm_train_case(torch, gen, label, shape, c, activation, eps, slope,
                     affine, count):
    """The training Function (forward and backward) at one shape against
    autograd through the fp32 composite; its launches and CUDA-event ms of
    forward plus backward against the bf16 composite's (the route a train
    step takes where the kernel refuses the shape)."""
    from fetal_mri_segmentation_tpu_torch.models.layers import InstanceNorm
    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act, instance_norm_act_backward)

    norm = InstanceNorm(c, device="cuda", eps=eps, affine=affine)
    norm32 = InstanceNorm(c, dtype=torch.float32, device="cuda", eps=eps,
                          affine=affine)
    if affine:
        with torch.no_grad():
            norm.scale.copy_(1 + 0.5 * torch.randn(c, device="cuda",
                                                   generator=gen))
            norm.bias.copy_(0.5 * torch.randn(c, device="cuda",
                                              generator=gen))
    norm32.load_state_dict(norm.state_dict())
    b = shape[0]
    rows = math.prod(shape[1:])

    def per_pair():
        return torch.randn(b, 1, c, device="cuda", generator=gen)

    ramp = torch.linspace(-1.0, 1.0, rows, device="cuda").view(1, rows, 1)
    x = (4.0 * per_pair() + torch.exp(0.5 * per_pair()) * (
        torch.randn(b, rows, c, device="cuda", generator=gen)
        + 2.0 * per_pair() * ramp)).to(torch.bfloat16)
    xf = x.float()
    xn = (xf - xf.mean(1, keepdim=True)) / xf.std(1, keepdim=True)
    dy = (torch.randn(b, rows, c, device="cuda", generator=gen)
          + 1.5 * per_pair() * xn + per_pair()).to(torch.bfloat16)
    x, dy = x.reshape(*shape, c), dy.reshape(*shape, c)
    params = [norm.scale, norm.bias] if affine else []
    params32 = [norm32.scale, norm32.bias] if affine else []
    xg = x.detach().requires_grad_(True)
    x32 = x.float().requires_grad_(True)

    def fused():
        y = norm(xg, activation=activation, negative_slope=slope)
        return y, torch.autograd.grad(y, [xg, *params], dy)

    def composite():
        y = norm._composite(xg, False, 1, activation, slope)
        return torch.autograd.grad(y, [xg, *params], dy)

    instance_norm_act.launches = instance_norm_act_backward.launches = 0
    y, got = fused()
    torch.cuda.synchronize()
    launches = (instance_norm_act.launches,
                instance_norm_act_backward.launches)
    want = torch.autograd.grad(
        norm32._composite(x32, False, 1, activation, slope),
        [x32, *params32], dy.float())
    ref = want[0]
    diff = (got[0].float() - ref).abs()
    dx_share = (diff / (NORM_GRAD_REL_TOL * ref.abs() + NORM_GRAD_ABS_TOL
                        * ref.abs().max())).max().item()
    param_share = max([((g - w).abs().max() / (NORM_PARAM_TOL * w.abs().max())
                        ).item() for g, w in zip(got[1:], want[1:])],
                      default=0.0)
    ms = time_ms(torch, fused)
    old_ms = time_ms(torch, composite)
    fwd_dev, bwd_dev = _norm_kernel_ms(torch, fused)
    del y, got, want, ref, diff, x32
    # each input read once and each output written once: x and y in the
    # forward, x, dy and dx in the backward (the (B, C) moments and the
    # parameters are a rounding); the two-pass algorithm also reads x again
    # in the forward and x and dy again in the backward
    size = x.element_size() * x.numel()
    bound = 5 * size / HBM_BYTES_PER_S * 1e3
    two_pass = 8 * size / HBM_BYTES_PER_S * 1e3
    want_launches = (2, 3 if affine else 2)
    device = ("not measured (no device events)" if fwd_dev is None else
              f"{fwd_dev:.6g} + {bwd_dev:.6g} ms, "
              f"{bound / (fwd_dev + bwd_dev):.4f} "
              "of the bound")
    print(f"norm train {label} {tuple(x.shape)} {activation} eps {eps} "
          f"affine {affine}: dx {dx_share:.4f} of the tolerance, dscale / "
          f"dbias {param_share:.4f} of theirs; launches forward "
          f"{launches[0]}, backward {launches[1]}; forward + backward ms "
          f"{ms:.6g} composite_ms {old_ms:.6g}; bound {bound:.6g} ms "
          f"({5 * x.element_size()} bytes an element), {bound / ms:.4f} of "
          f"it (two-pass traffic {two_pass:.6g} ms); the kernels' device "
          f"time, forward + backward: {device}", flush=True)
    if not (dx_share <= 1 and param_share <= 1
            and launches == want_launches):
        raise AssertionError(f"norm train {label}: dx {dx_share}, params "
                             f"{param_share} of the tolerance or launches "
                             f"{launches} != {want_launches}")
    return {"label": label, "ms": ms, "composite_ms": old_ms,
            "bound_ms": bound, "two_pass_ms": two_pass,
            "fwd_device_ms": fwd_dev,
            "bwd_device_ms": bwd_dev, "dx_tol_share": dx_share,
            "param_tol_share": param_share, "per_step": count}


def _norm_kernel_ms(torch, fn, calls: int = 5):
    """Device ms a call of ``fn`` in the fused norm's forward kernels and
    in its backward kernels, from ``torch.profiler``'s device events (the
    events time what the host's enqueue hides at small shapes); (None,
    None) where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    fwd = bwd = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "instance_norm_bwd" in e.name:
            bwd += e.time_range.elapsed_us()
        elif "instance_norm_" in e.name:
            fwd += e.time_range.elapsed_us()
    if fwd == 0:
        return None, None
    return fwd / calls / 1e3, bwd / calls / 1e3


def norm_train_phase(torch) -> dict:
    """The fused norm's training Function on the card at every norm shape
    of Isensee2017's, Swin UNETR's and MedNeXt's train steps (see
    ``NORM_TRAIN_SHAPES``); returns each shape's times and the sums of an
    Isensee2017 step's and a MedNeXt step's norms."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = [_norm_train_case(torch, gen, *case) for case in NORM_TRAIN_SHAPES]
    out = {"shapes": rows}
    for kind, norms in (("isensee", 27), ("mednext", 62)):
        mine = [r for r in rows if r["label"].startswith(kind)]
        counted = sum(r["per_step"] for r in mine)
        if counted != norms:
            raise AssertionError(f"norm train {kind}: {counted} norms a "
                                 f"step, not {norms}")
        step = {key: sum(r[key] * r["per_step"] for r in mine)
                for key in ("ms", "composite_ms", "bound_ms", "two_pass_ms")}
        print(f"norm train {kind} step's {norms} norms, forward + backward: "
              f"fused {step['ms']:.6g} ms, composite "
              f"{step['composite_ms']:.6g} ms, bound {step['bound_ms']:.6g} "
              f"ms (two-pass traffic {step['two_pass_ms']:.6g} ms)",
              flush=True)
        out[f"{kind}_step"] = step
    return out


def swin_phase(torch) -> dict:
    """One serving forward of the swin_unetr preset (``SWIN_CONFIG``:
    feature size 48, bf16) on a batch of 4 96^3 patches, with weights from
    ``init_parameters`` at seed 0: the fused norm's launches exactly
    ``SWIN_NORM_LAUNCHES`` and the window attention's SDPA calls
    ``SWIN_ATTN_CALLS``; the probabilities against the same model with
    every norm on the composite (``NORM_PROB_TOL``), both held to an fp32
    model on the composite (the fused no further from it than twice the
    composite, or ``PROB_TOL``), as the norm phase holds Isensee2017's
    forward; both forwards timed."""
    import dataclasses

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model, layers
    from fetal_mri_segmentation_tpu_torch.models.swin_unetr import (
        init_parameters)
    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act)
    from fetal_mri_segmentation_tpu_torch.ops.window_attention import (
        window_attention)

    config = Config.load(str(ROOT / SWIN_CONFIG))
    model = build_model(config, "cuda").eval()
    init_parameters(model, seed=0)
    model32 = build_model(dataclasses.replace(
        config, compute_dtype="float32"), "cuda").eval()
    model32.load_state_dict(model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.randn(config.batch_size, *config.patch_shape,
                     config.nb_channels, device="cuda", generator=gen)
    with torch.inference_mode():
        instance_norm_act.launches = 0
        before = window_attention.calls["sdpa"]
        fused = model(xb).float()
        torch.cuda.synchronize()
        launches = instance_norm_act.launches
        attn_calls = window_attention.calls["sdpa"] - before
        fused_ms = time_ms(torch, lambda: model(xb), 5)
        saved = layers._kernel_device
        layers._kernel_device = lambda t: False
        try:
            instance_norm_act.launches = 0
            plain = model(xb).float()
            p32 = model32(xb).float()
            plain_launches = instance_norm_act.launches
            old_ms = time_ms(torch, lambda: model(xb), 5)
        finally:
            layers._kernel_device = saved
    diff = (fused - plain).abs().max().item()
    fused_32 = (fused - p32).abs().max().item()
    plain_32 = (plain - p32).abs().max().item()
    bound = max(2 * plain_32, PROB_TOL)
    print(f"swin forward batch {config.batch_size} of "
          f"{tuple(config.patch_shape)}: max|p_fused - p_composite| "
          f"{diff:.6g} <= {NORM_PROB_TOL}; max|p - p_fp32| fused "
          f"{fused_32:.6g} <= {bound:.6g}, composite {plain_32:.6g} (p in "
          f"[{fused.min().item():.6g}, {fused.max().item():.6g}]); norm "
          f"launches {launches} (composite {plain_launches}), attention "
          f"calls {attn_calls}; device ms {fused_ms:.6g} against "
          f"{old_ms:.6g}", flush=True)
    if not (diff <= NORM_PROB_TOL and fused_32 <= bound
            and bool(torch.isfinite(fused).all())
            and launches == SWIN_NORM_LAUNCHES and plain_launches == 0
            and attn_calls == SWIN_ATTN_CALLS):
        raise AssertionError(
            f"swin forward: {diff} > {NORM_PROB_TOL}, {fused_32} > {bound}, "
            f"non-finite, launches {launches} != {SWIN_NORM_LAUNCHES} "
            f"(composite {plain_launches}) or attention calls {attn_calls} "
            f"!= {SWIN_ATTN_CALLS}")
    return {"launches": launches, "forward_ms": {"fused": fused_ms,
                                                 "composite": old_ms}}


def swin_train_phase(torch) -> dict:
    """One train step of the swin_unetr preset (``SWIN_CONFIG``: a batch of
    4 96^3 patches, bf16, no augmentation) from ``init_parameters`` at seed
    0, twice: with the fused norms, exactly ``SWIN_TRAIN_NORM_LAUNCHES``
    launches, and with every norm on the composite, none; loss and every
    gradient finite; the fused step's gradients against the composite's
    (relative L2, worst and median leaf), the peak memory and the ms of two
    more steps printed."""
    import dataclasses
    import statistics

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model, layers
    from fetal_mri_segmentation_tpu_torch.models.swin_unetr import (
        init_parameters)
    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act, instance_norm_act_backward)
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)

    config = dataclasses.replace(Config.load(str(ROOT / SWIN_CONFIG)),
                                 augment=False)
    x_np, y_np = train_batch(config)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    saved = layers._kernel_device
    runs = {}
    for name in ("fused", "composite"):
        model = build_model(config, "cuda")
        init_parameters(model, seed=0)
        state = create_train_state(model, config)
        step = make_train_step(
            model, config,
            generator=torch.Generator(device="cuda").manual_seed(0))
        if name == "composite":
            layers._kernel_device = lambda t: False
        torch.cuda.reset_peak_memory_stats()
        instance_norm_act.launches = instance_norm_act_backward.launches = 0
        try:
            loss = float(step(state, x, y)["loss"])
            launches = (instance_norm_act.launches,
                        instance_norm_act_backward.launches)
            grads = {n: p.grad.float().clone()
                     for n, p in model.named_parameters()}
            ms = time_ms(torch, lambda: step(state, x, y), 2)
        finally:
            layers._kernel_device = saved
        runs[name] = {"loss": loss, "launches": launches, "grads": grads,
                      "ms": ms,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
        del model, state, step
    fused, plain = runs["fused"], runs["composite"]
    gaps = {n: _rel(g, plain["grads"][n])
            for n, g in fused["grads"].items()}
    worst = max(gaps, key=gaps.get)
    finite = all(bool(torch.isfinite(g).all()) and math.isfinite(r["loss"])
                 for r in runs.values() for g in r["grads"].values())
    print(f"swin train step batch {config.batch_size} of "
          f"{tuple(config.patch_shape)}: fused norm launches (forward, "
          f"backward) {fused['launches']} (composite {plain['launches']}); "
          f"loss {fused['loss']:.6g} fused, {plain['loss']:.6g} composite; "
          f"{len(gaps)} gradients against the composite's: relative L2 "
          f"median {statistics.median(gaps.values()):.6g}, worst "
          f"{gaps[worst]:.6g} ({worst}); ms a step {fused['ms']:.6g} against "
          f"{plain['ms']:.6g}; peak bytes {fused['peak_bytes']} against "
          f"{plain['peak_bytes']}", flush=True)
    if not (finite and fused["launches"] == SWIN_TRAIN_NORM_LAUNCHES
            and plain["launches"] == (0, 0)):
        raise AssertionError(
            f"swin train step: non-finite loss or gradient, or launches "
            f"{fused['launches']} != {SWIN_TRAIN_NORM_LAUNCHES} (composite "
            f"{plain['launches']})")
    return {"launches": fused["launches"],
            "step_ms": {"fused": fused["ms"], "composite": plain["ms"]},
            "peak_bytes": {"fused": fused["peak_bytes"],
                           "composite": plain["peak_bytes"]},
            "grad_gap": {"median": statistics.median(gaps.values()),
                         "worst": gaps[worst]}}


def _kernels_of(torch, run, top: int = 12):
    """The device kernels of ``run()`` under the profiler: [(name, count,
    ms)] by time, the ``top`` longest (record_function ranges, which the
    profiler also lays on the device, left out)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[2])[:top]


def mednext_phase(torch) -> dict:
    """The mednext preset (``MEDNEXT_CONFIG``: MedNeXt-L, kernel 5, 32
    base channels, bf16) at its published widths:

    - one serving forward of a 128^3 patch, with the port's seeded init
      (``models/mednext.py::init_parameters`` at seed 0) and each norm's
      scale and bias drawn away from ones and zeros, against the plain
      fp32 reference ``reference/mednext.py`` on the card (TF32 off),
      within ``MEDNEXT_LOGIT_TOL`` of max|logit|, with
      ``MEDNEXT_NORM_LAUNCHES`` fused norm launches;
    - one train step at the preset's batch (2 128^3 patches, its
      augmentation): ``MEDNEXT_TRAIN_NORM_LAUNCHES`` norm launches and
      ``MEDNEXT_ADAM_LAUNCHES`` A1 launches, loss and gradients finite, its
      peak memory and the device ms of two more steps;
    - the kernels that ran the depthwise convs (a level-0 block's, the
      first down block's and the last up block's, at batch 2), forward and
      backward, with their device ms, and the step's longest kernels."""
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model, mednext
    from fetal_mri_segmentation_tpu_torch.ops import keras_adam as adam_ops
    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act, instance_norm_act_backward)
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.models.layers import InstanceNorm
    from reference import mednext as ref

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = Config.load(str(ROOT / MEDNEXT_CONFIG))
    rcfg = {"n_base_filters": config.n_base_filters,
            "n_labels": config.n_labels,
            "mednext_size": config.mednext_size,
            "mednext_kernel": config.mednext_kernel}
    model = build_model(config, "cuda").eval()
    mednext.init_parameters(model, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for norm in model.modules():
            if isinstance(norm, InstanceNorm):
                c = norm.scale.shape[0]
                norm.scale.copy_(1 + 0.25 * torch.randn(
                    c, device="cuda", generator=gen))
                norm.bias.copy_(0.25 * torch.randn(c, device="cuda",
                                                   generator=gen))
    weights = {k: v.detach().float().clone()
               for k, v in model.state_dict().items()}
    x = torch.randn(1, 1, *config.patch_shape, device="cuda", generator=gen)
    with torch.inference_mode():
        instance_norm_act.launches = 0
        got = model(x.permute(0, 2, 3, 4, 1), logits=True).permute(
            0, 4, 1, 2, 3).float()
        torch.cuda.synchronize()
        launches = instance_norm_act.launches
        forward_ms = time_ms(torch, lambda: model(x.permute(0, 2, 3, 4, 1)),
                             3)
        want = ref.forward(weights, x, rcfg)
    scale = want.abs().max().item()
    gap = (got - want).abs().max().item() / scale
    print(f"mednext forward 1 x {tuple(config.patch_shape)}, size "
          f"{config.mednext_size} kernel {config.mednext_kernel}: "
          f"max|logit - reference| / max|reference| {gap:.6g} <= "
          f"{MEDNEXT_LOGIT_TOL} (max|reference| {scale:.6g}); norm launches "
          f"{launches}; device ms {forward_ms:.6g}", flush=True)
    if not (gap <= MEDNEXT_LOGIT_TOL and launches == MEDNEXT_NORM_LAUNCHES
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"mednext forward: {gap} > {MEDNEXT_LOGIT_TOL}, "
                             f"non-finite, or launches {launches} != "
                             f"{MEDNEXT_NORM_LAUNCHES}")
    del got, want

    x_np, y_np = train_batch(config)
    xb = torch.from_numpy(x_np).cuda()
    yb = torch.from_numpy(y_np).cuda()
    model.train()
    state = create_train_state(model, config)
    step = make_train_step(model, config, generator=torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    instance_norm_act.launches = instance_norm_act_backward.launches = 0
    adam_ops.keras_adam.launches = 0
    loss = float(step(state, xb, yb)["loss"])
    train_launches = (instance_norm_act.launches,
                      instance_norm_act_backward.launches)
    a1 = adam_ops.keras_adam.launches
    finite = math.isfinite(loss) and all(
        bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    peak = torch.cuda.max_memory_allocated()
    step_ms = time_ms(torch, lambda: step(state, xb, yb), 2)
    rows = _kernels_of(torch, lambda: step(state, xb, yb), 15)
    print(f"mednext train step batch {config.batch_size} of "
          f"{tuple(config.patch_shape)}: loss {loss:.6g}; norm launches "
          f"(forward, backward) {train_launches}; A1 launches {a1}; device "
          f"ms a step {step_ms:.6g}; peak bytes {peak}", flush=True)
    for name, n, ms in rows:
        print(f"mednext step kernel {ms:.4f} ms x{n}: {name[:110]}",
              flush=True)
    if not (finite and train_launches == MEDNEXT_TRAIN_NORM_LAUNCHES
            and a1 == MEDNEXT_ADAM_LAUNCHES):
        raise AssertionError(
            f"mednext train step: non-finite, norm launches {train_launches}"
            f" != {MEDNEXT_TRAIN_NORM_LAUNCHES} or A1 launches {a1} != "
            f"{MEDNEXT_ADAM_LAUNCHES}")
    del model, state, step, xb, yb
    torch.cuda.empty_cache()

    routes = {}
    for label, module in (
            ("enc_block_0 (stride 1)", mednext.DepthwiseConv3d(
                32, 5, device="cuda")),
            ("down_0 (stride 2)", mednext.DepthwiseConv3d(
                32, 5, 2, device="cuda")),
            ("up_0 (transposed)", mednext.DepthwiseConv3d(
                64, 5, 2, True, device="cuda"))):
        n = 64 if "up" in label else 128
        c = module.weight.shape[0]
        xd = torch.randn(2, n, n, n, c, device="cuda",
                         dtype=torch.bfloat16).requires_grad_(True)
        with torch.no_grad():
            module.weight.normal_()
            module.bias.normal_()
            yd = module(xd)
        dy = torch.randn_like(yd)

        def forward(m=module, t=xd):
            with torch.no_grad():
                m(t)

        def backward(m=module, t=xd, g=dy):
            torch.autograd.grad(m(t), [t, m.weight, m.bias], g)

        fwd = _kernels_of(torch, forward, 4)
        both = _kernels_of(torch, backward, 8)
        routes[label] = {"forward": fwd, "forward_backward": both}
        print(f"mednext depthwise {label} {tuple(xd.shape)} bf16: forward "
              + "; ".join(f"{k[:90]} x{m} {ms:.4f} ms" for k, m, ms in fwd)
              + " | forward + backward "
              + "; ".join(f"{k[:90]} x{m} {ms:.4f} ms" for k, m, ms in both),
              flush=True)
        del xd, yd, dy
    return {"logit_gap": gap, "launches": launches,
            "train_launches": train_launches, "adam_launches": a1,
            "forward_ms": forward_ms, "step_ms": step_ms, "peak_bytes": peak,
            "routes": routes}


def _foreach_keras_adam(table, grads, alphas, b1, b2, eps, lr):
    """The eager update's operations in its order, each over every leaf at
    once in PyTorch's multi-tensor ``_foreach_`` ops: the library route A1
    is timed against, called as ``ops/keras_adam.py::keras_adam`` (the
    leaves and moments are the table's ``written``)."""
    import numpy as np
    import torch

    n = len(grads)
    params, mus, nus = (table.written[i * n:(i + 1) * n] for i in range(3))
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nus, b2)
    sq = torch._foreach_mul(grads, 1 - b2)
    torch._foreach_mul_(sq, grads)
    torch._foreach_add_(nus, sq)
    update = torch._foreach_mul(mus, list(alphas))
    den = torch._foreach_sqrt(nus)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(update, den)
    torch._foreach_mul_(update, -float(np.float32(lr)))
    torch._foreach_add_(params, update)


def adam_phase(torch) -> dict:
    """A1 against the eager update at each leaf set of ``ADAM_MODELS``, bit
    for bit, and the three routes' times (see the module docstring);
    returns each model's numbers."""
    import statistics

    from torch import nn
    from torch.profiler import ProfilerActivity, profile

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops import keras_adam
    from fetal_mri_segmentation_tpu_torch.training.state import KerasAdam

    kernel, takes = keras_adam.keras_adam, keras_adam.takes
    routes = {"a1": (kernel, takes),
              "foreach": (_foreach_keras_adam, takes),
              "composite": (kernel, lambda p: False)}
    out = {}
    for kind, path, n_leaves, per_step in ADAM_MODELS:
        torch.manual_seed(0)
        model = build_model(Config.load(str(ROOT / path)), device="cuda")
        base = [p.detach().clone() for p in model.parameters()]
        del model
        n = sum(p.numel() for p in base)
        gen = torch.Generator(device="cuda").manual_seed(2)
        grads = [[torch.randn(p.shape, device="cuda", generator=gen) * 0.01
                  for p in base] for _ in range(ADAM_STEPS)]
        leaves = {r: [nn.Parameter(p.clone()) for p in base] for r in routes}
        opts = {r: KerasAdam(leaves[r], 5e-4) for r in routes}

        def step(route):
            keras_adam.keras_adam, keras_adam.takes = routes[route]
            try:
                opts[route].step()
            finally:
                keras_adam.keras_adam, keras_adam.takes = kernel, takes

        kernel.launches = kernel.leaves = 0
        for t in range(ADAM_STEPS):
            for route in routes:
                if t == 2:
                    opts[route].set_learning_rate(2.5e-4)
                for p, g in zip(leaves[route], grads[t]):
                    p.grad = g
                step(route)
        torch.cuda.synchronize()
        counted = (kernel.launches, kernel.leaves)
        want = (ADAM_STEPS * per_step, ADAM_STEPS * n_leaves)
        ref = opts["composite"].state
        same = {r: all(torch.equal(a, c)
                       and torch.equal(opts[r].state[a]["mu"], ref[c]["mu"])
                       and torch.equal(opts[r].state[a]["nu"], ref[c]["nu"])
                       for a, c in zip(leaves[r], leaves["composite"]))
                for r in ("a1", "foreach")}
        print(f"adam {kind}: {len(base)} leaves, {n} parameters, "
              f"{ADAM_STEPS} steps (lr 5e-4, then 2.5e-4 from the third) "
              f"against the eager update: p, m and v bit for bit with A1 "
              f"{same['a1']}, with _foreach_ ops {same['foreach']}; A1 "
              f"launches, leaves {counted} (want {want})", flush=True)
        if len(base) != n_leaves or not same["a1"] or counted != want:
            raise AssertionError(f"adam {kind}: {len(base)} leaves, A1 bit "
                                 f"for bit {same['a1']}, counted {counted}")
        bound = ADAM_BYTES * n / HBM_BYTES_PER_S * 1e3
        row = {"leaves": n_leaves, "parameters": n, "bound_ms": bound,
               "launches_per_step": per_step,
               "foreach_bit_for_bit": same["foreach"]}
        for route in routes:
            for p, g in zip(leaves[route], grads[0]):
                p.grad = g
            host = []
            for _ in range(30):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(route)
                host.append(1e3 * (time.perf_counter() - t0))
            events_ms = time_ms(torch, lambda: step(route), iters=20)
            calls = 5
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    step(route)
                torch.cuda.synchronize()
            device = annotated = kernels = 0.0
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                # the optimizer's step is a record_function range, which
                # the profiler also lays on the device from its first
                # kernel to its last: not a kernel's time
                if getattr(e, "is_user_annotation", False):
                    annotated += e.self_device_time_total
                else:
                    device += e.self_device_time_total
                    kernels += e.count
            q1, _, q3 = statistics.quantiles(host, n=4)
            row[route] = {"host_ms": statistics.median(host), "host_q1": q1,
                          "host_q3": q3, "events_ms": events_ms,
                          "device_ms": device / calls / 1e3,
                          "kernels": kernels / calls,
                          "annotation_ms": annotated / calls / 1e3}
            r = row[route]
            print(f"adam {kind} {route}: host {r['host_ms']:.4f} ms a step "
                  f"(q1 {q1:.4f}, q3 {q3:.4f}), events {events_ms:.4f} ms, "
                  f"device {r['device_ms']:.4f} ms in {r['kernels']:.1f} "
                  f"kernels by the profiler (the step's device-side range "
                  f"{r['annotation_ms']:.4f} ms, not counted), bound "
                  f"{bound:.4f} ms ({ADAM_BYTES} B a parameter), "
                  f"{100 * bound / r['device_ms']:.1f} % of it", flush=True)
        out[kind] = row
        del base, grads, leaves, opts
        torch.cuda.empty_cache()
    return out


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
    from fetal_mri_segmentation_tpu_torch.ops.keras_adam import keras_adam
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
    # A1: one launch a step for the U-Net's 30 leaves
    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel, keras_adam)

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
        want = {**(PER_FORWARD if name == "on"
                   else dict.fromkeys(PER_FORWARD, 0)), "keras_adam": 1}
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
    want["keras_adam"] = loop_cfg.n_epochs * n_t
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


# The parity phase: the port's bf16 training held where the JAX package
# holds its own. tests/test_torch_bf16_parity.py holds the port's max-pool
# tie gradients to JAX's on the CPU, bit for bit; here the card's must be
# the CPU's, bit for bit, on the recipe's level-0 pool input with planted
# ties (a window's gradient goes to its first maximum, a fold cell splits
# it evenly). Then PARITY_STEPS bf16 steps of the multi-class recipe's
# model (tools/torch_multiclass_quality.py: depth 3, 8 filters, sigmoid
# over labels 1, 2, 4, weighted dice, batch 3 of 40^3, Keras Adam at lr
# 5e-4), the kernels on and off, each beside the card's fp32 steps from
# the same seeded weights and batches. The bound on each step's loss: on
# the CPU, from these weights and on these batches, the JAX package's own
# bf16 steps lie at most PARITY_JAX_REL (relative) from its fp32 steps
# over the 10 (tools/bf16_parity_steps.py; the port's bf16 on the CPU lies
# at most 0.0068 from them). The port's bf16 on the card may lie three
# times as far: the kernel route's backward runs in fp32 and cuDNN sums in
# other orders, and bf16 moves the pace of the descent most where it
# steepens (from JAX's own PRNGKey(0) weights JAX's bf16 lies 0.099 from
# its fp32 by step 9). A step that does not train (a wrong gradient, a
# dropped layer) leaves the loss where it started, 0.72 of the fp32 loss
# at step 9 away from it.
PARITY_STEPS, PARITY_SIZE, PARITY_BATCH = 10, 40, 3
PARITY_JAX_REL = 0.0232
PARITY_LOSS_RTOL = 3 * PARITY_JAX_REL
PARITY_LABELS = (1, 2, 4)


def _tie_input(shape, seed=0):
    """Values from {0, 0.5, 1, 1.5}, exact in bf16, so most 2^3 windows
    hold a tied maximum; each channel's first window has its maximum at
    window positions 3 and 5 alone, its second all eight equal."""
    import numpy as np

    x = np.random.default_rng(seed).integers(0, 4, size=shape).astype(
        np.float32) / 2
    first = np.zeros(8, np.float32)
    first[[3, 5]] = 2.0
    x[:, 0:2, 0:2, 0:2] = first.reshape(2, 2, 2)[None, ..., None]
    x[:, 0:2, 0:2, 2:4] = 1.0
    return x


def _multiclass_batches(steps: int = PARITY_STEPS, size: int = PARITY_SIZE,
                        batch: int = PARITY_BATCH, n_cases: int = 6):
    """``steps`` channels-first batches of ``batch`` cases drawn from
    ``n_cases`` multi-class cases of ``size``^3 (each volume normalized to
    zero mean and unit variance), float32 numpy."""
    import numpy as np

    from fetal_mri_segmentation_tpu_torch.data.synthetic import (
        make_multiclass_case)

    xs, ys = [], []
    for i in range(n_cases):
        v, t = make_multiclass_case(shape=(size,) * 3, seed=i)
        xs.append(((v - v.mean()) / v.std())[None])
        ys.append(np.stack([t == lab for lab in PARITY_LABELS]))
    x = np.stack(xs).astype(np.float32)
    y = np.stack(ys).astype(np.float32)
    order = np.random.default_rng(0)
    return [(x[i], y[i]) for i in (order.choice(n_cases, batch,
                                                replace=False)
                                   for _ in range(steps))]


def parity_phase(torch, work: Path, smi: str) -> dict:
    """The max-pool tie gradients on the card against the CPU's (unfolded,
    folds (2, 2, 2) and (1, 2, 2); fp32 and bf16; bit for bit), then
    ``PARITY_STEPS`` bf16 steps of the multi-class recipe's model with the
    kernels on and off beside the card's fp32 steps: every step's loss
    within ``PARITY_LOSS_RTOL`` of the fp32 step's, the loss falling, the
    kernels-on launches exactly ``QUALITY_PER_FORWARD`` per step."""
    import dataclasses
    import functools

    import numpy as np

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.models.layers import max_pool_3d
    from fetal_mri_segmentation_tpu_torch.ops.fold import fold, pool_folded
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    # 1. max pooling at ties: the recipe's level-0 pool input (batch 3,
    # 16 channels of 40^3)
    x = _tie_input((PARITY_BATCH, PARITY_SIZE, PARITY_SIZE, PARITY_SIZE,
                    16))
    cot = np.random.default_rng(1).standard_normal(
        (PARITY_BATCH,) + (PARITY_SIZE // 2,) * 3 + (16,)).astype(
            np.float32)
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        for ff in (None, (2, 2, 2), (1, 2, 2)):
            pool = (max_pool_3d if ff is None
                    else functools.partial(pool_folded, factors=ff))
            got = {}
            for device in ("cpu", "cuda"):
                xt = torch.from_numpy(x).to(device, dtype)
                leaf = (xt if ff is None else fold(xt, ff)).requires_grad_()
                out = pool(leaf)
                (out.float() * torch.from_numpy(cot).to(device)
                 ).sum().backward()
                got[device] = (out.detach().cpu(), leaf.grad.cpu())
            for a, b in zip(got["cpu"], got["cuda"]):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"max pool {ff or 'unfolded'} {dtype}: the card's "
                        f"result is not the CPU's (max abs diff "
                        f"{(a.float() - b.float()).abs().max().item()})")
            g = got["cuda"][1].float()
            checked.append(f"{ff or 'unfolded'} {str(dtype)[6:]} "
                           f"({int((g != 0).sum())} of {g.numel()} "
                           f"gradient entries nonzero)")
    print("parity max-pool ties: the card's forward and gradient equal the "
          "CPU's bit for bit: " + "; ".join(checked), flush=True)

    # 2. bf16 steps of the multi-class recipe, kernels on and off, beside
    # fp32 steps from the same weights and batches
    base = Config(model_name="unet", depth=3, n_base_filters=8,
                  patch_shape=(PARITY_SIZE,) * 3,
                  image_shape=(PARITY_SIZE,) * 3,
                  n_labels=len(PARITY_LABELS), labels=PARITY_LABELS,
                  activation_name="sigmoid", batch_size=PARITY_BATCH,
                  augment=False, include_label_wise_dice_coefficients=True,
                  initial_learning_rate=5e-4, fold_level0="off",
                  use_pallas_conv=True, use_pallas_dec0=True)
    weights = from_flax(init_flax_like(base, seed=0))
    batches = [(torch.from_numpy(bx).cuda(), torch.from_numpy(by).cuda())
               for bx, by in _multiclass_batches()]

    def steps(cfg):
        model = build_model(cfg, "cuda")
        model.load_state_dict(weights)
        state = create_train_state(model, cfg)
        step = make_train_step(model, cfg)
        return [float(step(state, bx, by)["loss"]) for bx, by in batches]

    off = dict(use_pallas_conv=False, use_pallas_dec0=False)
    losses, launches = {}, {}
    for name, kw in (("fp32", dict(off, compute_dtype="float32")),
                     ("bf16 on", {}), ("bf16 off", off)):
        torch.backends.cudnn.allow_tf32 = name != "fp32"
        losses[name], launches[name] = _counted(
            torch, functools.partial(steps, dataclasses.replace(base, **kw)))
        torch.backends.cudnn.allow_tf32 = True
    want = {k: v * PARITY_STEPS for k, v in QUALITY_PER_FORWARD.items()}
    ref = np.asarray(losses["fp32"])
    worst = {}
    for name in ("bf16 on", "bf16 off"):
        rel = np.abs(np.asarray(losses[name]) - ref) / np.abs(ref)
        worst[name] = (float(rel.max()), int(rel.argmax()))
    print(f"parity {PARITY_STEPS} bf16 steps of the multi-class recipe "
          f"({PARITY_BATCH} x {PARITY_SIZE}^3): loss per step fp32 "
          + ", ".join(f"{v:.6g}" for v in losses["fp32"]) + "; "
          + "; ".join(f"{name} " + ", ".join(f"{v:.6g}" for v in losses[name])
                      + f" (largest relative distance from fp32 "
                      f"{worst[name][0]:.6g} at step {worst[name][1]})"
                      for name in worst)
          + f"; bound {PARITY_LOSS_RTOL:.6g} (3 x JAX's {PARITY_JAX_REL}); "
          f"launches {launches['bf16 on']} on, {launches['bf16 off']} off "
          f"({smi})", flush=True)
    for name, (rel, step) in worst.items():
        if not rel <= PARITY_LOSS_RTOL:
            raise AssertionError(f"parity {name}: step {step}'s loss "
                                 f"{rel} from fp32's > {PARITY_LOSS_RTOL}")
        if not losses[name][-1] < losses[name][0]:
            raise AssertionError(f"parity {name}: the loss did not fall")
    if launches["bf16 on"] != want or set(
            launches["bf16 off"].values()) != {0}:
        raise AssertionError(f"parity launches {launches}, not {want} / 0")
    return launches["bf16 on"]


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
    from fetal_mri_segmentation_tpu_torch.models import build_model, layers
    from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (
        instance_norm_act, instance_norm_act_backward)
    from fetal_mri_segmentation_tpu_torch.ops.keras_adam import keras_adam
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
            instance_norm_act.launches = 0
            p_on = counted(label, forwards(n),
                           lambda: pred["on"].predict_probabilities(data))
            launches[label]["instance_norm_act"] = instance_norm_act.launches
            if instance_norm_act.launches != NORM_LAUNCHES * n:
                raise AssertionError(
                    f"isensee {label}: fused norm launches "
                    f"{instance_norm_act.launches}, not {NORM_LAUNCHES * n}")
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
    norm_launches, adam_launches = {}, {}
    for name, cfg in (("on", config), ("off", config_off),
                      ("fp32", config_32)):
        cfg = dataclasses.replace(cfg, augment=False)
        model, state = fresh(cfg)
        step = make_train_step(
            model, cfg, generator=torch.Generator(device="cuda").manual_seed(0))
        want = (forwards(1, ISENSEE_PER_TRAIN) if name == "on"
                else dict.fromkeys(ISENSEE_PER_TRAIN, 0))
        # the fp32 reference in fp32 throughout (no TF32 in cuDNN), its
        # norms on the composite (autograd's backward); the bf16 steps'
        # 27 norms on the training Function: 54 forward launches, 81
        # backward
        torch.backends.cudnn.allow_tf32 = name != "fp32"
        saved = layers._kernel_device
        if name == "fp32":
            layers._kernel_device = lambda t: False
        instance_norm_act.launches = instance_norm_act_backward.launches = 0
        keras_adam.launches = keras_adam.leaves = 0
        try:
            metrics = counted(f"train step {name}", want,
                              lambda: step(state, x, y))
        finally:
            layers._kernel_device = saved
        norm_launches[name] = (instance_norm_act.launches,
                               instance_norm_act_backward.launches)
        launches[f"train step {name}"]["instance_norm_act"] = (
            instance_norm_act.launches)
        # A1: two launches a step for Isensee2017's 114 leaves
        adam_launches[name] = (keras_adam.launches, keras_adam.leaves)
        launches[f"train step {name}"]["keras_adam"] = keras_adam.launches
        torch.backends.cudnn.allow_tf32 = True
        losses[name] = float(metrics["loss"])
        grads[name] = {n: p.grad.float().clone()
                       for n, p in model.named_parameters()}
        # a conv bias before a norm: the norm takes away any per-channel
        # constant, so its gradient is 0 up to rounding
        before_norm = {f"{n}.conv.bias" for n, m in model.named_modules()
                       if isinstance(m, ConvBlock) and m.norm_key}
        del model, state, step

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
            r = max(_rel(g_on, g32, scale), _rel(g_off, g32, scale))
            if not r <= worst_bias[1]:
                worst_bias = (n, r)
            continue
        if not bool((g_on != 0).any()):
            zero.append(n)
        r_on, r_off = _rel(g_on, g32), _rel(g_off, g32)
        margin = r_on / max(2 * r_off, GRAD_REL_TOL)
        if worst[0] is None or not margin <= worst[1][0]:
            worst = (n, (margin, r_on, r_off))
        if not _rel(g_on, g_off) <= on_off[1]:
            on_off = (n, _rel(g_on, g_off))
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
    want_norm = {"on": NORM_TRAIN_LAUNCHES, "off": NORM_TRAIN_LAUNCHES,
                 "fp32": (0, 0)}
    print(f"isensee train step fused norm launches (forward, backward): "
          f"{norm_launches}", flush=True)
    if norm_launches != want_norm:
        raise AssertionError(f"isensee train step norm launches "
                             f"{norm_launches}, not {want_norm}")
    want_adam = dict.fromkeys(norm_launches, (2, 114))
    print(f"isensee train step A1 launches, leaves: {adam_launches}",
          flush=True)
    if adam_launches != want_adam:
        raise AssertionError(f"isensee train step A1 launches, leaves "
                             f"{adam_launches}, not {want_adam}")
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
    keras_adam.launches = 0
    state = counted("train_model", want, lambda: train_model(
        model, state, loop_cfg, tg, vg, n_t, n_v, seed=0, verbose=False))
    loop_s = time.perf_counter() - t
    launches["train_model"]["keras_adam"] = keras_adam.launches
    if keras_adam.launches != 2 * loop_cfg.n_epochs * n_t:
        raise AssertionError(f"isensee train_model: {keras_adam.launches} "
                             f"A1 launches, not 2 a train step")
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


# Scale phase: two runs of the same training differ only by what the card
# leaves undetermined (cuDNN's backward kernels sum with atomics; the hand
# kernels' forward is deterministic), so the cached run is held to the
# host-staged run by the spread two host-staged runs show, with this
# ceiling on the per-epoch loss and dice; the phase prints both. Measured
# on the H100 (NVIDIA H100 80GB HBM3, 700 W): see PERF.md section 6.
SCALE_METRIC_TOL = 1e-3
# A data-parallel step against the single-device step on the same global
# batch, from the same weights with plain SGD at learning rate 1 (the
# parameter change is minus the gradient): each parameter's change within
# GRAD_REL_TOL relative L2 (two ranks of 3 samples and one device of 6 pick
# other cuDNN algorithms and sum in another order), the loss and dice within
# LOSS_TOL, BatchNorm's buffers within this relative L2. With BatchNorm the
# two bf16 steps are not held to each other but each to an fp32 model, as
# behind every norm (NORM_PROB_TOL above): sync BatchNorm takes its moments
# as sums over a count, the single-device layer as means, the same numbers
# to 1e-7, and each norm rescales the one-ulp bf16 differences that follow
# (one rank over NCCL against the plain step: parameter changes up to 0.098
# apart, both as far from fp32; NVIDIA H100 80GB HBM3, 700 W). The
# data-parallel step may be no further from fp32 than twice the
# single-device step is, or than the tolerance.
DP_BUFFER_REL_TOL = 1e-3
RANK_TIMEOUT_S = 300.0


def _scale_config(work: Path, **kw):
    import dataclasses

    from fetal_mri_segmentation_tpu_torch.config import Config

    config = Config.load(str(ROOT / "configs" / "fetal_unet.json"))
    keys = dict(use_pallas_conv=True, use_pallas_dec0=True, n_epochs=2,
                initial_learning_rate=EXPERIMENT_LR, num_devices=1,
                data_file=str(work / "fetal_data"),
                training_file=str(work / "training_ids.pkl"),
                validation_file=str(work / "validation_ids.pkl"))
    keys.update(kw)
    return dataclasses.replace(config, **keys)


def _dp_step_check(torch, mesh, label: str, make_step=None,
                   phase: str = "scale") -> dict:
    """One data-parallel step over ``mesh`` against the single-device step
    on the same global batch of 6, from the same weights, kernels on, with
    and without BatchNorm; exact launch counts of the data-parallel step.
    Every rank runs both and raises on a difference. ``make_step``: the
    mesh's step factory (``make_dp_train_step`` by default; the spatial
    phase passes ``make_gspmd_train_step``), called as ``(model, config,
    mesh)`` and stepped with the global batch."""
    import dataclasses

    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
        make_dp_train_step)
    from fetal_mri_segmentation_tpu_torch.training.state import TrainState
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    make_step = make_step or make_dp_train_step
    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)
    out = {}
    for bn in (False, True):
        cfg = dataclasses.replace(
            _scale_config(Path(".")), augment=False, batch_normalization=bn)
        weights = from_flax(init_flax_like(cfg, seed=0))
        x_np, y_np = train_batch(cfg)
        x = torch.from_numpy(x_np).to(mesh.device)
        y = torch.from_numpy(y_np).to(mesh.device)
        results = {}
        for kind in ("dp", "one") + (("fp32",) if bn else ()):
            kcfg = cfg if kind != "fp32" else dataclasses.replace(
                cfg, use_pallas_conv=False, use_pallas_dec0=False,
                compute_dtype="float32")
            torch.backends.cudnn.allow_tf32 = kind != "fp32"
            model = build_model(kcfg, mesh.device)
            model.load_state_dict(weights)
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            before_norm = {f"{n}.conv.bias"
                           for n, m in model.named_modules()
                           if isinstance(m, ConvBlock) and m.norm_key}
            state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                      lr=1.0))
            step = (make_step(model, kcfg, mesh) if kind == "dp"
                    else make_train_step(model, kcfg))
            for fn in counters:
                fn.launches = 0
            metrics = step(state, x, y, cfg.batch_size)
            torch.cuda.synchronize()
            torch.backends.cudnn.allow_tf32 = True
            results[kind] = dict(
                launches={fn.__name__: fn.launches for fn in counters},
                loss=float(metrics["loss"]), dice=float(metrics["dice"]),
                change={n: (p.detach() - before[n]).float()
                        for n, p in model.named_parameters()},
                buffers={n: b.detach().float().clone()
                         for n, b in model.named_buffers()})
            del model, state, step
            torch.cuda.empty_cache()
        dp, one = results["dp"], results["one"]
        ref = results.get("fp32", one)

        def rel(a, b, scale=None):
            return ((a - b).norm() / (b if scale is None else scale
                                      ).norm().clamp_min(1e-30)).item()

        def margins(kind, tol):
            """Per tensor: (how far the data-parallel step is from the
            reference over what it may be, both distances, the name). The
            reference is the single-device step, or with BatchNorm the fp32
            model, from which the single-device bf16 step has a distance of
            its own. A conv bias before a norm has a zero gradient up to
            rounding (the norm takes away a per-channel constant): its
            change is held to the scale of its block's weight's change."""
            rows = []
            for n, t in dp[kind].items():
                scale = (ref["change"][n[:-len("bias")] + "weight"]
                         if kind == "change" and n in before_norm else None)
                r_dp = rel(t, ref[kind][n], scale)
                r_one = rel(one[kind][n], ref[kind][n], scale)
                rows.append((r_dp / max(2 * r_one, tol), r_dp, r_one, n))
            return sorted(rows, reverse=True) or [(0.0, 0.0, 0.0, "none")]

        ranked = margins("change", GRAD_REL_TOL)
        worst, worst_buffer = ranked[0], margins("buffers",
                                                 DP_BUFFER_REL_TOL)[0]
        out[f"batchnorm={bn}"] = dict(
            launches=dp["launches"], loss=dp["loss"], dice=dp["dice"],
            loss_diff=abs(dp["loss"] - one["loss"]),
            dice_diff=abs(dp["dice"] - one["dice"]),
            worst_change=worst, worst_buffer=worst_buffer)
        against = ("the fp32 model (the single-device bf16 step's distance "
                   "beside it)" if bn else "the single-device step")
        print(f"{phase} {label} rank {mesh.rank} of {mesh.size}, batchnorm "
              f"{bn}: loss {dp['loss']:.6g} against the single-device "
              f"step's {one['loss']:.6g} (tol {LOSS_TOL}), dice |diff| "
              f"{abs(dp['dice'] - one['dice']):.6g}; relative L2 of each "
              f"parameter's change against {against}, the three nearest "
              f"their bound max(2 x the single-device distance, "
              f"{GRAD_REL_TOL}): " + ", ".join(
                  f"{n} {r_dp:.6g} ({r_one:.6g})"
                  for _, r_dp, r_one, n in ranked[:3])
              + f"; the BatchNorm buffer nearest its bound max(2 x the "
              f"single-device distance, {DP_BUFFER_REL_TOL}): "
              f"{worst_buffer[3]} {worst_buffer[1]:.6g} "
              f"({worst_buffer[2]:.6g}); launches {dp['launches']}",
              flush=True)
        if dp["launches"] != PER_FORWARD or one["launches"] != PER_FORWARD:
            raise AssertionError(f"{label}: launches {dp['launches']} and "
                                 f"{one['launches']}, not {PER_FORWARD}")
        if not (abs(dp["loss"] - one["loss"]) <= LOSS_TOL
                and abs(dp["dice"] - one["dice"]) <= LOSS_TOL
                and worst[0] <= 1.0 and worst_buffer[0] <= 1.0):
            raise AssertionError(f"{label}, batchnorm {bn}: the "
                                 "data-parallel step differs from the "
                                 f"single-device step: {out}")
        if bn and not dp["buffers"]:
            raise AssertionError("no BatchNorm buffers in the model")
    return out


def _scale_rank(local_rank: int, world: int, port: int, out_dir: str) -> None:
    """One of the ranks that share the card (over gloo) or own one each
    (NCCL, where there are enough cards): the data-parallel step check."""
    import torch

    from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
        make_mesh)
    from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
        default_backend, initialize_distributed, rank_environment,
        shutdown_distributed)

    os.environ.update(rank_environment(local_rank, world, port))
    initialize_distributed(device="cuda", share_devices=True,
                           timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = make_mesh(world, device="cuda", share_devices=True)
        backend = default_backend("cuda")
        result = _dp_step_check(torch, mesh, f"{world} ranks over {backend}")
        result["backend"] = backend
        with open(Path(out_dir) / f"rank{local_rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        shutdown_distributed()


def scale_phase(torch, work: Path, smi: str) -> dict:
    """Training at scale (``configs/fetal_unet.json`` at full width, both
    kernel switches on, six 160x160x110 cases): the device case cache
    against host staging through ``train.main``, one batch bit for bit, a
    partial cache (the epoch's patches, an interrupted and resumed run),
    what the cache costs and buys, then data-parallel training: one rank
    over NCCL against the plain step, two ranks against one, and
    ``train.main`` on two ranks with the cache."""
    import collections
    import csv
    import dataclasses
    import hashlib

    import numpy as np

    from fetal_mri_segmentation_tpu_torch import train
    from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops
    from fetal_mri_segmentation_tpu_torch.ops.patches import (
        get_patch_from_3d_data)
    from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
        make_mesh)
    from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
        free_port, initialize_distributed, rank_environment, run_ranks,
        shutdown_distributed)
    from fetal_mri_segmentation_tpu_torch.pipeline import device_cache as dc
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        create_patch_index_list, data_generator,
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu_torch.training.checkpoint import (
        CheckpointIO)
    from fetal_mri_segmentation_tpu_torch.training.loop import train_model
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        pad_batch)
    from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    torch.backends.cudnn.allow_tf32 = True  # as the train phase
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)
    launches = {}

    def zero_counts():
        for fn in counters:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counters}

    def log_rows(path):
        with open(path) as f:
            # a resumed run logs its replayed epochs again: the last wins
            return {r["epoch"]: r for r in csv.DictReader(f)}

    def run_config(tag, **kw):
        (work / tag).mkdir(exist_ok=True)
        return _scale_config(
            work, model_file=str(work / tag / "model.ckpt"),
            training_log=str(work / tag / "training.log"), **kw)

    # 1. the cache against host staging, through train.main: the same seed
    # and weights, two epochs each; host staging twice for the spread
    write_cases(work / "cases", n=6)
    runs = {}
    for tag, knob in (("host", "off"), ("host again", "off"),
                      ("cached", "on")):
        config = run_config(tag.replace(" ", "_"), device_case_cache=knob)
        zero_counts()
        t0 = time.perf_counter()
        state = train.main(config, str(work / "cases"), seed=0,
                           device="cuda", verbose=tag == "cached")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rows = log_rows(config.training_log)
        runs[tag] = dict(rows=rows, seconds=seconds, steps=state.step)
        launches[f"train.main {tag}"] = counts()
        del state
        torch.cuda.empty_cache()
    with open_data_file(config.data_file) as f:
        _, n_t, _, n_v = get_training_and_validation_generators(
            f, batch_size=config.batch_size, n_labels=config.n_labels,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=config.skip_blank, seed=0)
    want = {k: n * config.n_epochs * (n_t + n_v)
            for k, n in PER_FORWARD.items()}
    keys = ("loss", "dice_coefficient", "val_loss", "val_dice_coefficient")

    def spread(a, b):
        return max(abs(float(runs[a]["rows"][e][k])
                       - float(runs[b]["rows"][e][k]))
                   for e in ("0", "1") for k in keys)

    host_spread, cached_diff = spread("host", "host again"), spread(
        "host", "cached")
    for tag, run in runs.items():
        print(f"scale train.main {tag}: {n_t} + {n_v} steps per epoch; "
              + "; ".join(
                  f"epoch {e} loss {float(r['loss']):.8g} dice "
                  f"{float(r['dice_coefficient']):.8g} val_loss "
                  f"{float(r['val_loss']):.8g} "
                  f"{float(r['patches_per_sec']):.6g} patches/s "
                  f"{float(r['epoch_time_sec']):.4f} s"
                  for e, r in sorted(run["rows"].items()))
              + f"; {run['seconds']:.4f} s in all; launches "
              f"{launches[f'train.main {tag}']}", flush=True)
        if launches[f"train.main {tag}"] != want or run["steps"] != 2 * n_t:
            raise AssertionError(f"train.main {tag} launched "
                                 f"{launches[f'train.main {tag}']}, not "
                                 f"{want}")
    print(f"scale cache against host staging: largest |difference| of a "
          f"per-epoch loss or dice {cached_diff:.6g}; two host-staged runs "
          f"differ by {host_spread:.6g}; tol {SCALE_METRIC_TOL}", flush=True)
    if not max(cached_diff, host_spread) <= SCALE_METRIC_TOL:
        raise AssertionError(f"cached against host {cached_diff}, host "
                             f"against host {host_spread}")

    # 2. one batch, gathered on the card and staged from the host: x and y
    # bit for bit; what the cache costs (seconds, bytes) and the gather's
    # time; the step's peak memory with the cache resident
    config = run_config("cached", device_case_cache="on")
    data_file = open_data_file(config.data_file)
    training = [int(i) for i in pickle_load(config.training_file)]
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cache, tgen, _ = dc.maybe_build_device_cache(
        data_file, config, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    allocated_after = torch.cuda.memory_allocated()
    host_gen = data_generator(
        data_file, training, batch_size=config.batch_size,
        n_labels=config.n_labels, labels=config.labels,
        patch_shape=config.patch_shape,
        patch_start_offset=config.training_patch_start_offset,
        skip_blank=config.skip_blank, seed=0)
    gather_convert = dc._make_gather_convert(config, cache.margin_lo)
    for _ in range(n_t):
        xh, yh, n_valid = pad_batch(*next(host_gen), config.batch_size)
        rows, corners, n_valid_c = next(tgen)
        idx = torch.from_numpy(np.concatenate([rows[:, None], corners], 1)
                               ).cuda()
        xc, yc = gather_convert(cache.data_stack, cache.truth_stack,
                                idx[:, 0], idx[:, 1:], n_valid_c)
        xh = torch.from_numpy(xh).to(torch.bfloat16).cuda()
        yh = torch.from_numpy(yh.astype(np.uint8)).cuda().float()
        if n_valid != n_valid_c or xc.dtype != torch.bfloat16 or not (
                torch.equal(xc, xh) and torch.equal(yc, yh)):
            raise AssertionError("a gathered batch differs from the "
                                 "host-staged batch")
    gather_ms = time_ms(torch, lambda: gather_convert(
        cache.data_stack, cache.truth_stack, idx[:, 0], idx[:, 1:], n_valid))
    host_bytes = xh.numel() * 2 + yh.numel()  # bf16 x and uint8 y
    idx_bytes = idx.numel() * idx.element_size()
    model = build_model(config, "cuda")
    model.load_state_dict(from_flax(init_flax_like(config, seed=0)))
    state = create_train_state(model, config)
    step = dc.make_cached_train_step(
        model, config, cache.margin_lo,
        generator=torch.Generator(device="cuda").manual_seed(0))

    def cached_step():
        return step(state, cache.data_stack, cache.truth_stack, idx[:, 0],
                    idx[:, 1:], n_valid)

    cached_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, cached_step)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    epoch = {tag: runs[tag]["rows"]["1"] for tag in ("host", "cached")}
    print(f"scale what the cache buys ({smi}): built in {build_s:.4f} s, "
          f"{cache.nbytes} bytes on the card ({len(cache.row_of)} cases "
          f"padded to {tuple(cache.data_stack.shape[2:])}, bf16 data and "
          f"uint8 truth; memory_allocated {allocated_before} before, "
          f"{allocated_after} after); bytes sent to the card per step: "
          f"{idx_bytes} cached, {host_bytes} host-staged; the gather and "
          f"label conversion {gather_ms:.6g} ms per batch of "
          f"{config.batch_size}; a cached train step {step_ms:.6g} ms; "
          f"second epoch through train_model: "
          f"{float(epoch['cached']['patches_per_sec']):.6g} patches/s "
          f"cached ({float(epoch['cached']['epoch_time_sec']):.4f} s) "
          f"against {float(epoch['host']['patches_per_sec']):.6g} "
          f"host-staged ({float(epoch['host']['epoch_time_sec']):.4f} s), "
          f"{n_t} steps of {step_ms:.6g} ms being "
          f"{n_t * step_ms / 1e3:.4f} s on the card; peak memory of the "
          f"step with the cache resident {peak} bytes "
          f"({peak / 2**30:.6g} GiB; {(peak - cache.nbytes) / 2**30:.6g} "
          f"GiB without the cache's bytes; the allocator holds {reserved} "
          f"bytes reserved); hbm_budget_bytes now "
          f"{dc.hbm_budget_bytes('cuda')} with a reserve of "
          f"{dc.HBM_STEP_RESERVE_BYTES}", flush=True)
    if cache.nbytes != dc.estimate_cache_bytes(
            data_file, len(cache.row_of), cache.margin_lo,
            tuple(p - s - lo for p, s, lo in zip(
                cache.data_stack.shape[2:], config.image_shape,
                cache.margin_lo))) or not (
            allocated_after - allocated_before >= cache.nbytes):
        raise AssertionError(f"cache bytes {cache.nbytes}, allocated "
                             f"{allocated_after - allocated_before}")
    if peak - cache.nbytes > dc.HBM_STEP_RESERVE_BYTES:
        raise AssertionError(f"the step's peak {peak - cache.nbytes} "
                             f"exceeds HBM_STEP_RESERVE_BYTES")
    del model, state, step, cache, tgen
    torch.cuda.empty_cache()

    # 3. a partial cache: half of the dataset's bytes as the budget
    est = dc.estimate_cache_bytes(
        data_file, 6, *dc.plan_margins(
            config.image_shape, config.patch_shape,
            config.validation_patch_overlap,
            config.training_patch_start_offset))
    budget = int(est * 0.55)

    def partial_run(tag, n_epochs, resume=False):
        cfg = run_config(tag, device_case_cache="auto", n_epochs=n_epochs)
        io = CheckpointIO(cfg.model_file)
        start = (io.peek_epoch() or 0) if resume else 0
        order = io.peek_data_order() if resume else None
        if resume and (start != 1 or (order or {}).get("mode") != "partial"):
            raise AssertionError(f"resume from epoch {start}, order {order}")
        built = dc.maybe_build_device_cache(
            data_file, cfg, seed=0, budget_bytes=budget, device="cuda",
            train_skip_batches=start * n_t, val_skip_batches=start * n_v,
            resume_data_order=order, verbose=tag == "partial")
        if built is None or not built[0].partial:
            raise AssertionError("the budget did not give a partial cache")
        cache, tg, vg = built
        model = build_model(cfg, "cuda")
        model.load_state_dict(from_flax(init_flax_like(cfg, seed=0)))
        zero_counts()
        state = train_model(model, create_train_state(model, cfg), cfg, tg,
                            vg, n_t, n_v, seed=0, device_cache=cache,
                            verbose=False)
        torch.cuda.synchronize()
        ran = n_epochs - start
        got, want = counts(), {k: n * ran * (n_t + n_v)
                               for k, n in PER_FORWARD.items()}
        if got != want or state.step != n_epochs * n_t:
            raise AssertionError(f"{tag}: launches {got}, not {want}")
        launches[f"partial {tag}{' resumed' if resume else ''}"] = got
        return cfg, cache.resident_cases

    cfg_whole, resident = partial_run("partial", 2)
    partial_run("partial_interrupted", 1)
    cfg_resumed, resident_again = partial_run("partial_interrupted", 2,
                                              resume=True)
    whole, resumed = (log_rows(c.training_log)
                      for c in (cfg_whole, cfg_resumed))
    resume_diff = max(abs(float(whole[e][k]) - float(resumed[e][k]))
                      for e in ("0", "1") for k in keys)
    # the first generator epoch's patches, host pipeline against partial
    rng = np.random.default_rng((0, 0))
    epoch_list = create_patch_index_list(
        training, tuple(config.image_shape), config.patch_shape, 0,
        config.training_patch_start_offset, rng)
    kept = sum(bool(np.any(get_patch_from_3d_data(
        data_file.root.truth[c], config.patch_shape, corner)))
        for c, corner in epoch_list) if config.skip_blank else len(epoch_list)
    n_batches = -(-kept // config.batch_size)
    gen_kw = dict(batch_size=config.batch_size,
                  patch_shape=config.patch_shape,
                  patch_start_offset=config.training_patch_start_offset,
                  skip_blank=config.skip_blank, seed=0)
    host_gen = data_generator(data_file, training, n_labels=config.n_labels,
                              labels=config.labels, **gen_kw)
    part_gen = dc.partial_index_batch_generator(
        data_file, training, {c: r for r, c in enumerate(resident)},
        n_labels=config.n_labels, labels=config.labels, **gen_kw)

    def digest(patch):
        return hashlib.sha1(np.ascontiguousarray(
            patch, dtype=np.float32).tobytes()).hexdigest()

    host_set, part_set = collections.Counter(), collections.Counter()
    kinds = collections.Counter()
    for _ in range(n_batches):
        host_set.update(digest(p) for p in next(host_gen)[0])
        kind, a, b, n_valid = next(part_gen)
        kinds[kind] += n_valid
        if kind == "host":
            part_set.update(digest(p) for p in a[:n_valid])
        else:
            part_set.update(
                digest(get_patch_from_3d_data(
                    np.asarray(data_file.root.data[resident[int(r)]]),
                    config.patch_shape, c))
                for r, c in zip(a[:n_valid], b[:n_valid]))
    print(f"scale partial cache: budget {budget} of {est} bytes, cases "
          f"{resident} of 6 resident; the first epoch's {kept} patches in "
          f"{n_batches} batches: {dict(kinds)} by kind, the multiset of "
          f"patches equal to the host pipeline's: {host_set == part_set}; "
          f"2 epochs uninterrupted against 1 + resumed: largest "
          f"|difference| of a per-epoch loss or dice {resume_diff:.6g} "
          f"<= tol {SCALE_METRIC_TOL}", flush=True)
    if host_set != part_set or sum(host_set.values()) != kept or not (
            kinds["idx"] and kinds["host"]):
        raise AssertionError(f"partial epoch: {dict(kinds)}, {kept} kept")
    if resident != resident_again or not resume_diff <= SCALE_METRIC_TOL:
        raise AssertionError(f"resumed partial run: {resume_diff}, resident "
                             f"{resident} then {resident_again}")
    data_file.close()

    # 4. data parallel. One rank that joins an NCCL group as a launcher
    # would have it, against the plain step
    launcher = rank_environment(0, 1, free_port())
    os.environ.update(launcher)
    try:
        initialize_distributed(device="cuda")
        mesh = make_mesh(1, device="cuda")
        if mesh.group is None or torch.distributed.get_backend() != "nccl":
            raise AssertionError("no NCCL group of one rank")
        one_rank = _dp_step_check(torch, mesh, "1 rank over nccl")
    finally:
        shutdown_distributed()
        for key in launcher:
            os.environ.pop(key, None)
    launches["dp step, 1 rank (nccl)"] = one_rank["batchnorm=False"][
        "launches"]
    # two ranks: on one card they share it over gloo (NCCL refuses two ranks
    # on one device), on two or more cards each takes its own over NCCL
    (work / "ranks").mkdir()
    t0 = time.perf_counter()
    run_ranks(_scale_rank, 2, (2, free_port(), str(work / "ranks")),
              RANK_TIMEOUT_S)
    ranks = [json.loads((work / "ranks" / f"rank{r}.json").read_text())
             for r in range(2)]
    for r, result in enumerate(ranks):
        launches[f"dp step, 2 ranks ({result['backend']}), rank {r}"] = \
            result["batchnorm=True"]["launches"]
    if any(ranks[0][k]["loss"] != ranks[1][k]["loss"]
           for k in ("batchnorm=False", "batchnorm=True")):
        raise AssertionError(f"the ranks' losses differ: {ranks}")
    print(f"scale 2 ranks over {ranks[0]['backend']} on "
          f"{torch.cuda.device_count()} card(s): both ranks held the "
          f"data-parallel step to the single-device step, with and without "
          f"BatchNorm, in {time.perf_counter() - t0:.4f} s", flush=True)
    # train.main starts its two ranks itself, the cache on
    config = run_config("two_ranks", device_case_cache="on", num_devices=2)
    t0 = time.perf_counter()
    train.main(config, str(work / "cases"), seed=0, device="cuda",
               share_devices=True, rank_timeout_s=RANK_TIMEOUT_S)
    rows = log_rows(config.training_log)
    print(f"scale train.main on 2 ranks, the cache on every rank: "
          + "; ".join(f"epoch {e} loss {float(r['loss']):.6g} val_loss "
                      f"{float(r['val_loss']):.6g} "
                      f"{float(r['patches_per_sec']):.6g} patches/s"
                      for e, r in sorted(rows.items()))
          + f"; {time.perf_counter() - t0:.4f} s in all", flush=True)
    if sorted(rows) != ["0", "1"] or not all(
            np.isfinite(float(r[k])) for r in rows.values()
            for k in keys) or CheckpointIO(
                config.model_file).peek_epoch() not in (1, 2):
        raise AssertionError(f"two-rank training log {rows}")
    return launches


# Spatial phase: the depth-sharded and the patch-grid-sharded paths on
# ranks that share the card over gloo (NCCL on a card each where there are
# more cards). A rank's forward on its halo'd slab computes every voxel of
# its slab with the same kernels as the whole volume's forward, so the
# predictors are held to the one-device predictors by PROB_TOL and the
# train steps to the single-device step as the scale phase holds its
# data-parallel step (GRAD_REL_TOL; with BatchNorm each against fp32).
SPATIAL_RANK_TIMEOUT_S = 600.0


def _spatial_config(work: Path, **kw):
    return _scale_config(work, model_file=str(work / "model.ckpt"),
                         training_log=str(work / "training.log"), **kw)


def _isensee_config():
    """``configs/fetal_isensee.json`` with both kernel switches on."""
    import dataclasses

    from fetal_mri_segmentation_tpu_torch.config import Config

    return dataclasses.replace(
        Config.load(str(ROOT / "configs" / "fetal_isensee.json")),
        use_pallas_conv=True, use_pallas_dec0=True)


# The spatial phase's folded config: Isensee2017 with level 0 folded (2, 2,
# 2) in the parity formulation, as tests/test_torch_fold.py holds it on
# thread-ranks. On a slab it runs the halo of one folded row, the stride-2
# entry's zero row and the folded InstanceNorm with its moments summed over
# the ranks; its folded level-0 convs are stock convs (6 / 5 / 0 launches
# per forward).
SPATIAL_FOLD = ((2, 2, 2), "parity")


def _isensee_fold_config():
    """``_isensee_config()`` with level 0 folded as ``SPATIAL_FOLD``."""
    import dataclasses

    return dataclasses.replace(_isensee_config(),
                               fold_level0=SPATIAL_FOLD[0],
                               fold_formulation=SPATIAL_FOLD[1])


def _counted(torch, run):
    """``(run(), launches)``: the kernels' counts zeroed just before the
    run and read just after it."""
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops

    counters = (conv_ops.conv3x3, conv_ops.conv3x3_flat,
                dec_ops.up_concat_conv3x3_kernel)
    for fn in counters:
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {fn.__name__: fn.launches for fn in counters}


def _peak_bytes(torch, run) -> int:
    """The most bytes ``run`` held allocated on this process's card above
    what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _step_peak(torch, mesh, work: Path) -> int:
    """The peak bytes of one train step on the config's batch of 6 (64^3,
    kernels on, no augmentation) after a first step: the GSPMD step on
    ``mesh``, or the single-device step where it is None."""
    import dataclasses

    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
        make_gspmd_train_step)
    from fetal_mri_segmentation_tpu_torch.training.state import TrainState
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)

    config = dataclasses.replace(_spatial_config(work), augment=False)
    device = mesh.device if mesh is not None else "cuda"
    model = build_model(config, device)
    model.load_state_dict(torch.load(work / "weights.pt"))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    step = (make_train_step(model, config) if mesh is None
            else make_gspmd_train_step(model, config, mesh))
    x_np, y_np = train_batch(config)
    x, y = torch.from_numpy(x_np).to(device), torch.from_numpy(y_np).to(device)
    step(state, x, y)
    peak = _peak_bytes(torch, lambda: step(state, x, y))
    del model, state, step
    torch.cuda.empty_cache()
    return peak


def _spatial_rank(local_rank: int, world: int, ports: list,
                  work: str) -> None:
    """One of the ranks of a 1 x ``world`` spatial mesh (and of the data
    mesh over the same ranks): the spatial and the sharded predictor on the
    three volumes against the parent's one-device probabilities, the GSPMD
    train step against the single-device step, peak memory; then the entry
    points under a launcher's environment, each on its own rendezvous
    port. Writes ``spatial_rank<r>.json``."""
    import numpy as np
    import torch

    from fetal_mri_segmentation_tpu_torch import predict as entry, train
    from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
        SlidingWindowPredictor)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.parallel.data_parallel import (
        make_mesh)
    from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
        default_backend, initialize_distributed, make_sharded_predictor,
        rank_environment, shutdown_distributed)
    from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
        make_gspmd_train_step, make_hybrid_mesh, make_spatial_predictor)

    work = Path(work)
    os.environ.update(rank_environment(local_rank, world, ports[0]))
    initialize_distributed(device="cuda", share_devices=True,
                           timeout_s=SPATIAL_RANK_TIMEOUT_S)
    result = {}
    try:
        backend = default_backend("cuda")
        config = _spatial_config(work)
        mesh = make_hybrid_mesh(1, world, device="cuda", share_devices=True)
        data_mesh = make_mesh(world, device="cuda", share_devices=True)
        model = build_model(config, mesh.device)
        model.load_state_dict(torch.load(work / "weights.pt"))
        reference = torch.load(work / "reference.pt")
        volumes = [np.load(work / f"volume{i}.npy") for i in range(3)]
        reshard = [np.load(work / "volume_reshard.npy")]
        sharded = make_sharded_predictor(SlidingWindowPredictor(
            model, config, config.image_shape,
            overlap=config.validation_patch_overlap), data_mesh)
        isensee = build_model(_isensee_config(), mesh.device)
        isensee.load_state_dict(torch.load(work / "isensee_weights.pt"))
        isensee_fold = build_model(_isensee_fold_config(), mesh.device)
        isensee_fold.load_state_dict(torch.load(work / "isensee_weights.pt"))
        for tag, predictor, vols, forwards, tol in (
                ("spatial", make_spatial_predictor(model, config, mesh),
                 volumes, 1, PROB_TOL),
                ("sharded", sharded, volumes, len(sharded.share), PROB_TOL),
                ("isensee", make_spatial_predictor(
                    isensee, _isensee_config(), mesh), volumes, 1,
                 NORM_PROB_TOL),
                ("isensee_fold", make_spatial_predictor(
                    isensee_fold, _isensee_fold_config(), mesh), volumes, 1,
                 NORM_PROB_TOL),
                # slabs of 60 rows go odd at level 2: gathered whole there
                ("reshard", make_spatial_predictor(model, config, mesh),
                 reshard, 1, PROB_TOL)):
            t0 = time.perf_counter()
            probs, launches = _counted(torch, lambda: [
                predictor.predict_probabilities(v) for v in vols])
            seconds = (time.perf_counter() - t0) / len(vols)
            diff = flips = far = diff_fp32 = 0
            for i, (p, q) in enumerate(zip(probs, reference[tag])):
                p = p.cpu()
                diff = max(diff, (p - q).abs().max().item())
                if f"{tag}_fp32" in reference:
                    diff_fp32 = max(diff_fp32, (
                        p - reference[f"{tag}_fp32"][i]).abs().max().item())
                flipped = (p > 0.5) != (q > 0.5)
                flips += int(flipped.sum())
                far += int((flipped & ((q - 0.5).abs() >= tol)).sum())
            result[tag] = dict(launches=launches,
                               forwards=forwards * len(vols), diff=diff,
                               flips=flips, far_flips=far, seconds=seconds,
                               tol=tol, diff_fp32=diff_fp32,
                               cases=len(vols), shape=vols[0].shape[1:])
            if tag == "spatial":
                result["spatial_peak"] = _peak_bytes(
                    torch, lambda: predictor.predict_probabilities(
                        volumes[0]))
            del probs
        del model, sharded, isensee, isensee_fold
        torch.cuda.empty_cache()
        result["step"] = _dp_step_check(
            torch, mesh, f"1 x {world} spatial mesh over {backend}",
            make_step=make_gspmd_train_step, phase="spatial")
        result["step_peak"] = _step_peak(torch, mesh, work)
        result["backend"] = backend
    finally:
        shutdown_distributed()
    # the entry points as a launcher starts them, each on its own port:
    # train.main on the spatial mesh, then predict.main over the
    # validation split from its checkpoint on each mesh
    entries = {}
    runs = (
        ("train.main spatial", lambda: train.main(
            _spatial_config(work, num_devices=world, spatial_devices=world),
            str(work / "cases"), seed=0, device="cuda", share_devices=True,
            verbose=local_rank == 0).step),
        ("predict.main spatial", lambda: entry.main(
            config, output_dir=str(work / "pred_spatial"), device="cuda",
            verbose=False, prob_map=True, spatial_devices=world,
            share_devices=True)),
        ("predict.main sharded", lambda: entry.main(
            config, output_dir=str(work / "pred_sharded"), device="cuda",
            verbose=False, prob_map=True, num_devices=world,
            share_devices=True)))
    for port, (name, run) in zip(ports[1:], runs):
        os.environ["MASTER_PORT"] = str(port)
        t0 = time.perf_counter()
        out, launches = _counted(torch, run)
        entries[name] = dict(launches=launches, result=out,
                             seconds=time.perf_counter() - t0)
    result["entries"] = entries
    with open(work / f"spatial_rank{local_rank}.json", "w") as f:
        json.dump(result, f)


def _hybrid_rank(local_rank: int, world: int, port: int, work: str) -> None:
    """One rank of a (world / SPATIAL_RANKS) x SPATIAL_RANKS hybrid mesh:
    the GSPMD train step against the single-device step, and its peak
    memory. Writes ``hybrid_rank<r>.json``."""
    import torch

    from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
        default_backend, initialize_distributed, rank_environment,
        shutdown_distributed)
    from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
        make_gspmd_train_step, make_hybrid_mesh)

    work = Path(work)
    os.environ.update(rank_environment(local_rank, world, port))
    initialize_distributed(device="cuda", share_devices=True,
                           timeout_s=SPATIAL_RANK_TIMEOUT_S)
    try:
        n_data = world // SPATIAL_RANKS
        mesh = make_hybrid_mesh(n_data, SPATIAL_RANKS, device="cuda",
                                share_devices=True)
        backend = default_backend("cuda")
        result = dict(backend=backend, step=_dp_step_check(
            torch, mesh, f"{n_data} x {SPATIAL_RANKS} hybrid mesh over "
            f"{backend}", make_step=make_gspmd_train_step,
            phase="spatial"), step_peak=_step_peak(torch, mesh, work))
        with open(work / f"hybrid_rank{local_rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        shutdown_distributed()


def spatial_phase(torch, work: Path, smi: str) -> dict:
    """Multi-device inference and depth-axis spatial sharding
    (``configs/fetal_unet.json`` at full width, both kernel switches on):
    the one-device references, the collectives on CUDA tensors over NCCL
    (one rank), then two ranks (the spatial predictor and the patch-grid
    sharded predictor on three 128^3 cases, the 1 x 2 GSPMD train step,
    peak memory, ``train.main`` and ``predict.main`` on both meshes) and
    four ranks (the 2 x 2 GSPMD train step). Launches exactly 6 / 4 / 3 per
    forward on every rank of every counted run."""
    import csv
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from fetal_mri_segmentation_tpu_torch import predict as entry
    from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        preprocess_case)
    from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
        SlidingWindowPredictor)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.parallel.collectives import (
        all_gather_cat, halo_exchange)
    from fetal_mri_segmentation_tpu_torch.parallel.distributed import (
        free_port, initialize_distributed, join_ranks, rank_environment,
        run_ranks, shutdown_distributed, start_ranks)
    from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
        make_direct_predictor)
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    torch.backends.cudnn.allow_tf32 = True  # as the train phase
    torch.backends.cuda.matmul.allow_tf32 = False
    config = _spatial_config(work)
    torch.save(from_flax(init_flax_like(config, seed=0)), work / "weights.pt")
    inputs = write_cases(work / "cases", n=6)
    volumes = []
    for i, path in enumerate(inputs[:3]):
        volumes.append(preprocess_case(path, config)[0])
        np.save(work / f"volume{i}.npy", volumes[-1])
    # the reshard case: the middle 120 rows of the first volume
    cut = (volumes[0].shape[1] - RESHARD_VOLUME[0]) // 2
    reshard = np.ascontiguousarray(
        volumes[0][:, cut:cut + RESHARD_VOLUME[0]])
    np.save(work / "volume_reshard.npy", reshard)

    # 1. one device: the references and the peaks
    model = build_model(config, "cuda")
    model.load_state_dict(torch.load(work / "weights.pt"))
    direct = make_direct_predictor(model, config)
    sliding = SlidingWindowPredictor(model, config, config.image_shape,
                                     overlap=config.validation_patch_overlap)
    # Isensee2017 behind its norms is held to an fp32 model too (as in the
    # isensee phase): its spatial predictor may be no further from it than
    # twice the direct predictor is, or PROB_TOL
    weights = from_flax(init_flax_like(_isensee_config(), seed=0))
    torch.save(weights, work / "isensee_weights.pt")
    isensee = {}
    for kind, cfg in (("isensee", _isensee_config()), (
            "isensee_fp32", dataclasses.replace(
                _isensee_config(), use_pallas_conv=False,
                use_pallas_dec0=False, compute_dtype="float32")),
            ("isensee_fold", _isensee_fold_config())):
        isensee[kind] = make_direct_predictor(build_model(cfg, "cuda"), cfg)
        isensee[kind].model.load_state_dict(weights)
    torch.backends.cudnn.allow_tf32 = False  # the fp32 model stays fp32
    reference = {tag: [p.predict_probabilities(v).cpu() for v in volumes]
                 for tag, p in (("spatial", direct), ("sharded", sliding),
                                *isensee.items())}
    reference["reshard"] = [direct.predict_probabilities(reshard).cpu()]
    torch.backends.cudnn.allow_tf32 = True
    torch.save(reference, work / "reference.pt")
    isensee_to_fp32 = max(
        (p - q).abs().max().item() for p, q in zip(
            reference["isensee"], reference["isensee_fp32"]))
    del isensee
    direct_peak = _peak_bytes(torch, lambda: direct.predict_probabilities(
        volumes[0]))
    del model, direct, sliding
    torch.cuda.empty_cache()
    step_peak = _step_peak(torch, None, work)

    # 2. the collectives on CUDA tensors over NCCL: one rank joins a group
    # as a launcher would have it
    launcher = rank_environment(0, 1, free_port())
    os.environ.update(launcher)
    try:
        initialize_distributed(device="cuda")
        group = torch.distributed.group.WORLD
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("no NCCL group of one rank")
        x = torch.randn(2, 6, 4, 4, 8, device="cuda").to(torch.bfloat16)
        x.requires_grad_()
        for lo, hi in ((1, 1), (2, 2), (0, 1)):
            y = halo_exchange(x, group, lo, hi)
            (g,) = torch.autograd.grad(y.float().sum(), x)
            if not (torch.equal(y.detach(), F.pad(
                    x.detach(), (0, 0, 0, 0, 0, 0, lo, hi)))
                    and torch.equal(g, torch.ones_like(x))):
                raise AssertionError(f"halo_exchange ({lo}, {hi}) over NCCL")
        if not torch.equal(all_gather_cat(x, group), x.detach()):
            raise AssertionError("all_gather_cat over NCCL")
    finally:
        shutdown_distributed()
        for key in launcher:
            os.environ.pop(key, None)
    print("spatial collectives over NCCL (one rank, CUDA tensors): "
          "halo_exchange (1, 1), (2, 2), (0, 1) forward and backward and "
          "all_gather_cat equal their definitions", flush=True)

    # 3. two ranks, and four (the 2 x 2 hybrid step, read in 4.) started
    # beside them: rank processes take most of their time to start, and
    # all six share the card
    t0 = time.perf_counter()
    world = 2 * SPATIAL_RANKS
    hybrid_ranks = start_ranks(_hybrid_rank, world,
                               (world, free_port(), str(work)))
    try:
        run_ranks(_spatial_rank, SPATIAL_RANKS,
                  (SPATIAL_RANKS, [free_port() for _ in range(4)],
                   str(work)), SPATIAL_RANK_TIMEOUT_S)
    except BaseException:  # a failure stops the four too
        for proc in hybrid_ranks.processes:
            proc.kill()
        raise
    two_s = time.perf_counter() - t0
    join_ranks(hybrid_ranks, SPATIAL_RANK_TIMEOUT_S)
    four_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"spatial_rank{r}.json").read_text())
             for r in range(SPATIAL_RANKS)]
    with open_data_file(config.data_file) as f:
        _, n_t, _, n_v = get_training_and_validation_generators(
            f, batch_size=config.batch_size, n_labels=config.n_labels,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=config.skip_blank, seed=0)
    n_val = len(pickle_load(config.validation_file))
    launches = {}
    for r, result in enumerate(ranks):
        backend = result["backend"]
        for tag, per in (("spatial", PER_FORWARD), ("sharded", PER_FORWARD),
                         ("isensee", ISENSEE_PER_FORWARD),
                         ("isensee_fold", ISENSEE_FOLD_PER_FORWARD),
                         ("reshard", PER_FORWARD)):
            got = result[tag]
            want = {k: n * got["forwards"] for k, n in per.items()}
            launches[f"{tag} predictor, rank {r} ({backend})"] = got[
                "launches"]
            print(f"spatial {tag} predictor, rank {r} of {SPATIAL_RANKS} "
                  f"over {backend}: {got['cases']} case(s) of "
                  f"{tuple(got['shape'])} against one device: max|p - "
                  f"p_one| {got['diff']:.6g} "
                  f"<= tol {got['tol']}, label flips {got['flips']}, "
                  f"{got['far_flips']} with |p - 0.5| >= tol; "
                  f"{got['seconds']:.4f} s per case (ranks share the card); "
                  f"launches {got['launches']} for {got['forwards']} "
                  f"forwards", flush=True)
            if got["launches"] != want:
                raise AssertionError(f"{tag} rank {r}: {got['launches']}, "
                                     f"not {want}")
            if tag == "isensee":
                bound = max(2 * isensee_to_fp32, PROB_TOL)
                print(f"spatial isensee predictor, rank {r}: max|p - p_fp32| "
                      f"{got['diff_fp32']:.6g} against an fp32 direct model, "
                      f"the direct predictor's {isensee_to_fp32:.6g} (bound "
                      f"max(2 x it, {PROB_TOL}) = {bound:.6g})", flush=True)
                if not got["diff_fp32"] <= bound:
                    raise AssertionError(f"isensee rank {r} against fp32: "
                                         f"{got['diff_fp32']} > {bound}")
            if not got["diff"] <= got["tol"] or got["far_flips"]:
                raise AssertionError(f"{tag} rank {r}: {got}")
        launches[f"gspmd step 1 x {SPATIAL_RANKS}, rank {r} ({backend})"] = \
            result["step"]["batchnorm=True"]["launches"]
        entries = result["entries"]
        forwards = {"train.main spatial": config.n_epochs * (n_t + n_v),
                    "predict.main spatial": n_val,
                    "predict.main sharded": n_val * result["sharded"][
                        "forwards"] // 3}
        for name, run in entries.items():
            want = {k: n * forwards[name] for k, n in PER_FORWARD.items()}
            launches[f"{name}, rank {r} ({backend})"] = run["launches"]
            print(f"spatial {name}, rank {r}: {run['seconds']:.4f} s, "
                  f"returned {run['result']}, launches {run['launches']} "
                  f"for {forwards[name]} forwards", flush=True)
            if run["launches"] != want:
                raise AssertionError(f"{name} rank {r}: {run['launches']}, "
                                     f"not {want}")
        if entries["train.main spatial"]["result"] != config.n_epochs * n_t:
            raise AssertionError(f"train.main steps {entries}")
    if any(ranks[0]["step"][k]["loss"] != ranks[1]["step"][k]["loss"]
           for k in ("batchnorm=False", "batchnorm=True")):
        raise AssertionError("the ranks' losses differ")
    with open(config.training_log) as f:
        rows = list(csv.DictReader(f))
    print("spatial train.main on the 1 x 2 mesh: " + "; ".join(
        f"epoch {r['epoch']} loss {float(r['loss']):.6g} val_loss "
        f"{float(r['val_loss']):.6g} {float(r['patches_per_sec']):.6g} "
        f"patches/s" for r in rows), flush=True)
    if [r["epoch"] for r in rows] != ["0", "1"] or not all(
            np.isfinite(float(r["loss"])) for r in rows):
        raise AssertionError(f"training log {rows}")
    # the entries' probability trees against one device from the same
    # checkpoint: the direct forward for the spatial mesh, the sliding
    # window for the sharded one
    for tag, direct in (("spatial", True), ("sharded", False)):
        out = work / f"one_{tag}"
        entry.main(config, output_dir=str(out), device="cuda",
                   verbose=False, prob_map=True, direct=direct)
        names = sorted(os.listdir(out))
        if sorted(os.listdir(work / f"pred_{tag}")) != names or len(
                names) != n_val:
            raise AssertionError(f"predict.main {tag}: {names}")
        diff = max(float(np.abs(
            load_nifti(str(work / f"pred_{tag}" / n / "prediction.nii.gz"))
            .get_fdata() - load_nifti(str(out / n / "prediction.nii.gz"))
            .get_fdata()).max()) for n in names)
        print(f"spatial predict.main on the {tag} mesh against one device "
              f"({'direct' if direct else 'sliding window'}): max|p - "
              f"p_one| {diff:.6g} <= tol {PROB_TOL} over {names}", flush=True)
        if not diff <= PROB_TOL:
            raise AssertionError(f"predict.main {tag}: {diff}")

    # 4. the four ranks: the 2 x 2 hybrid step
    hybrid = [json.loads((work / f"hybrid_rank{r}.json").read_text())
              for r in range(world)]
    for r, result in enumerate(hybrid):
        launches[f"gspmd step 2 x {SPATIAL_RANKS}, rank {r} "
                 f"({result['backend']})"] = result["step"][
                     "batchnorm=True"]["launches"]
    if len({h["step"][k]["loss"] for h in hybrid
            for k in ("batchnorm=False",)}) != 1:
        raise AssertionError("the hybrid ranks' losses differ")
    print(f"spatial peak memory ({smi}): a whole-volume "
          f"{tuple(config.image_shape)} forward {direct_peak} bytes on one "
          f"device, " + ", ".join(
              f"rank {r} {res['spatial_peak']} bytes"
              for r, res in enumerate(ranks))
          + f" on the 1 x {SPATIAL_RANKS} mesh; a train step of "
          f"{config.batch_size} x {tuple(config.patch_shape)} {step_peak} "
          f"bytes on one device, " + ", ".join(
              f"rank {r} {res['step_peak']} bytes"
              for r, res in enumerate(ranks))
          + f" on the 1 x {SPATIAL_RANKS} mesh, " + ", ".join(
              f"rank {r} {res['step_peak']} bytes"
              for r, res in enumerate(hybrid))
          + f" on the 2 x {SPATIAL_RANKS} mesh", flush=True)
    print(f"spatial ranks: two ranks {two_s:.4f} s, the four beside them "
          f"done {four_s:.4f} s after the start, each start included",
          flush=True)
    return launches


INTEROP_CASE_REPEATS = 5


def keras_stand_in(config):
    """A minimal stand-in for the reference Keras model of ``config`` (the
    card's machine has no Keras): its weight-bearing layers in Keras's
    order, each with the class name the mappings read (``Conv3D``,
    ``Conv3DTranspose``, ``GroupNormalization``), a ``name``, and
    ``get_weights`` / ``set_weights`` over zero arrays in Keras's layouts."""
    import types

    import numpy as np

    from fetal_mri_segmentation_tpu_torch.utils.keras_import import (
        _isensee_param_order, _unet_param_order)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        flax_param_shapes, unflatten)

    class Layer:
        def __init__(self, name, weights):
            self.name, self._weights = name, weights

        def get_weights(self):
            return [w.copy() for w in self._weights]

        def set_weights(self, weights):
            if [np.shape(w) for w in weights] != [
                    w.shape for w in self._weights]:
                raise ValueError(f"{self.name}: weights shaped "
                                 f"{[np.shape(w) for w in weights]}")
            self._weights = [np.array(w, np.float32) for w in weights]

    kinds = {k: type(k, (Layer,), {}) for k in (
        "Conv3D", "Conv3DTranspose", "GroupNormalization")}
    tree = unflatten({k: np.zeros(shape, np.float32) for k, shape in
                      flax_param_shapes(config).items()
                      if not k.startswith("batch_stats/")})
    layers = []

    def add(kind, name, *arrays):
        layers.append(kinds[kind](name, [np.zeros_like(a) for a in arrays]))

    if config.model_name == "isensee":
        blocks, heads = _isensee_param_order(tree)
        for name in blocks:
            add("Conv3D", name, *tree[name]["conv"].values())
            add("GroupNormalization", f"{name}_norm",
                *tree[name]["in"].values())
        for name in heads:
            add("Conv3D", name, *tree[name].values())
    else:
        for name in _unet_param_order(tree):
            sub = tree[name]
            if "deconv" in sub:  # Keras keeps (k, k, k, out, in)
                add("Conv3DTranspose", name,
                    sub["deconv"]["kernel"].transpose(0, 1, 2, 4, 3),
                    sub["deconv"]["bias"])
            else:
                add("Conv3D", name, *(sub if "kernel" in sub
                                      else sub["conv"]).values())
    return types.SimpleNamespace(layers=layers)


LOAD_ARTIFACTS = r"""
import json, sys, time
import numpy as np
import torch
from fetal_mri_segmentation_tpu_torch.utils.export import load_predictor

work = sys.argv[1]
volumes = [np.load(f"{work}/volume{i}.npy") for i in range(3)]
out, labels = {}, {}
for name in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    predict = load_predictor(f"{work}/{name}.fetal", device="cuda")
    load_s = time.perf_counter() - t0
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3, dec0
    counters = (conv3x3.conv3x3, conv3x3.conv3x3_flat,
                dec0.up_concat_conv3x3_kernel)
    for fn in counters:
        fn.launches = 0
    for i, vol in enumerate(volumes):
        labels[f"{name}/{i}"] = predict(vol)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    vol = torch.from_numpy(volumes[0]).cuda()
    with torch.no_grad():
        predict.program(vol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(%d):
            predict.program(vol)
        torch.cuda.synchronize()
    out[name] = dict(launches=launches, load_s=load_s,
                     case_s=(time.perf_counter() - t0) / %d,
                     meta=predict.meta)
np.savez(f"{work}/labels.npz", **labels)
out["model_modules"] = sorted(m for m in sys.modules if m.startswith(
    ("fetal_mri_segmentation_tpu_torch.models",
     "fetal_mri_segmentation_tpu_torch.inference")))
with open(f"{work}/loaded.json", "w") as f:
    json.dump(out, f)
""" % (INTEROP_CASE_REPEATS, INTEROP_CASE_REPEATS)


def interop_phase(torch, work: Path) -> dict:
    """Keras interop and the portable program at full width
    (``configs/fetal_unet.json`` and ``configs/fetal_isensee.json``, both
    kernel switches on, weights from a seed): each model through
    ``keras_export`` into a Keras stand-in and ``keras_import`` back, bit
    for bit; the three cases served by the imported U-Net with the kernels
    (labels equal the original's); ``export_predictor`` with ``["cuda"]``
    and the default platforms, sliding window and direct, and
    ``predict.main --export``, each artifact loaded in a fresh process on
    the card: the ``["cuda"]`` programs' labels against the live
    kernels-on predictors and the portable ones' against kernels off
    (within ``PROB_TOL`` / ``NORM_PROB_TOL``, no flip away from 0.5), their
    launches exactly the live path's per forward; the host time of a
    launch through the custom op and without it."""
    import dataclasses

    import numpy as np

    from fetal_mri_segmentation_tpu_torch import predict as entry
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        preprocess_case)
    from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
        SlidingWindowPredictor)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops
    from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
        make_direct_predictor)
    from fetal_mri_segmentation_tpu_torch.utils.export import (
        export_predictor)
    from fetal_mri_segmentation_tpu_torch.utils.keras_export import (
        export_keras_isensee_weights, export_keras_unet_weights)
    from fetal_mri_segmentation_tpu_torch.utils.keras_import import (
        keras_state_dict, keras_weight_list_from_model)
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like, to_flax)

    config = dataclasses.replace(
        Config.load(str(ROOT / "configs" / "fetal_unet.json")),
        use_pallas_conv=True, use_pallas_dec0=True)
    config_off = dataclasses.replace(config, use_pallas_conv=False,
                                     use_pallas_dec0=False)
    isensee_cfg = _isensee_config()

    # 1. the Keras mapping on both families, through the stand-in
    models = {}
    for tag, cfg, exporter in (("unet", config, export_keras_unet_weights),
                               ("isensee", isensee_cfg,
                                export_keras_isensee_weights)):
        original = build_model(cfg, "cuda")
        original.load_state_dict(from_flax(init_flax_like(cfg, seed=0)))
        stand_in = keras_stand_in(cfg)
        t0 = time.perf_counter()
        exporter(original, stand_in)
        weights = keras_weight_list_from_model(stand_in)
        imported = build_model(cfg, "cuda")
        imported.load_state_dict(keras_state_dict(cfg, weights))
        seconds = time.perf_counter() - t0
        state = original.state_dict()
        differ = [k for k, v in imported.state_dict().items()
                  if not torch.equal(v, state[k])]
        print(f"interop keras {tag}: {len(weights)} weight layers out and "
              f"back in {seconds:.4f} s; {len(state)} tensors, "
              f"{len(differ)} differ", flush=True)
        if differ:
            raise AssertionError(f"keras round trip {tag}: {differ}")
        models[tag] = (original, imported)

    # 2. the imported U-Net serves the three cases with the kernels
    inputs = write_cases(work / "cases")
    volumes = [preprocess_case(path, config)[0] for path in inputs]
    for i, vol in enumerate(volumes):
        np.save(work / f"volume{i}.npy", vol)
    original, imported = models["unet"]
    served = {}
    for tag, model in (("original", original), ("imported", imported)):
        predictor = SlidingWindowPredictor(
            model, config, config.image_shape,
            overlap=config.validation_patch_overlap, patch_batch_size=27)
        served[tag], launches = _counted(torch, lambda: [
            predictor.predict_labels(v) for v in volumes])
    want = {k: n * len(volumes) for k, n in PER_FORWARD.items()}
    same = all(np.array_equal(a, b) for a, b in zip(*served.values()))
    print(f"interop: the Keras-imported U-Net on {len(volumes)} cases: "
          f"labels equal the original's: {same}; launches {launches} "
          f"(one batch of 27 patches per case)", flush=True)
    if not same or launches != want:
        raise AssertionError(f"imported serving: {same}, {launches}")

    # 3. the live references, and the artifacts
    off = build_model(config_off, "cuda")
    off.load_state_dict(imported.state_dict())
    refs = {}
    for tag, cfg, model in (("on", config, imported),
                            ("off", config_off, off),
                            ("isensee", isensee_cfg, models["isensee"][1])):
        refs[f"{tag} sliding"] = SlidingWindowPredictor(
            model, cfg, cfg.image_shape, overlap=cfg.validation_patch_overlap,
            patch_batch_size=27)
        if tag != "isensee":
            refs[f"{tag} direct"] = make_direct_predictor(model, cfg)
    probs = {k: [p.predict_probabilities(v)[0].cpu() for v in volumes]
             for k, p in refs.items()}
    case_s = {}
    for key in ("on sliding", "off sliding"):
        refs[key].predict_labels(volumes[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INTEROP_CASE_REPEATS):
            refs[key].predict_labels(volumes[0])
        torch.cuda.synchronize()
        case_s[key] = (time.perf_counter() - t0) / INTEROP_CASE_REPEATS
    # artifact -> (reference, tolerance, launches per forward, forwards
    # per case)
    artifacts = {
        "cuda_sliding": ("on sliding", PROB_TOL, PER_FORWARD, 1),
        "cuda_direct": ("on direct", PROB_TOL, PER_FORWARD, 1),
        "portable_sliding": ("off sliding", PROB_TOL, None, 0),
        "portable_direct": ("off direct", PROB_TOL, None, 0),
        "predict_main": ("off sliding", PROB_TOL, None, 0),
        "isensee_cuda_sliding": ("isensee sliding", NORM_PROB_TOL,
                                 ISENSEE_PER_FORWARD, 1)}
    export_s = {}
    for name in artifacts:
        t0 = time.perf_counter()
        path = str(work / f"{name}.fetal")
        if name == "predict_main":
            params = work / "params.npz"
            np.savez(params, **to_flax(imported.state_dict()))
            entry.main(config, str(params), export_path=path,
                       patch_batch_size=27, device="cuda", verbose=False)
        else:
            cuda = name.startswith(("cuda", "isensee"))
            cfg = isensee_cfg if name.startswith("isensee") else config
            model = (models["isensee"][1] if name.startswith("isensee")
                     else imported)
            export_predictor(model, cfg, cfg.image_shape, path,
                             overlap=cfg.validation_patch_overlap,
                             patch_batch_size=27, direct="direct" in name,
                             platforms=["cuda"] if cuda else None)
        export_s[name] = time.perf_counter() - t0
    del refs, off
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_ARTIFACTS, str(work),
         json.dumps(list(artifacts))], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    load_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"loading the artifacts failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    loaded = json.loads((work / "loaded.json").read_text())
    if loaded.pop("model_modules"):
        raise AssertionError("the loader imported the port's model modules")
    labels = np.load(work / "labels.npz")
    launches = {}
    for name, (ref, tol, per, forwards) in artifacts.items():
        got = loaded[name]
        flips = far = 0
        for i, p in enumerate(probs[ref]):
            p = p.numpy()
            flipped = labels[f"{name}/{i}"] != (p > 0.5)
            flips += int(flipped.sum())
            far += int((flipped & (np.abs(p - 0.5) >= tol)).sum())
        want = {k: (n * forwards * len(volumes) if per else 0)
                for k, n in (per or PER_FORWARD).items()}
        launches[name] = got["launches"]
        size = os.path.getsize(work / f"{name}.fetal")
        print(f"interop artifact {name} ({got['meta']['platforms']}, "
              f"{size} bytes, exported in {export_s[name]:.4f} s, loaded in "
              f"{got['load_s']:.4f} s): against {ref}: label flips {flips}, "
              f"{far} with |p - 0.5| >= {tol}; {got['case_s']:.6f} s per "
              f"case; launches {got['launches']} (want {want})", flush=True)
        if far or got["launches"] != want:
            raise AssertionError(f"artifact {name}: {far} far flips, "
                                 f"launches {got['launches']}")
    print(f"interop: a 128^3 case through the live sliding window "
          f"{case_s['on sliding']:.6f} s with the kernels, "
          f"{case_s['off sliding']:.6f} s without (batches of 27); the "
          f"artifacts' fresh process {load_s:.4f} s", flush=True)

    # 4. the host time of one launch: the public wrapper (autograd
    # Function, custom op, ctypes), the custom op alone, the ctypes launch
    # alone, on a shape whose device time is small
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 8, 8, 8, 64, device="cuda", generator=gen).to(
        torch.bfloat16)
    w = (torch.randn(3, 3, 3, 64, 64, device="cuda", generator=gen)
         * 0.03).to(torch.bfloat16)
    b = torch.zeros(64, device="cuda")
    host_us = {}
    for tag, fn in (
            ("wrapper", lambda: conv_ops.conv3x3_flat(x, w, b, "relu")),
            ("custom op", lambda: torch.ops.fetal.conv3x3(
                x, w, b, "relu", 0.3, "conv3x3_flat")),
            ("ctypes launch", lambda: conv_ops._launch(
                "conv3x3_flat", x, w, b, "relu", 0.3))):
        with torch.inference_mode():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            host = (time.perf_counter() - t0) / 500
            torch.cuda.synchronize()
        host_us[tag] = host * 1e6
    device_ms = time_ms(torch, lambda: conv_ops._launch(
        "conv3x3_flat", x, w, b, "relu", 0.3), iters=50)
    print("interop host time per launch (1 x 8^3 x 64 -> 64, device "
          f"{device_ms * 1e3:.2f} us): " + ", ".join(
              f"{k} {v:.2f} us" for k, v in host_us.items()), flush=True)
    return launches


def _grads(torch, model, cfg, x, y):
    """One train step of ``model`` from its weights on (x, y), augmentation
    off, the step's generator seeded: ``(per-parameter fp32 gradients,
    loss, launches)``."""
    import dataclasses

    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)

    cfg = dataclasses.replace(cfg, augment=False)
    step = make_train_step(
        model, cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    metrics, launches = _counted(torch, lambda: step(
        create_train_state(model, cfg), x, y))
    return ({n: p.grad.float().clone() for n, p in model.named_parameters()},
            float(metrics["loss"]), launches)


def _rel(a, b, scale=None) -> float:
    return ((a - b).norm() / (b if scale is None else scale).norm()).item()


def fold_phase(torch, work: Path, smi: str) -> dict:
    """Space-to-depth folding of the full-resolution level at full width,
    kernel switches on, bf16, weights from seed 0: the U-Net
    (``configs/fetal_unet.json``) in every ``FOLD_SETTINGS`` entry against
    the same weights unfolded, through the direct predictor and the sliding
    window on the three synthetic cases (probabilities within the kernel
    check's REL_TOL / ABS_TOL of their scale, no label flip away from 0.5,
    exactly ``FOLD_PER_FORWARD`` launches per forward), each forward's
    milliseconds beside the unfolded one's; Isensee2017 folded (1, 1, 2)
    dense, a forward and one train step against unfolded; the U-Net's train
    step folded against unfolded (gradients within GRAD_REL_TOL, both
    timed); ``train.main`` for one epoch on six cases with the fold, then
    ``predict.main --direct`` from its checkpoint and ``predict --export``
    of the fold config, whose loaded program must be the unfolded
    program; the fused decoder's input-dilated form under
    ``decoder_form_override("dilated")`` against the parity form, the
    switches off, both timed. Returns the launches of each counted run."""
    import dataclasses
    import functools
    import math

    import numpy as np

    from fetal_mri_segmentation_tpu_torch import predict as entry, train
    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        preprocess_case)
    from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
        SlidingWindowPredictor)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.models import layers
    from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock
    from fetal_mri_segmentation_tpu_torch.parallel.spatial import (
        make_direct_predictor)
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        get_number_of_patches, get_number_of_steps)
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.training.train_step import (
        make_train_step)
    from fetal_mri_segmentation_tpu_torch.utils.export import load_predictor
    from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    torch.backends.cudnn.allow_tf32 = True  # as the train phase
    config = dataclasses.replace(
        Config.load(str(ROOT / "configs" / "fetal_unet.json")),
        use_pallas_conv=True, use_pallas_dec0=True)
    weights = from_flax(init_flax_like(config, seed=0))
    inputs = write_cases(work / "cases")
    volumes = [preprocess_case(path, config)[0] for path in inputs]
    overlap = config.validation_patch_overlap
    sliding_forwards = math.ceil(27 / B)  # 27 patches a case, batches of B
    launches = {}

    def built(cfg, state=weights):
        model = build_model(cfg, "cuda")
        model.load_state_dict(state)
        return model

    def counted(label, forwards, run, table=FOLD_PER_FORWARD):
        out, got = _counted(torch, run)
        want = {k: n * forwards for k, n in table.items()}
        if got != want:
            raise AssertionError(f"fold {label}: launches {got}, not {want}")
        launches[label] = got
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    x_batch = torch.randn(B, 64, 64, 64, 1, device="cuda",
                          generator=gen).to(torch.bfloat16)
    x_volume = torch.randn(1, 128, 128, 128, 1, device="cuda",
                           generator=gen).to(torch.bfloat16)

    def forward_ms(model):
        with torch.inference_mode():
            return (time_ms(torch, lambda: model(x_batch)),
                    time_ms(torch, lambda: model(x_volume)))

    def agreement(tag, got, want, tol_of):
        """max|diff|, its bound, label agreement and far flips over the
        cases."""
        diff = agree = far = 0.0
        tol = 0.0
        for p, q in zip(got, want):
            tol = max(tol, tol_of(q))
            diff = max(diff, (p - q).abs().max().item())
            flipped = (p[0] > 0.5) != (q[0] > 0.5)
            agree += 1 - flipped.float().mean().item()
            far += int((flipped & ((q[0] - 0.5).abs() >= tol)).sum().item())
        agree /= len(got)
        print(f"fold {tag}: max|p - p_ref| {diff:.6g} <= tol {tol:.6g}; "
              f"labels agree on {agree:.8f} of the voxels, {int(far)} "
              f"flips with |p - 0.5| >= tol ({smi})", flush=True)
        if not diff <= tol or far:
            raise AssertionError(f"fold {tag}: {diff} > {tol} or {far} far "
                                 "flips")

    def kernel_tol(ref):
        return REL_TOL * ref.abs().max().item() + ABS_TOL

    # 1. the U-Net folded in each setting against the same weights unfolded
    reference = built(config)
    refs = {"direct": [make_direct_predictor(reference, config)
                       .predict_probabilities(v) for v in volumes],
            "sliding": [SlidingWindowPredictor(
                reference, config, config.image_shape, overlap=overlap,
                patch_batch_size=B).predict_probabilities(v)
                for v in volumes]}
    times = {"unfolded, kernels on": forward_ms(reference)}
    del reference
    for factors, form in FOLD_SETTINGS:
        tag = f"{factors} {form}"
        cfg = dataclasses.replace(config, fold_level0=factors,
                                  fold_formulation=form)
        model = built(cfg)
        predictors = {
            "direct": (make_direct_predictor(model, cfg), 1),
            "sliding": (SlidingWindowPredictor(
                model, cfg, cfg.image_shape, overlap=overlap,
                patch_batch_size=B), sliding_forwards)}
        for mode, (predictor, forwards) in predictors.items():
            probs = counted(f"{tag} {mode}", forwards * len(volumes),
                            lambda: [predictor.predict_probabilities(v)
                                     for v in volumes])
            if not all(bool(torch.isfinite(p).all()) for p in probs):
                raise AssertionError(f"fold {tag} {mode}: non-finite")
            agreement(f"{tag} {mode} against unfolded", probs, refs[mode],
                      kernel_tol)
        times[tag] = forward_ms(model)
        del model, predictors
        torch.cuda.empty_cache()
    print(f"fold forward ms ({smi}): " + "; ".join(
        f"{k}: batch of {B} x 64^3 {a:.6g}, 128^3 {b:.6g}"
        for k, (a, b) in times.items()), flush=True)
    off = dataclasses.replace(config, use_pallas_conv=False,
                              use_pallas_dec0=False)
    off_model = built(off)
    times["unfolded, kernels off"] = forward_ms(off_model)
    fold_off = built(dataclasses.replace(off, fold_level0=(1, 1, 2)))
    times["(1, 1, 2) dense, kernels off"] = forward_ms(fold_off)
    del fold_off
    print(f"fold forward ms, switches off ({smi}): " + "; ".join(
        f"{k}: {a:.6g}, {b:.6g}" for k, (a, b) in times.items()
        if k.endswith("off")), flush=True)
    dense_stats = {}
    for entry_name, layer, *shape in FOLD_DENSE_SHAPES:
        conv_case(torch, gen, dense_stats, 1, entry_name, layer, *shape)
    summarize(dense_stats, f"fold, the dense folded level 0 on K2 (not on "
                           f"the path; {smi})")

    # 2. the fused decoder's two plain forms, switches off (no kernel takes
    # the decoder): the same forward through each, both timed
    forms = {}
    calls = []
    real = layers.up_concat_conv3x3_dilated
    layers.up_concat_conv3x3_dilated = lambda *a: (calls.append(1),
                                                   real(*a))[1]
    try:
        for form in ("parity", "dilated"):
            with layers.decoder_form_override(form), torch.inference_mode():
                calls.clear()
                out = [off_model(x) for x in (x_batch, x_volume)]
                taken = len(calls)
                ms = forward_ms(off_model)
            forms[form] = (out, taken, ms)
    finally:
        layers.up_concat_conv3x3_dilated = real
    for form, (out, taken, ms) in forms.items():
        # three fused decoder blocks per forward, two forwards
        want_taken = (2 * PER_FORWARD["up_concat_conv3x3_kernel"]
                      if form == "dilated" else 0)
        diffs = [(a - b).abs().max().item()
                 for a, b in zip(out, forms["parity"][0])]
        print(f"fold decoder form {form} (switches off): {taken} dilated "
              f"decoder calls over two forwards (want {want_taken}); "
              f"max|p - p_parity| {max(diffs):.6g} <= tol {PROB_TOL}; "
              f"forward ms batch of {B} x 64^3 {ms[0]:.6g}, 128^3 "
              f"{ms[1]:.6g} ({smi})", flush=True)
        if taken != want_taken or not max(diffs) <= PROB_TOL:
            raise AssertionError(f"decoder form {form}: {taken} calls, "
                                 f"{diffs}")
    del off_model, forms
    torch.cuda.empty_cache()

    # 3. Isensee2017 folded (1, 1, 2) dense: a forward and one train step
    # against unfolded, from the same weights; each bf16 path's gradients
    # held to an fp32 model's, as the isensee phase holds the kernels
    isensee = _isensee_config()
    i_weights = from_flax(init_flax_like(isensee, seed=0))
    i_fold = dataclasses.replace(isensee, fold_level0=(1, 1, 2),
                                 fold_formulation="dense")
    i_ref = [make_direct_predictor(built(isensee, i_weights), isensee)
             .predict_probabilities(v) for v in volumes]
    model = built(i_fold, i_weights)
    probs = counted("isensee direct", len(volumes), lambda: [
        make_direct_predictor(model, i_fold).predict_probabilities(v)
        for v in volumes], ISENSEE_FOLD_PER_FORWARD)
    agreement("isensee (1, 1, 2) dense direct against unfolded", probs,
              i_ref, lambda ref: NORM_PROB_TOL)
    x_np, y_np = train_batch(isensee)
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    grads, losses = {}, {}
    i_32 = dataclasses.replace(isensee, use_pallas_conv=False,
                               use_pallas_dec0=False,
                               compute_dtype="float32")
    for name, cfg, want in (
            ("fold", i_fold, ISENSEE_FOLD_PER_TRAIN),
            ("unfolded", isensee, ISENSEE_PER_TRAIN),
            ("fp32", i_32, dict.fromkeys(ISENSEE_PER_TRAIN, 0))):
        torch.backends.cudnn.allow_tf32 = name != "fp32"
        model = built(cfg, i_weights)
        grads[name], losses[name], got = _grads(torch, model, cfg, x, y)
        torch.backends.cudnn.allow_tf32 = True
        if got != want:
            raise AssertionError(f"isensee train step {name}: launches "
                                 f"{got}, not {want}")
        launches[f"isensee train step {name}"] = got
        before_norm = {f"{n}.conv.bias" for n, m in model.named_modules()
                       if isinstance(m, ConvBlock) and m.norm_key}
        del model
    worst, worst_bias, direct = (None, (0.0, 0.0, 0.0)), (None, 0.0), (
        None, 0.0)
    for n, g32 in grads["fp32"].items():
        g_fold, g_plain = grads["fold"][n], grads["unfolded"][n]
        if n in before_norm:  # rounding only: held to its weight's scale
            scale = grads["fp32"][n[:-len("bias")] + "weight"]
            r = max(_rel(g_fold, g32, scale), _rel(g_plain, g32, scale))
            if not r <= worst_bias[1]:
                worst_bias = (n, r)
            continue
        r_fold, r_plain = _rel(g_fold, g32), _rel(g_plain, g32)
        margin = r_fold / max(2 * r_plain, GRAD_REL_TOL)
        if worst[0] is None or not margin <= worst[1][0]:
            worst = (n, (margin, r_fold, r_plain))
        if not _rel(g_fold, g_plain) <= direct[1]:
            direct = (n, _rel(g_fold, g_plain))
    n, (margin, r_fold, r_plain) = worst
    print(f"fold isensee train grad check: against the fp32 model, worst "
          f"{n}: relative L2 {r_fold:.6g} folded, {r_plain:.6g} unfolded "
          f"(bound max(2 x {r_plain:.6g}, {GRAD_REL_TOL})); folded against "
          f"unfolded at most {direct[1]:.6g} ({direct[0]}); conv biases "
          f"before a norm within {worst_bias[1]:.6g} of their weight "
          f"gradient's norm; loss {losses['fold']:.6g} folded, "
          f"{losses['unfolded']:.6g} unfolded, {losses['fp32']:.6g} fp32; "
          f"launches {launches['isensee train step fold']} ({smi})",
          flush=True)
    if not (margin <= 1 and worst_bias[1] <= GRAD_REL_TOL and abs(
            losses["fold"] - losses["unfolded"]) <= LOSS_TOL):
        raise AssertionError(f"isensee fold gradients: {worst}, "
                             f"{worst_bias}, {losses}")
    del grads
    torch.cuda.empty_cache()

    # 4. the U-Net's train step folded (1, 1, 2) dense against unfolded:
    # gradients, loss and the step's milliseconds
    x_np, y_np = train_batch(config)
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    u_fold = dataclasses.replace(config, fold_level0=(1, 1, 2),
                                 fold_formulation="dense")
    grads, losses, steps = {}, {}, {}
    for name, cfg, want in (("fold", u_fold, FOLD_PER_FORWARD),
                            ("unfolded", config, PER_FORWARD)):
        model = built(cfg)
        grads[name], losses[name], got = _grads(torch, model, cfg, x, y)
        if got != want:
            raise AssertionError(f"unet train step {name}: launches {got}")
        launches[f"unet train step {name}"] = got
        state = create_train_state(model, cfg)
        steps[name] = functools.partial(make_train_step(
            model, cfg, generator=torch.Generator(device="cuda").manual_seed(
                0)), state, x, y)
    # the two steps timed in turns: fold, unfolded, unfolded, fold
    step_ms = {name: [] for name in steps}
    for name in ("fold", "unfolded", "unfolded", "fold"):
        step_ms[name].append(time_ms(torch, steps[name]))
    del steps
    torch.cuda.empty_cache()
    worst = max((_rel(grads["fold"][n], g), n)
                for n, g in grads["unfolded"].items())
    print(f"fold unet train step (1, 1, 2) dense: largest relative L2 "
          f"gradient difference against unfolded {worst[0]:.6g} ({worst[1]}) "
          f"<= tol {GRAD_REL_TOL}; loss {losses['fold']:.6g} against "
          f"{losses['unfolded']:.6g}; step of {config.batch_size}x"
          f"{tuple(config.patch_shape)} with augmentation, in turns: "
          f"folded {', '.join(f'{v:.6g}' for v in step_ms['fold'])} ms, "
          f"unfolded {', '.join(f'{v:.6g}' for v in step_ms['unfolded'])} "
          f"ms ({smi})", flush=True)
    if not (worst[0] <= GRAD_REL_TOL and abs(
            losses["fold"] - losses["unfolded"]) <= LOSS_TOL):
        raise AssertionError(f"unet fold gradients: {worst}, {losses}")
    del grads

    # 5. the entries: train.main for one epoch with the fold on six cases,
    # predict.main --direct from its checkpoint, and predict --export of
    # the fold config against the unfolded config's artifact
    run_cfg = dataclasses.replace(
        u_fold, n_epochs=1, initial_learning_rate=EXPERIMENT_LR,
        data_file=str(work / "fetal_data"),
        model_file=str(work / "fetal_unet.ckpt"),
        training_file=str(work / "training_ids.pkl"),
        validation_file=str(work / "validation_ids.pkl"),
        training_log=str(work / "training.log"))
    write_cases(work / "cases6", n=6)
    t0 = time.perf_counter()
    state, got = _counted(torch, lambda: train.main(
        run_cfg, str(work / "cases6"), seed=0, verbose=False,
        device="cuda"))
    train_s = time.perf_counter() - t0
    steps = state.step
    with open_data_file(run_cfg.data_file) as data_file:
        n_v = get_number_of_steps(get_number_of_patches(
            data_file, pickle_load(run_cfg.validation_file),
            run_cfg.patch_shape,
            patch_overlap=run_cfg.validation_patch_overlap,
            skip_blank=run_cfg.skip_blank), run_cfg.validation_batch_size)
    # one forward per train and per validation step
    want = {k: v * (steps + n_v) for k, v in FOLD_PER_FORWARD.items()}
    if steps <= 0 or got != want:
        raise AssertionError(f"train.main with fold: {steps} + {n_v} "
                             f"steps, launches {got}, not {want}")
    launches["train.main"] = got
    del state
    out = work / "prediction"
    n, got = _counted(torch, lambda: entry.main(
        run_cfg, output_dir=str(out), direct=True, device="cuda",
        verbose=False))
    want = {k: v * n for k, v in FOLD_PER_FORWARD.items()}
    if not n or got != want:
        raise AssertionError(f"predict.main --direct with fold: {n} cases, "
                             f"launches {got}")
    launches["predict.main direct"] = got
    programs = {}
    for tag, cfg in (("fold", run_cfg),
                     ("unfolded", dataclasses.replace(run_cfg,
                                                      fold_level0="off"))):
        path = str(work / f"{tag}.fetal")
        entry.main(cfg, export_path=path, direct=True, device="cuda",
                   verbose=False)
        predict = load_predictor(path, device="cuda")
        programs[tag] = (predict.program.code,
                         [predict(v) for v in volumes])
    same_code = programs["fold"][0] == programs["unfolded"][0]
    same_labels = all(np.array_equal(a, b) for a, b in zip(
        programs["fold"][1], programs["unfolded"][1]))
    print(f"fold entries: train.main one epoch with fold (1, 1, 2) dense, "
          f"{steps} steps, {train_s:.4f} s, launches "
          f"{launches['train.main']}; predict.main --direct {n} validation "
          f"cases, launches {launches['predict.main direct']}; predict "
          f"--export of the fold config: the program's code equals the "
          f"unfolded one's: {same_code}, labels equal on "
          f"{len(volumes)} cases: {same_labels} ({smi})", flush=True)
    if not (same_code and same_labels):
        raise AssertionError("the fold config's artifact is not the "
                             "unfolded program")
    return launches


NATIVE_REPEATS = 20


def native_phase(torch, work: Path, smi: str) -> dict:
    """The native host library (``utils/native.py``, built from the port's
    ``native/fastloader.cpp`` with the system C++ compiler): it must build
    and load; each entry point against numpy on a 160 x 160 x 110 case
    (patch copies bit for bit, the weighted overlap-add within 1e-5, the
    blank check and one-hot equal), with host microseconds for each; then
    ``train_model``'s patches/s over one host-staged epoch with the library
    and with ``FETAL_TPU_NO_NATIVE=1``, twice each in turns (native, numpy,
    numpy, native) after one warm-up epoch, with the library's patch
    copies counted. Returns the launches of the epochs."""
    import csv
    import dataclasses

    import numpy as np

    from fetal_mri_segmentation_tpu_torch.config import Config
    from fetal_mri_segmentation_tpu_torch.data.memory import InMemoryDataFile
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops import patches
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu_torch.training.loop import train_model
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.utils import native
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti
    from fetal_mri_segmentation_tpu_torch.utils.params import (
        from_flax, init_flax_like)

    t0 = time.perf_counter()
    path = native.build()
    if not native.available():
        raise AssertionError("the native library built but did not load")
    print(f"native: {path.name} from {native.SOURCE.name} by "
          f"{native.compiler()} in {time.perf_counter() - t0:.4f} s",
          flush=True)
    cases = write_cases(work / "cases")
    vol = np.asarray(load_nifti(str(Path(cases[0]) / "volume.nii.gz"))
                     .get_fdata(), np.float32)[None].copy()
    patch = (64, 64, 64)

    def numpy_patch(corner):
        os.environ["FETAL_TPU_NO_NATIVE"] = "1"
        try:
            return np.array(patches.get_patch_from_3d_data(vol, patch,
                                                           corner))
        finally:
            del os.environ["FETAL_TPU_NO_NATIVE"]

    def host_us(fn):
        fn()
        t = time.perf_counter()
        for _ in range(NATIVE_REPEATS):
            fn()
        return (time.perf_counter() - t) / NATIVE_REPEATS * 1e6

    corners = np.array([(0, 0, 0), (-16, -16, -16), (48, 48, 23),
                        (100, 100, 50), (150, 150, 100), (-70, 0, 0)],
                       np.int64)
    for c in corners:
        got = native.extract_patch(vol, patch, c)
        if not np.array_equal(got, numpy_patch(c)):
            raise AssertionError(f"extract_patch at {tuple(c)} differs")
    batch = native.extract_patches_batch(vol, patch, corners)
    if not np.array_equal(batch, np.stack([numpy_patch(c)
                                           for c in corners])):
        raise AssertionError("extract_patches_batch differs")
    grid = patches.compute_patch_indices(vol.shape[1:], patch, 16)
    weight = patches.gaussian_importance_map(patch)
    rng = np.random.default_rng(0)
    preds = rng.random((len(grid), 1) + patch).astype(np.float32)
    acc = np.zeros(vol.shape, np.float32)
    wsum = np.zeros(vol.shape[1:], np.float32)
    acc_np, wsum_np = acc.copy(), wsum.copy()
    for p, c in zip(preds, grid):
        native.overlap_add(acc, wsum, p, weight, c)
        lo = np.maximum(c, 0)
        hi = np.minimum(c + patch, vol.shape[1:])
        dst = tuple(slice(a, b) for a, b in zip(lo, hi))
        src = tuple(slice(a - i, b - i) for a, b, i in zip(lo, hi, c))
        acc_np[(slice(None),) + dst] += p[(slice(None),) + src] * weight[src]
        wsum_np[dst] += weight[src]
    oa_err = max(np.abs(acc - acc_np).max(), np.abs(wsum - wsum_np).max())
    blank = np.zeros_like(vol)
    labels = np.array([1.0], np.float64)
    truth = (vol[0] > 1).astype(np.float32)
    hot = np.empty((1, truth.size), np.float32)
    native._load().one_hot_f32(truth.reshape(-1), hot, labels, 1, truth.size)
    checks = (np.array_equal(hot[0], truth.reshape(-1) == 1.0)
              and native.any_nonzero(vol) is True
              and native.any_nonzero(blank) is False)
    times = {
        "extract_patch": (host_us(lambda: native.extract_patch(
            vol, patch, corners[2])), host_us(lambda: numpy_patch(
                corners[2]))),
        "extract_patch at the border": (host_us(
            lambda: native.extract_patch(vol, patch, corners[1])),
            host_us(lambda: numpy_patch(corners[1]))),
        "any_nonzero (blank)": (host_us(lambda: native.any_nonzero(blank)),
                                host_us(lambda: bool(np.any(blank))))}
    print(f"native entry points on a {vol.shape[1:]} case: {len(corners)} "
          f"patch copies and one batch of them equal numpy bit for bit; "
          f"overlap-add of {len(grid)} patches within {oa_err:.3g} of "
          f"numpy (<= 1e-5); one-hot and blank checks equal: {checks}; host "
          f"us native / numpy: " + ", ".join(
              f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in times.items())
          + f" ({smi})", flush=True)
    if not (oa_err <= 1e-5 and checks):
        raise AssertionError(f"native overlap-add {oa_err}, checks {checks}")

    # train_model's patches/s, host-staged, with the library and without
    config = dataclasses.replace(
        Config.load(str(ROOT / "configs" / "fetal_unet.json")),
        use_pallas_conv=True, use_pallas_dec0=True, n_epochs=1,
        device_case_cache="off", overwrite=False,
        training_file=str(work / "training_ids.pkl"),
        validation_file=str(work / "validation_ids.pkl"))
    data_file = InMemoryDataFile.from_cases(cases, config)
    weights = from_flax(init_flax_like(config, seed=0))
    copies = []
    real = native.extract_patch
    native.extract_patch = lambda *a: (copies.append(1), real(*a))[1]
    rates, launches = {}, {}
    try:
        for i, mode in enumerate(("warm-up", "native", "numpy", "numpy",
                                  "native")):
            # each run its own checkpoint and log (an existing checkpoint
            # would be resumed)
            run_cfg = dataclasses.replace(
                config, model_file=str(work / f"model{i}.pt"),
                training_log=str(work / f"training{i}.log"))
            if mode == "numpy":
                os.environ["FETAL_TPU_NO_NATIVE"] = "1"
            copies.clear()
            tg, n_t, vg, n_v = get_training_and_validation_generators(
                data_file, batch_size=config.batch_size, n_labels=1,
                training_keys_file=config.training_file,
                validation_keys_file=config.validation_file,
                data_split=config.validation_split, overwrite=i == 0,
                labels=config.labels, patch_shape=config.patch_shape,
                validation_batch_size=config.validation_batch_size,
                validation_patch_overlap=config.validation_patch_overlap,
                training_patch_start_offset=(
                    config.training_patch_start_offset),
                skip_blank=config.skip_blank, seed=0)
            model = build_model(config, "cuda")
            model.load_state_dict(weights)
            _, got = _counted(torch, lambda: train_model(
                model, create_train_state(model, run_cfg), run_cfg, tg, vg,
                n_t, n_v, seed=0, verbose=False))
            os.environ.pop("FETAL_TPU_NO_NATIVE", None)
            want = {k: v * (n_t + n_v) for k, v in PER_FORWARD.items()}
            if got != want or bool(copies) != (mode != "numpy"):
                raise AssertionError(f"native epoch {i} ({mode}): launches "
                                     f"{got}, {len(copies)} native copies")
            launches[f"train_model {mode} {i}"] = got
            with open(run_cfg.training_log) as f:
                row = list(csv.DictReader(f))[-1]
            rates.setdefault(mode, []).append(
                (float(row["patches_per_sec"]), len(copies)))
            del model
    finally:
        native.extract_patch = real
        os.environ.pop("FETAL_TPU_NO_NATIVE", None)
    print(f"native train_model, host-staged, one epoch of {n_t} + {n_v} "
          f"steps each, in turns: patches/s " + "; ".join(
              f"{mode} " + ", ".join(f"{r:.6g} ({c} native copies)"
                                     for r, c in runs)
              for mode, runs in rates.items()) + f" ({smi})", flush=True)
    return launches


# The quality phase: the recipe of tools/torch_parity_dice.py (the root
# parity_dice.py's) through the three entry points, and a short run of the
# multi-class recipe of tools/torch_multiclass_quality.py. The full recipes
# are records kept by those tools, not gates of this script: a converged
# dice tuned on one run can miss on the next with no fault in the code.
# The one floor: the parity recipe's held-out mean hard Dice is recorded at
# 0.9597 (JAX) and 0.9556 (CPU-Keras) with a per-case std of about 0.004
# (docs/PARITY.md); a loop that trains, checkpoints and predicts correctly
# lands near those, and a broken one (no learning, a wrong checkpoint, a
# wrong label map) far below half. 0.80 sits more than 35 per-case stds
# under the records: it catches a broken loop and not the noise of one run.
QUALITY_DICE_FLOOR = 0.80
QUALITY_MC_CASES, QUALITY_MC_EPOCHS = 12, 20
# Launches per forward of both recipes' U-Net (depth 3, 8 base filters,
# fused decoder): the 1-channel stem stays on cuDNN; enc0_conv2 8->16,
# enc1 16->16 and 16->32, enc2 32->32 and 32->64, dec1_conv2 32->32 and
# dec0_conv2 16->16 take K2 (no C_in is a multiple of 128, so K1 never
# runs); dec1_conv1 and dec0_conv1 take K3.
QUALITY_PER_FORWARD = {"conv3x3": 0, "conv3x3_flat": 7,
                       "up_concat_conv3x3_kernel": 2}


def quality_phase(torch, work: Path, smi: str) -> dict:
    """The parity recipe at its full 30 epochs (bf16, both kernel switches
    on) through ``tools/torch_parity_dice.py``'s dataset and config and
    ``train.main`` -> ``predict.main`` -> ``evaluate.main``: the last
    epoch's loss below the first, no dice-collapse warning, the best
    checkpoint restored (its epoch and validation loss the log's best) and
    the final state reloaded bit for bit, the served model equal to the
    checkpoint, a {0, 1} label map per validation case, ``scores.csv`` with
    its columns, launches exactly one forward's worth per train or
    validation step and per predicted batch, and the held-out mean hard
    Dice at least ``QUALITY_DICE_FLOOR``. Then ``QUALITY_MC_EPOCHS`` epochs
    of the multi-class recipe on ``QUALITY_MC_CASES`` cases through the
    same entry points, for mechanics only: the per-label dice columns in
    the log, the weighted-dice loss falling, label maps in {0, 1, 2, 4},
    launches exact."""
    import csv
    import math

    import numpy as np

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_multiclass_quality as mc
    import torch_parity_dice as parity
    import torch_quality_common as common

    from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
    from fetal_mri_segmentation_tpu_torch.data.synthetic import (
        write_multiclass_dataset)
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        load_serving_model)
    from fetal_mri_segmentation_tpu_torch.models import build_model
    from fetal_mri_segmentation_tpu_torch.ops.patches import (
        compute_patch_indices)
    from fetal_mri_segmentation_tpu_torch.pipeline.generator import (
        get_number_of_patches, get_number_of_steps)
    from fetal_mri_segmentation_tpu_torch.training.checkpoint import (
        CheckpointIO)
    from fetal_mri_segmentation_tpu_torch.training.loop import (
        detect_dice_collapse)
    from fetal_mri_segmentation_tpu_torch.training.state import (
        create_train_state)
    from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
    from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti

    torch.backends.cudnn.allow_tf32 = True  # as the train phase
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}

    def fresh(cfg):
        return create_train_state(build_model(cfg, "cuda"), cfg)

    def steps(cfg, state):
        """Train steps per epoch (from the state's step count) and
        validation steps per epoch, from the dataset and the split."""
        if state.step % cfg.n_epochs:
            raise AssertionError(f"{state.step} steps over {cfg.n_epochs} "
                                 "epochs")
        with open_data_file(cfg.data_file) as data_file:
            validation = pickle_load(cfg.validation_file)
            n_v = get_number_of_steps(get_number_of_patches(
                data_file, validation, cfg.patch_shape,
                patch_overlap=cfg.validation_patch_overlap,
                skip_blank=cfg.skip_blank), cfg.validation_batch_size)
        return state.step // cfg.n_epochs, n_v, validation

    def check_launches(tag, cfg, run, state, labels):
        """Exactly one forward's worth per train or validation step and
        per predicted batch; every predicted case a label map of
        ``labels`` at the image shape."""
        n_t, n_v, validation = steps(cfg, state)
        per_case = math.ceil(len(compute_patch_indices(
            cfg.image_shape, cfg.patch_shape, 0)) / B)
        want = {"train.main": cfg.n_epochs * (n_t + n_v),
                "predict.main": per_case * len(validation)}
        for entry, forwards in want.items():
            got = run["launches"][entry]
            launches[f"{tag} {entry}"] = got
            need = {k: n * forwards for k, n in QUALITY_PER_FORWARD.items()}
            if got != need or not forwards:
                raise AssertionError(f"{tag} {entry} launched {got}, not "
                                     f"{need} ({forwards} forwards)")
        cases = sorted(os.listdir(run["pred_dir"]))
        if run["n_predicted"] != len(validation) or len(cases) != len(
                validation):
            raise AssertionError(f"{tag}: predicted {cases}")
        for case in cases:
            label = load_nifti(os.path.join(run["pred_dir"], case,
                                            "prediction.nii.gz"))
            values = set(np.unique(label.get_fdata()).tolist())
            if tuple(label.shape) != tuple(cfg.image_shape) or not (
                    values <= labels):
                raise AssertionError(f"{tag} {case}: {label.shape}, "
                                     f"values {sorted(values)}")
        return n_t, n_v

    # 1. the parity recipe, at its full 30 epochs
    out = work / "parity"
    out.mkdir()
    t0 = time.perf_counter()
    config = parity.make_config(str(out), parity.build_dataset(str(out)))
    build_s = time.perf_counter() - t0
    if not (config.use_pallas_conv and config.use_pallas_dec0
            and config.compute_dtype == "bfloat16"
            and config.n_epochs == parity.EPOCHS):
        raise AssertionError(f"parity config {config}")
    run = common.run_mains(config, str(out / "cases"), str(out), [1],
                           device="cuda", overlap=0, verbose=False)
    state = run["state"]
    n_t, n_v = check_launches("parity", config, run, state, {0.0, 1.0})
    rows = common.log_rows(config.training_log)
    loss = [float(r["loss"]) for r in rows]
    dice = [float(r["dice_coefficient"]) for r in rows]
    val_loss = [float(r["val_loss"]) for r in rows]
    if len(rows) != config.n_epochs or not loss[-1] < loss[0]:
        raise AssertionError(f"parity: {len(rows)} epochs, loss {loss}")
    if any(detect_dice_collapse(dice[:i + 1]) for i in range(len(dice))):
        raise AssertionError(f"parity: the dice-collapse warning fired "
                             f"(training dice {dice})")
    best = CheckpointIO(config.model_file)
    restored, epoch, best_val, _ = best.restore(fresh(config))
    if best_val != min(val_loss) or epoch != val_loss.index(best_val) + 1:
        raise AssertionError(f"parity checkpoint: epoch {epoch}, best "
                             f"{best_val}; log {val_loss}")
    served = load_serving_model(config, device="cuda")
    for (n, a), b in zip(restored.model.state_dict().items(),
                         served.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"parity: served {n} differs from the "
                                 "checkpoint")
    final = CheckpointIO(str(out / "final.pt"))
    final.save(state, epoch=config.n_epochs, best_val=best_val)
    reloaded = fresh(config)
    final.restore(reloaded)
    for (n, a), b in zip(state.model.named_parameters(),
                         reloaded.model.parameters()):
        moments_a = state.optimizer.state[a]
        moments_b = reloaded.optimizer.state[b]
        if not (torch.equal(a, b) and all(torch.equal(
                moments_a[k], moments_b[k]) for k in ("mu", "nu"))):
            raise AssertionError(f"parity: reloaded {n} differs")
    with open(run["scores_csv"]) as f:
        table = list(csv.reader(f))
    scores = [row["label_1_dice"] for row in run["rows"].values()]
    if table[0] != ["", "label_1_dice", "empty_truth"] or len(table) != len(
            scores) + 1 or not all(np.isfinite(scores)):
        raise AssertionError(f"parity scores.csv {table}")
    mean = float(np.mean(scores))
    print(f"quality parity recipe ({config.n_epochs} epochs, {n_t} + {n_v} "
          f"steps an epoch, bf16, kernels on): loss {loss[0]:.6g} -> "
          f"{loss[-1]:.6g}, training dice {dice[0]:.6g} -> {dice[-1]:.6g}; "
          f"best checkpoint epoch {epoch} restored, the final state and "
          f"its Adam moments reloaded bit for bit; held-out hard Dice "
          f"{', '.join(f'{s:.4f}' for s in scores)}, mean {mean:.4f} >= "
          f"floor {QUALITY_DICE_FLOOR} (recorded: JAX "
          f"{parity.JAX_RECORDED_MEAN}, CPU-Keras "
          f"{parity.KERAS_RECORDED_MEAN}); dataset {build_s:.4f} s, "
          + ", ".join(f"{k} {v:.4f} s" for k, v in run["seconds"].items())
          + f"; {common.launch_line(run['launches'])} ({smi})", flush=True)
    if not mean >= QUALITY_DICE_FLOOR:
        raise AssertionError(f"parity: held-out mean hard Dice {mean} < "
                             f"{QUALITY_DICE_FLOOR}")
    del state, restored, reloaded, served, run
    torch.cuda.empty_cache()

    # 2. the multi-class recipe, mechanics only
    out = work / "multiclass"
    write_multiclass_dataset(str(out / "cases"), n_cases=QUALITY_MC_CASES,
                             shape=mc.IMAGE)
    config = mc.make_config(str(out), QUALITY_MC_EPOCHS)
    regions = {"whole": list(mc.FOREGROUND)}
    run = common.run_mains(config, str(out / "cases"), str(out),
                           mc.FOREGROUND, device="cuda", overlap=0,
                           regions=regions, verbose=False)
    n_t, n_v = check_launches("multiclass", config, run, run["state"],
                              {0.0, 1.0, 2.0, 4.0})
    rows = common.log_rows(config.training_log)
    columns = [f"{p}label_{i}_dice_coef" for i in range(config.n_labels)
               for p in ("", "val_")]
    missing = [c for c in columns if c not in rows[0]]
    loss = [float(r["loss"]) for r in rows]
    if missing or len(rows) != config.n_epochs or not loss[-1] < loss[0]:
        raise AssertionError(f"multiclass: {len(rows)} epochs, missing "
                             f"{missing}, loss {loss}")
    summary = mc.summarize(run["rows"], regions)
    print(f"quality multi-class recipe ({QUALITY_MC_CASES} cases, "
          f"{config.n_epochs} epochs, {n_t} + {n_v} steps an epoch): "
          f"weighted-dice loss {loss[0]:.6g} -> {loss[-1]:.6g}; last "
          f"epoch's " + ", ".join(
              f"{c} {float(rows[-1][c]):.4f}" for c in columns
              if not c.startswith("val_"))
          + "; held-out hard Dice (mean, min) " + ", ".join(
              f"{k} ({m:.4f}, {lo:.4f})" for k, (m, lo) in summary.items())
          + "; " + ", ".join(f"{k} {v:.4f} s"
                             for k, v in run["seconds"].items())
          + f"; {common.launch_line(run['launches'])} ({smi})", flush=True)
    return launches


# The bench phase: `python -m fetal_mri_segmentation_tpu_torch.bench
# --quick` as a user runs it, once with each switch setting. Its composite
# runs the depth-3, 32-filter U-Net: 1 warm-up step + 3 trials x 5 x 8
# steps + 20 steps = 141 training forwards, and 1 warm-up + 3 x 5 + 1
# sliding-window volumes of one 27-patch batch each = 17 forwards; 158 in
# all. A forward launches K1 for enc2's 128->128 and 128->256 convs and
# dec1_conv2 (C_in 128), K2 for enc0_conv2 32->64, enc1's 64->64 and
# 64->128 and dec0_conv2, K3 for dec1_conv1 and dec0_conv1.
BENCH_FORWARDS = 1 + 3 * 5 * 8 + 20 + 1 + 3 * 5 + 1
BENCH_LAUNCHES = {"K1": 3 * BENCH_FORWARDS, "K2": 4 * BENCH_FORWARDS,
                  "K3": 2 * BENCH_FORWARDS}  # 474 / 632 / 316
BENCH_KERNELS = {"K1": "conv3x3", "K2": "conv3x3_flat",
                 "K3": "up_concat_conv3x3_kernel"}
BENCH_QUICK_NAMES = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_QUICK_DETAIL = {"train_step_sec", "whole_volume_infer_sec", "device",
                      "host_loadavg", "host_canary_sec", "kernels"}
BENCH_TIMEOUT_S = 300


def bench_phase(torch, work: Path, smi: str) -> dict:
    """The port's bench entry with ``--quick``, as a subprocess with the
    switches off and then on: exit code 0, one JSON line on stdout with the
    quick names, a positive ``value``, ``detail.device`` the card, and each
    kernel's launches over the composite exactly 0 off and
    ``BENCH_LAUNCHES`` on. Returns the launches by kernel name."""
    launches = {}
    for switches in ("off", "on"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fetal_mri_segmentation_tpu_torch.bench",
             "--quick", "--kernels", switches], cwd=ROOT,
            capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"bench --kernels {switches} exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        line = json.loads(lines[-1])
        detail = line.get("detail", {})
        want = (BENCH_LAUNCHES if switches == "on"
                else dict.fromkeys(BENCH_LAUNCHES, 0))
        print(f"bench --quick --kernels {switches}: {seconds:.4f} s, value "
              f"{line.get('value')} {line.get('unit')}, train_step_sec "
              f"{detail.get('train_step_sec')}, whole_volume_infer_sec "
              f"{detail.get('whole_volume_infer_sec')}, vs_baseline "
              f"{line.get('vs_baseline')}, device {detail.get('device')!r}, "
              f"kernels {detail.get('kernels')} (want {want})", flush=True)
        if len(lines) != 1 or set(line) != BENCH_QUICK_NAMES or set(
                detail) != BENCH_QUICK_DETAIL:
            raise AssertionError(f"bench --kernels {switches}: {lines}")
        if not line["value"] > 0 or detail["device"] != smi:
            raise AssertionError(f"bench --kernels {switches}: value "
                                 f"{line['value']}, device {detail['device']}")
        if detail["kernels"] != {"switches": switches, "launches": want}:
            raise AssertionError(f"bench --kernels {switches}: "
                                 f"{detail['kernels']}, not {want}")
        launches[switches] = detail["kernels"]["launches"]
    return {name: {s: launches[s][k] for s in launches}
            for k, name in BENCH_KERNELS.items()}


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

    stats, halo_stats = {}, {}
    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    kernel_phase(torch, stats, halo_stats)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    norm = norm_phase(torch)
    seconds["norm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    norm["train"] = norm_train_phase(torch)
    seconds["norm_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adam = adam_phase(torch)
    seconds["adam"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    swin = swin_phase(torch)
    swin["train"] = swin_train_phase(torch)
    seconds["swin"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mednext_run = mednext_phase(torch)
    seconds["mednext"] = time.perf_counter() - t0
    results = {}
    for name, phase in (("slice", slice_phase), ("train", train_phase),
                        ("parity", lambda t, w: parity_phase(
                            t, w, smi.splitlines()[0])),
                        ("serve", serve_phase), ("isensee", isensee_phase),
                        ("experiment", experiment_phase),
                        ("scale", lambda t, w: scale_phase(
                            t, w, smi.splitlines()[0])),
                        ("spatial", lambda t, w: spatial_phase(
                            t, w, smi.splitlines()[0])),
                        ("interop", interop_phase),
                        ("fold", lambda t, w: fold_phase(
                            t, w, smi.splitlines()[0])),
                        ("native", lambda t, w: native_phase(
                            t, w, smi.splitlines()[0])),
                        ("quality", lambda t, w: quality_phase(
                            t, w, smi.splitlines()[0])),
                        ("bench", lambda t, w: bench_phase(
                            t, w, smi.splitlines()[0]))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            results[name] = phase(torch, Path(work))
        seconds[name] = time.perf_counter() - t0
    (launches, train_launches, parity_launches, serve_launches, isensee,
     experiment, scale, spatial, interop, fold, native_launches,
     quality, bench) = results.values()
    print("phase seconds: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in seconds.items())
          + f"; {time.perf_counter() - start:.4f} since the script started",
          flush=True)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "train_launches": train_launches[name],
                "parity_launches": parity_launches[name],
                "serve_launches": {path: counts[name] for path, counts
                                   in serve_launches.items()},
                "isensee_launches": {path: counts[name] for path, counts
                                     in isensee["launches"].items()},
                "isensee_forward": isensee["kernels"].get(name),
                "experiment_launches": {path: counts[name] for path, counts
                                        in experiment.items()},
                "scale_launches": {path: counts[name] for path, counts
                                   in scale.items()},
                "spatial_launches": {path: counts[name] for path, counts
                                     in spatial.items()},
                "export_launches": {path: counts[name] for path, counts
                                    in interop.items()},
                "fold_launches": {path: counts[name] for path, counts
                                  in fold.items()},
                "native_launches": {path: counts[name] for path, counts
                                    in native_launches.items()},
                "quality_launches": {path: counts[name] for path, counts
                                     in quality.items()},
                "bench_launches": bench[name],
                "halo_forward": halo_stats[name],
                **stats[name]}
               for name, (src, replaces) in KERNELS.items()]
    kernels.append({"name": "instance_norm_act", "route": "cuda",
                    "source": NORM_SOURCE, "replaces": None,
                    "isensee_launches": {
                        path: counts["instance_norm_act"] for path, counts
                        in isensee["launches"].items()
                        if "instance_norm_act" in counts},
                    "swin_launches": swin["launches"],
                    "swin_forward_ms": swin["forward_ms"],
                    "mednext_launches": {
                        "forward": mednext_run["launches"],
                        "train": mednext_run["train_launches"]}, **norm})
    kernels.append({"name": "keras_adam", "route": "cuda",
                    "source": ADAM_SOURCE, "replaces": None,
                    "train_launches": train_launches["keras_adam"],
                    "isensee_launches": {
                        path: counts["keras_adam"] for path, counts
                        in isensee["launches"].items()
                        if "keras_adam" in counts},
                    "mednext_launches": mednext_run["adam_launches"],
                    **adam})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
