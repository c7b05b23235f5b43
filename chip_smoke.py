#!/usr/bin/env python3
"""Smoke run of keymorph_tpu_torch on one NVIDIA GPU (the quickest proof that
the port builds, launches and registers on the card).

    python3 chip_smoke.py [--seed N] [--plant-fault KIND]

``--seed`` (0 unless given) seeds the weights, the volumes and every
phase's inputs; the tolerances do not depend on it. ``--plant-fault``
(``warp_grad_plane``: the warp-gradient kernel's first plane zeroed;
``input_grad_half``: the conv input-gradient kernel's output halved;
``weight_grad_half``: the conv weight-gradient kernel's output halved) is a
control of phases 6, 10, 12 and 17's rule: it wraps that kernel with the
fault, runs phases 5, 6 and 10, phase 12's kernel steps and (for
``warp_grad_plane``) phase 17 (a)'s step check only, and exits 0 only if
each step comparison whose path holds the faulty kernel fails (phase 12's
pretrain step has no warp gradient, phase 17's fp32 nets no conv kernel);
it prints no kernels line and no ``ok`` line.

Phases (each prints its lines; any failure raises, so the exit code is not 0):

  0. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
     the time to build the CUDA kernels from ``keymorph_tpu_torch/csrc``;
  1. each kernel against its plain PyTorch version on the card at the main
     paths' shapes (256^3 input for serving, 128^3 for training): max abs
     error against the stated tolerance, kernel and plain times (CUDA
     events), the time of one PyTorch library call that computes the same
     function where there is one (``F.conv3d`` in bf16, ``F.grid_sample`` and
     its backward; never called by the port), and the kernel's bound: the
     least time the card could take, from the bytes moved and the operations
     done. The conv runs at ten shapes of the U-Net (e0c1, e0c2, d1c2, e3c2
     flat; d1c1 and d0c1 as upconv, d1c1 as parts; the input gradients of
     e0c2, d1c1 and d1c2) with its achieved TFLOP/s, and at d0c1 (K = 27*384)
     kernel and plain version are each held against a float64 conv; the
     conv weight gradient at the 12 convs of the 128^3 training net, against
     its plain version per weight within WGRAD_TOL of the sum of its terms'
     magnitudes, its library call ``torch.nn.grad.conv3d_weight`` in bf16 on
     the materialized input, its bound counting each source at its own
     resolution; the residual U-Nets' serving kernels at every shape of the
     256^3 ResidualUNetSE3D (the residual-epilogue conv and the scSE gate at
     each of its four levels, three 2x max-pools, four lifts, three
     transposed convs against bf16 ``F.conv_transpose3d``;
     ``_phase1_residual_net``) and their backward's kernels at every shape of
     the 128^3 training net (the transposed convs' input and weight
     gradients, the scSE gate's backward; ``_phase1_residual_backward``); the
     keypoint head's one read of 256 bf16
     heatmaps at 128^3 and 256^3 (``heatmap_com``; library: ``torch.relu``
     and the three marginal ``torch.sum``s), kernel and plain version each
     held against a float64 centre of mass (``_phase1_head``); the U-Nets'
     final 1x1 conv, 32 -> 256 channels at 128^3 and 256^3 and the training
     net's 32 -> 128 at 128^3 (``final_conv1x1``; library: a bf16
     ``torch.matmul`` plus the bias; ``_phase1_final_conv``); the three
     TPS kernels and their plain versions are each held against the float64
     evaluation of the same formula, for splines fitted at lmbda 1, 1e-4 and
     1e-6 (the bottom of the range training draws from); the TPS backward
     also at the 256^3 step's shape; the warp (trilinear and nearest) at
     256^3 C=1 and 128^3 C=14 (the Dice step's one-hot channels) and its
     gradient at 128^3 C=1, 4 and 14, each timed with the L2 cleared before
     every call (the time held against the bound) and warm; the register
     CLI's shapes: ``tps_flow`` at every voxel centre of 256^3 (T = 128) and
     the warp at 256^3 C=14; past the wrappers' old limits: the TPS kernels
     at T = 4096 (``tps_planes`` on a 64^3 grid, ``tps_flow`` and the
     backward on 32^3 points; the forward kernels held against float64, as
     the T = 128 rows also are) and ``tps_flow`` and the warp at B = 70000
     on 4^3 volumes;
  2. end to end: the flagship config (TruncatedUNet3D f_maps=32, 4 levels,
     1 truncated, bf16; 128 keypoints; TPS lmbda=1) at 256^3 with seeded
     random weights serves 3 pairs through the kernels: extract fixed and
     moving -> align_pair("tps", compute_grid="planes") -> align_planes,
     under ``torch.no_grad()``; pair 0 is also served through the grid form
     (``compute_grid=True`` -> ``align_img``: the TPS kernel's points mode).
     Every kernel of the path must have launched and no plain version run;
  3. the same 3 pairs through the plain versions on the card. Each kernel
     stage of phase 2 is held on its own inputs (planes against the plain
     spline on the kernel path's keypoints, warped image against the plain
     warp on the kernel path's planes), and the end-to-end distances
     (keypoints, planes) against each pair's yardstick: the plain path
     against itself on volumes moved by half a bf16 ulp;
  4. one steady pair through the kernels under ``torch.profiler``: the
     device's busy time, its idle share and the device time by kernel name;
  5. training: the canonical step (the same net with 128 keypoints,
     ``tps_loguniform``, MSE, 64-keypoint subsample, Adam 3e-6, batch 1) at
     128^3, full width and depth, on synthetic seeded volumes: one first step
     with injected lambda and keypoint subset, then ``run_train`` with
     ``debug_mode`` takes its 3 steps. Every loss and gradient must be finite,
     every parameter with a gradient must change, every kernel of the
     training path must launch and no plain version may run;
  6. the same first step with every kernel replaced by its plain version on
     the card, compared with phase 5's: loss, grad_norm, the whole gradient
     and every parameter's gradient, each within its floor or twice what
     the plain step shows on volumes moved by half a bf16 ulp (the whole
     gradient within its floor alone); and the step's alignment alone in
     fp32, its gradient to the keypoints through the kernels against the
     plain versions;
  7. one training step at 256^3 on the serving net (again with block-level
     gradient checkpointing if the first runs out of memory): wall time and
     peak memory;
  8. one steady 128^3 training step under ``torch.profiler``: idle share and
     device time by kernel name;
  9. the registration API on the serving net at 256^3: ``KeyMorph`` serves
     one pair with ``["affine", "rigid", "tps_1"]`` and the aligned points,
     in normalized coordinates and in real-world coordinates (anisotropic
     scanner affines, the moving one rotated), and with approximate TPS (64
     of the 128 keypoints as centres, also through the planes path); every
     grid is warped with ``align_img``, the affine one also through
     ``affine_register_warp``; then ``groupwise_register`` of 4 subjects at
     128^3 with ``["affine", "tps_1"]`` and 5 iterations. Every kernel of
     these paths must launch and no plain version run; each kernel stage is
     then held on its own inputs against its plain version (the real-world
     spline also against float64, in normalized units; the batched
     extraction against the plain path with phase 3's yardstick). Prints
     times per transform type (extract, align, warp), peak memory, the
     groupwise keypoints' spread before and after, and the rigid fit's SVD
     on the card;
 10. the canonical 128^3 step as affine, rigid and real-world ``tps_0.1``
     registration (phase 5's initial weights and first pair), each held
     against the same step on the plain versions under phase 6's rule; the
     conv, input-gradient, warp and warp-gradient kernels (and ``tps_flow``
     in the real-world step) must launch;
 11. the register CLI at full width: an IXI-like pair (256 x 256 x 150 at
     0.94 x 0.94 x 1.2 mm, the moving scan turned 10 degrees; Gaussian-blob
     phantoms with 14-label segmentations) written as .nii.gz, the flagship
     net's seeded weights saved as a reference-format ``.pt``, then
     ``keymorph_tpu_torch.cli.register.main`` at ``--size 256`` with rigid,
     affine and tps_1, the metrics mse, harddice, harddiceroi, hausd, jdstd
     and jdlessthan0 and the augmentations rot0 and rot45, under
     torch.profiler. Prints the wall time per stage, the device's busy share,
     the peak memory, the gzip reader and the launches (the warp's by mode
     and channels). Checks the metric keys and artifact files against the
     harness's naming schemes; the augmentation and every warp against the
     plain warp on the CLI's own inputs and grids (``WARP_ABS``, labels
     exactly); every metric JSON against a float64 recomputation on the CPU;
     the saved keypoints against the plain route with phase 3's yardstick.

 12. the main CLI, pretraining, the same-resolution step and the other
     backbones at full width: five IXI-like subjects (REG_SHAPE, 14 labels;
     three for training, a T1 and a T2 for testing) written as .nii.gz and
     listed in a CSV; ``keymorph_tpu_torch.cli.run.main`` pretrains the
     flagship net (``--run_mode pretrain --debug_mode --img_size 128 128
     128``), hands its weights to a same-resolution ``tps_loguniform`` run
     (``--load_weights_only --train_same_resolution --debug_mode``), resumes
     that run for one more epoch (``--resume_latest``) and evaluates it
     (``--run_mode eval --debug_mode``); the checkpoints, ``train_log.jsonl``
     and the summaries must hold keymorph_tpu's keys, the resumed run must
     begin at epoch 3 and the handoff must restart the optimizer. Then the
     pretrain step (a preprocessed subject, 128 sampled reference points)
     and the same-resolution step (a smooth pair at REG_SHAPE, model size
     128^3, 64 of 128 keypoints, MSE), each through the kernels and on the
     plain versions under phase 6's rule, its yardstick moving only the
     net's input (the pretrain step's augmentation warps through the kernel
     in both routes: that warp is bit-exact with its plain version, phase
     1), the same-resolution step's alignment alone at REG_SHAPE on the grid
     path as in phase 6, and the resize against float64; the bf16
     'cr' U-Net's heatmaps through the kernels against its plain route
     (phase 3's yardstick rule); one 128^3 training step each (after a
     first) for the fp32 ConvNet, the fp32 ResidualUNetSE3D (its module),
     the bf16 ResidualUNetSE3D (on the kernels, its backward's kernels
     included) and the linear keypoint head on the flagship net, on CUDA
     events, with peak memory.
     Every kernel of these paths must launch and no plain version run.

 13. 2D registration, LC2, brain extraction and the parts form, at full
     width: (a) ``KeyMorph.forward`` of ``build_model(Config(dim=2,
     backbone="unet", num_keypoints=128))`` (UNet2D f_maps 64, 4 levels,
     fp32, seeded weights) on 8 Gaussian-blob image pairs at 256^2 with
     rigid, affine and tps_1 and the aligned points, every grid warped
     bilinear (images) and nearest (4-label maps): extract, align and warp
     times on CUDA events, peak memory; (b) the 2D training step (batch 8 at
     256^2, MSE, 64 of 128 keypoints, augmentation (0.1, 0.1, 0.3, 0.05)) as
     affine and as tps_loguniform: a first step with injected draws, then 3
     more; (c) ``brain_extract.extract_brain`` with seeded ``SimpleUnet``
     weights on an IXI-like scan resized to 256^3; (d) ``LC2()`` on 4 odd
     cubes of 51^3 and ``ImageLC2(51, (5,))`` on one 255^3 pair (125
     patches). Each is held against the same call on the CPU (a, b, c) or
     float64 (d): within the larger of a stated floor and CARD_CPU_FACTOR x
     the CPU route's distance from the same call in float64; the brain mask
     equal but at voxels that near the threshold, and cleaned by keymorph_tpu's
     rule; (a)-(d) may move no kernel and no plain-version counter but the
     head kernel's (the 2D keypoints served on the card). (e) the
     flagship net's extraction of one IXI-like scan at its native 256 x 256
     x 150 through the kernel executor, where the decoders' skips are not
     twice the deeper tensor and the concat-free parts form runs (it must
     launch), held against the plain route under phase 3's yardstick.

 14. the parallel layer (``keymorph_tpu_torch/parallel``) on
     torch.distributed, the flagship net with seeded weights: (a) a world of
     1 on NCCL in this process: the sharded step at 128^3 (phase 5's config,
     injected lambda and subset) under phase 6's rule against the unsharded
     kernel step, and one 256^3 pair through ``make_sharded_register_fn``
     against the single-process kernel path, and a batch of 2 of those pairs
     against the pairs one by one, stage by stage on the same inputs
     (heatmaps, keypoints, the TPS fit, the flow, the warp; printed, not
     held); (b) a world of 2 on cuda:0 over
     gloo (NCCL refuses two ranks on one card), each rank a process of this
     script (``--phase14-rank``, joined with a deadline, killed on failure):
     the 2-rank step at 128^3 (batch 2) and its gradient all-reduce alone,
     4 pairs at 256^3 through ``make_sharded_register_fn``,
     ``groupwise_register(mesh=...)`` of 4 subjects at 128^3 (affine,
     tps_1), and one 256^3 pair through ``make_spatial_register_fn`` at
     'space' 2 (the U-Net's module path with halo exchanges, then the flow
     and the warp of each slab), and one pair each for the other backbones,
     heads and extents on 'space' 2 (P14_SPATIAL: the fp32 ConvNet at 256^3,
     the fp32 ResidualUNetSE3D at 128^3, the flagship with variance
     weighting at 256^3, the flagship at 150 x 256 x 256, whose far slab
     holds the remainder of its block of 8), host-clock times and peak
     memory by rank; then rank 0 holds
     the step under phase 6's rule, the register and groupwise keypoints and
     grids against the single-process kernel path and every spatial pair
     against its unsplit module path, each within phase 3's yardstick rule,
     and the spatial slab stages on their own inputs (TPS_ABS, WARP_ABS).
     Each path's kernels must launch on every rank; no plain version runs.

 15. the tools and the panels: (a) ``python -m keymorph_tpu_torch.cli.register``
     on phase 11's files with ``--visualize`` as a subprocess: without
     matplotlib (the card's machine has none) it must exit non-zero within
     30 s, naming matplotlib, having written no metric; with it, the panel;
     then ``viz._panel_arrays`` (the panels' device part: registration and
     warp) on one flagship 256^3 pair, bit for bit the same model's
     ``KeyMorph.forward`` + ``align_img``; (b) ``tools/tps_approx_bench`` at
     its defaults (256^3, K = 512, S = 128, 256) and ``--ranked`` at 128^3;
     (c) ``tools/warp_channels_bench`` at 256^3, C = 1, 6, 14 (the kernel
     against ``F.grid_sample`` and the byte bound, bit for bit its plain
     version); (d) ``tools/make_synthetic_dataset`` (4 subjects at 128^3) ->
     ``tools/center_volumes`` on the card and on the CPU (the volumes within
     ``WARP_ABS``, every centroid closer to the reference's); (e)
     ``tools/flops``: the flagship extraction's FLOPs and the MFU of phase
     2's steady extraction against 989 TFLOP/s; (f)
     ``tools/conv_microbench --size 256 --reps 3``: every conv stage of the
     flagship at its size, the kernel against bf16 ``F.conv3d`` and the
     bound. Each device path's kernels must launch and no plain version runs
     on it. The tools run at their
     own defaults and seeds; ``--seed`` moves the panels' pair and weights.

 16. the benchmark, the entry points and the pair example: (a)
     ``keymorph_tpu_torch.bench.run`` at 256^3 (the flagship net, 128
     keypoints, 8 chained registrations) with the stages and the batch rows
     at bs 1, 2, 4 and 8, its JSON line printed as ``python -m
     keymorph_tpu_torch.bench`` prints it, its first warped volume held bit
     for bit against phase 2's calls on the bench's own net and pair; (b)
     ``entry()`` on the card against the same forward on the CPU, on seeded
     blob volumes at 32^3, under phase 13's card-vs-CPU rule; (c)
     ``dryrun_multichip(2)``: two gloo ranks on the one card run every
     multi-device path at keymorph_tpu's tiny shapes; (d) the pair
     example's ``register_pair`` on phase 11's IXI-like pair at its default
     128^3 (its ``main`` refuses without matplotlib first), MSE and hard
     Dice against a float64 recomputation. Each path's kernels must launch
     and no plain version runs on it.

 17. the port's trained nets (``runs/torch_weight_parity``, written by
     ``python -m keymorph_tpu_torch.tools.weight_parity`` on the card): (a)
     ``train_port`` again at the committed truncated net's settings (affine
     MSE steps at 96^3, fp32 TruncatedUNet3D f_maps 8, 3 levels, 32
     keypoints, Adam 1e-4, the same pair and augmentation draws): its first
     step through the kernels against the plain versions under phase 6's
     rule, then the first P17_STEPS of the committed run's 600 steps, their
     mean loss every 100 steps beside the committed run's and their last
     50 steps' mean within P17_LOSS_REL of the committed run's over the same
     steps, ms a step on CUDA events; (b) both committed nets register the three
     configs' held-out pairs (the UNet's at 96^3, the truncated net's at
     128^3 in normalized and in real-world coordinates) with rigid, affine,
     tps_1, tps_0.1 and tps_0 through ``weight_parity.port_register`` on the
     card and on the CPU: keypoints, grids and the hard Dice of the warped
     one-hot segmentation under phase 13's card-vs-CPU rule (the float64
     backbone and head on the card, then the fp32 fit, grid and warp on the
     CPU). Each path's
     kernels must launch and no plain version runs on it.
 18. the residual cell's net: the 256^3 bf16 ResidualUNetSE3D (f_maps 32, 4
     levels, 256 keypoints, seeded weights) served through
     ``KeyMorphNet.features`` under no_grad with the counters set to 0 just
     before: each residual kernel launches once a layer of its kind and
     nothing else runs; heatmaps and keypoints against its plain route under
     phase 3's yardstick rule.

The line before the last is the kernels' JSON record (``launches`` summed
over the main paths of phases 2, 5, 9, 10, 11, 12, 13, 14, 15, 16, 17 and 18); the last line is
``{"ok": true, "device": {...}}``. Without CUDA it raises before printing
a result. The script imports neither jax nor keymorph_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
SPATIAL = (256, 256, 256)
N_PAIRS = 3
NUM_KEYPOINTS = 128
LMBDA = 1.0
UNET = dict(out_channels=NUM_KEYPOINTS, f_maps=32, num_levels=4, num_truncated_layers=1)

# tolerances, kernel vs plain version on the same inputs
CONV_REL_ULP = 2.0 ** -7   # one bf16 ulp of each output (same fp32 sum, other order)
# The tensor cores take the fp32 sum in another order than the plain version
# and do not round every partial sum to nearest, so outputs whose terms cancel
# differ by more than the FMA kernel's did, and more bf16 outputs land one ulp
# apart, which the stats (sums of the stored values) then carry. Phase 1
# measures what is needed at d0c1 (K = 27*384, the longest sums) and prints
# kernel and plain version each against a float64 conv of the same operands:
# over d0c1's first 16 z slices kernel vs plain needs a floor of 3.4e-6 (the
# kernel is 3.9e-6 from float64 beyond correct rounding, the plain version
# 4.6e-7) and the stats differ by 2.1e-5 (NVIDIA H100 80GB HBM3, 700.00 W).
CONV_FLOOR = 1e-5          # x max|out|: outputs that cancel to near zero
STATS_REL = 3e-5           # x max|stat|: fp32 sums of bf16 outputs that differ by ulps
TPS_ABS = 1e-5             # fp32 sum over 128 control points in another order; sqrt and
                           # log taken as one special-function instruction each
WARP_ABS = 0.0             # the kernel rounds every operation as the plain version
TPS_BWD_REL = 1e-4         # x max|ref|: fp32 sums over 2.1e6 grid points in another order
# The TPS kernels and their plain versions are each also held against the
# float64 evaluation of the same formula, at LMBDA, SMALL_LMBDA and MIN_LMBDA
# (training draws lmbda from [MIN_LMBDA, 10): as it falls the spline's weights
# grow and cancel): the kernel may be FLOAT64_FACTOR x as far from float64 as
# its plain version, or its tolerance above, whichever is larger.
SMALL_LMBDA = 1e-4
MIN_LMBDA = 1e-6
FLOAT64_FACTOR = 4.0
WARP_GRAD_REL = 1e-5       # x max|ref|: the same fp32 terms, FMA-contracted in the kernel
# The head kernel's and its plain version's fp32 sums are of nonnegative
# addends (the ReLU's), each rounded once a step: a chain of n roundings stays
# within n * 2^-24 of the sum, relatively; the kernel's chains are under 200
# at the main shapes, so a keypoint (2 S_k / S0 - 1) lies within HEAT_F64 of
# float64 (measured: ~5e-7 against the plain version; NVIDIA H100 80GB HBM3).
HEAT_F64 = 5e-5
# The conv weight gradient sums exact products of bf16 values in fp32, split
# across blocks by voxels and the splits then summed in order; its plain
# version sums the same products in cuBLAS's order. Each weight is held to
# WGRAD_TOL x S, S = sum |u| |g_v| of its terms (an fp32 sum's error scales
# with S, not with the result, which cancels); the GPU tests measured at most
# 4.1e-7 of S over 24 shapes (NVIDIA H100 80GB HBM3, 700.00 W).
WGRAD_TOL = 1e-5
# phase 3, plain path vs kernel path end to end: bf16 conv outputs may differ
# by 1 ulp and the random-weight net and the TPS fit carry that on, so the
# tolerance is the larger of these floors and NOISE_FACTOR x what the plain
# path itself shows when its volumes move by PERTURB. Each kernel stage is
# also held on the kernel path's own inputs: planes TPS_ABS, warp WARP_ABS.
KEYPOINT_ABS = 1e-3        # normalized units (0.13 voxel at 256)
PLANES_ABS = 1e-3

# phases 6 and 10, the plain training step vs the kernel step on the same
# inputs: bf16 conv outputs may differ by one ulp between kernel and plain
# version, a few ReLU masks then flip, and the difference spreads through the
# backward (every cotangent is rounded to bf16 again at each conv). The loss,
# grad_norm and each parameter's gradient are held to the larger of their
# floor and NOISE_FACTOR x what the plain step itself shows when its input
# volumes move by PERTURB; a parameter may also lie within GRAD_WHOLE_FLOOR x
# the whole gradient's norm (the first GroupNorm's scalar weight and bias
# nearly cancel, while the noise they receive scales with their
# neighbours'). Phase 12 holds its steps to the same rule with only the
# net's input moved by PERTURB: the same-resolution step resizes before the
# net and takes its loss at the original resolution, where noise would
# reach the loss unfiltered. The whole gradient is held to its floor alone: the yardstick
# reads 0.15-0.44 there, and a zero gradient reads 1. The step's alignment
# alone (align_pair, then the warp and MSE, in fp32 on the keypoints of the
# plain extraction) is held sharper: its gradient to the keypoints, kernels
# vs plain versions, within ALIGN_GRAD_REL; in real-world coordinates within
# ALIGN_GRAD_REL_RW, since the spline in millimetres lies ~1e-3 (normalized)
# from float64 in either route (phase 9). Measured on NVIDIA H100 80GB HBM3,
# 700.00 W, seeds 0-2: 4.0e-8-8.7e-7, real world 1.9e-3-8.1e-3; with the
# warp gradient's first plane zeroed 0.11-0.82. ``--plant-fault`` shows what
# a wrong kernel reads under this rule.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_NORM_REL = 5e-2
TRAIN_GRAD_WHOLE_REL_L2 = 3e-1  # all parameters' gradients as one vector
TRAIN_GRAD_REL_L2 = 5e-2   # per parameter, |g_kernel - g_plain| / |g_plain|
GRAD_WHOLE_FLOOR = 5e-3    # x the whole gradient's norm, for one parameter
ALIGN_GRAD_REL = 1e-5      # relative L2, over the fixed and moving keypoints' gradients
ALIGN_GRAD_REL_RW = 5e-2
NOISE_FACTOR = 2.0
PERTURB = 2.0 ** -9        # half a bf16 ulp (relative)

TRAIN_SPATIAL = (128, 128, 128)
TRAIN_KEYPOINTS = 64       # max_train_keypoints
TRAIN_LR = 3e-6

REPLACES = {
    "conv": "keymorph_tpu/ops/pallas/conv3d.py:337",
    "conv_grad": "keymorph_tpu/ops/pallas/conv3d.py:159",
    # no Pallas kernel: the 27 XLA einsums of _conv_bwd
    "conv_wgrad": "keymorph_tpu/ops/pallas/conv3d.py:1199",
    "tps": "keymorph_tpu/ops/pallas/tpsflow.py:60",
    "tps_bwd": "keymorph_tpu/ops/pallas/tpsflow.py:275",
    "warp": "keymorph_tpu/ops/pallas/resample3d.py:110",
    "warp_grad": "keymorph_tpu/ops/pallas/resample3d.py:393",
    # no Pallas kernel: keymorph_tpu runs the residual nets' flax modules
    "resblock": "none: flax nn.Conv, keymorph_tpu/models/unet.py:176",
    "tconv": "none: flax nn.ConvTranspose, keymorph_tpu/models/unet.py:359",
    "scse": "none: flax ChannelSpatialSE, keymorph_tpu/models/unet.py:161",
    "pool": "none: flax nn.max_pool, keymorph_tpu/models/unet.py:261",
    # no Pallas kernel: keymorph_tpu's centre of mass is plain XLA
    "head": "none: XLA relu and sums, keymorph_tpu/models/layers.py:19",
    # no Pallas kernel: keymorph_tpu's final 1x1 conv is an XLA einsum
    "final": "none: XLA einsum, keymorph_tpu/models/fast_unet.py:504",
}

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bounds
# below are the least time the card could take for a kernel's work.
PEAK_BF16 = 989e12         # FLOP/s, tensor cores
PEAK_FP32 = 67e12          # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12       # bytes/s of device memory
# special functions (sqrt, log, reciprocal): 16 lanes per SM and clock on
# 132 SMs at the 1.98 GHz boost clock (Hopper architecture white paper)
PEAK_SFU = 132 * 16 * 1.98e9


def _bound(nbytes, *op_times):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the given operation times (seconds)."""
    tb, to = nbytes / PEAK_BYTES, max(op_times)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _conv_bound(cin, cout, spatial, in_bytes):
    """A 3x3x3 conv: 2*27*Cin*Cout FLOPs per voxel on the bf16 tensor cores;
    its inputs read once, bf16 weights, the bf16 output written once."""
    n = spatial[0] * spatial[1] * spatial[2]
    return _bound(in_bytes + 27 * cin * cout * 2 + n * cout * 2,
                  2.0 * 27 * cin * cout * n / PEAK_BF16)


def _tps_bound(n, t, nbytes, sfu_per_eval, flops_per_eval):
    """T*N radial-basis evaluations: special-function and fp32 rates."""
    return _bound(nbytes, n * t * sfu_per_eval / PEAK_SFU,
                  n * t * flops_per_eval / PEAK_FP32)


def _import_port():
    sys.path.insert(0, str(ROOT))
    import keymorph_tpu_torch

    pkg = Path(keymorph_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"keymorph_tpu_torch imported from {pkg}, not from {ROOT}")
    return keymorph_tpu_torch


def _cuda_ms(fn, reps):
    """Mean milliseconds per call: one warm-up call, then ``reps`` calls
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SPIN_CYCLES = 10 ** 6       # ~0.5 ms of the device at its 1.98 GHz boost clock


def _call_ms(fn, reps, flush=None):
    """Median milliseconds of ``reps`` single calls, each on its own CUDA
    events. Before each the device spins for SPIN_CYCLES
    (``torch.cuda._sleep``), so the host has enqueued the call before the
    device reaches it and the events time the device's work alone, however
    long the wrapper takes on the host (back to back, as ``_cuda_ms`` times,
    a call shorter than its wrapper's host time reads the host). With
    ``flush`` (5x the 50 MB L2) read first, outside the events, the call
    finds its inputs in device memory, as the bound counts them; the flush
    reads rather than writes, so no dirty lines are left whose write-back
    would fall inside the call. Without it the call finds what its previous
    run left in L2. (The median: a call now and then lands behind a stall.)"""
    import torch

    fn()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _ulp_ok(k, p):
    """(max abs err, ok): bf16 values within one bf16 ulp of the plain
    version's (plus CONV_FLOOR of the range for values that cancel)."""
    k, p = k.float(), p.float()
    err = (k - p).abs()
    ok = bool((err <= CONV_REL_ULP * p.abs() + CONV_FLOOR * p.abs().max()).all())
    return err.max().item(), ok


def _conv_check(k, p):
    """(max abs err, ok) of bf16 conv outputs and their stats."""
    (ko, ks), (po, ps) = k, p
    err, ok = _ulp_ok(ko, po)
    for a, b in zip(ks, ps):
        ok &= bool(((a - b).abs() <= STATS_REL * b.abs().max()).all())
    return err, ok


def _ncdhw(xf, spatial):
    """Flat (Z, C, Y*X) -> contiguous (1, C, Z, Y, X), the library's layout."""
    Z, Y, X = spatial
    return xf.reshape(Z, -1, Y, X).permute(1, 0, 2, 3)[None].contiguous()


def phase1(torch, rng, dev):
    """Each kernel vs its plain version at the main paths' shapes; returns
    {kernel name: {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}}."""
    import torch.nn.functional as F

    from keymorph_tpu_torch.models.fast_unet import gn_affine_from_stats
    from keymorph_tpu_torch.ops import coords
    from keymorph_tpu_torch.ops.cuda import conv3d, resample3d, tpsflow
    from keymorph_tpu_torch.ops.cuda.conv3d import channel_stats
    from keymorph_tpu_torch.transforms import solvers

    def bf16(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                            device=dev).to(torch.bfloat16)

    def weights(cin, cout):
        return torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32)
                            / np.sqrt(27 * cin), device=dev)

    def gn(x, groups):
        c = x.shape[1]
        gamma = torch.tensor(rng.uniform(0.5, 1.5, c).astype(np.float32), device=dev)
        beta = torch.tensor(rng.normal(size=c).astype(np.float32) * 0.2, device=dev)
        return gn_affine_from_stats(channel_stats(x), gamma, beta, groups)

    def lib_conv(x_full, spatial, w, sc, sh, flip=False):
        """ms of one bf16 F.conv3d on the materialized (affined) input."""
        u = x_full.float()
        if sc is not None:
            u = u * sc[None, :, None] + sh[None, :, None]
        lhs = _ncdhw(u.to(torch.bfloat16), spatial)
        wb = w.to(torch.bfloat16)
        rhs = (wb.flip(0, 1, 2).permute(3, 4, 0, 1, 2) if flip
               else wb.permute(4, 3, 0, 1, 2)).contiguous()
        return _cuda_ms(lambda: F.conv3d(lhs, rhs, padding=1), 3)

    def record(name, err, ms, pms, lms, bound, what, tol, ok, flops=None, extra=None):
        row = {"max_abs_err": err, "ms": ms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": bound[0], "bound_by": bound[1], **(extra or {})}
        if name in results:  # a further shape of the same wrapper
            results[name].setdefault("more_shapes", []).append({"shape": what, **row})
        else:
            results[name] = {"shape": what, **row}
        lib = "none" if lms is None else f"{lms:.3f} ms"
        rate = "" if flops is None else f" ({flops / ms / 1e9:.1f} TFLOP/s)"
        print(f"phase1 {what}: max_abs_err={err!r} ({tol}): {ok}; kernel {ms:.4f} ms{rate}, "
              f"plain {pms:.3f} ms, library {lib}, bound {bound[0]:.4f} ms by {bound[1]}"
              + "".join(f", {k} {v!r}" for k, v in (extra or {}).items()))
        if not ok:
            raise AssertionError(f"{name} kernel disagrees with its plain version ({what})")

    def against_float64(name, tol, rel, run):
        """Kernel and plain version against float64 at the three lmbdas.
        ``run(lmbda)`` -> (kernel outputs, plain outputs, float64 outputs);
        with ``rel`` the distances are relative to max|float64 output|."""
        for lm in (LMBDA, SMALL_LMBDA, MIN_LMBDA):
            ks, ps, rs = run(lm)
            torch.cuda.synchronize()
            dists, ok = [], True
            for k, p_, r in zip(ks, ps, rs):
                top = r.abs().max().item() if rel else 1.0
                dk = (k.double() - r).abs().max().item() / top
                dp = (p_.double() - r).abs().max().item() / top
                ok &= dk <= max(tol, FLOAT64_FACTOR * dp)
                dists.append(f"kernel {dk!r}, plain {dp!r}")
            print(f"phase1 {name} against float64 at lmbda {lm:g}: {'; '.join(dists)}"
                  f"{' (x max|float64|, per output)' if rel else ''} (tol max({tol}, "
                  f"{FLOAT64_FACTOR} x plain)): {ok}")
            if not ok:
                raise AssertionError(f"{name} kernel is further from float64 than allowed")

    forms = {"flat": (conv3d.conv3x3_fused_flat, conv3d.conv3x3_fused_flat_plain),
             "parts": (conv3d.conv3x3_fused_flat_parts, conv3d.conv3x3_fused_flat_parts_plain),
             "upconv": (conv3d.conv3x3_fused_flat_upconv, conv3d.conv3x3_fused_flat_upconv_plain)}

    def conv_case(what, mode, xs, spatial, w, sc, sh, lms=None):
        """One forward conv shape: kernel vs plain (output and stats), times,
        library and bound. ``xs``: the conv's one or two sources."""
        kern, plain = forms[mode]
        args = (*xs, spatial, w, sc, sh)
        k = kern(*args, emit_stats=True)
        p = plain(*args, emit_stats=True)
        err, ok = _conv_check(k, p)
        torch.cuda.synchronize()
        ms = _cuda_ms(lambda: kern(*args, emit_stats=True), 5)
        pms = _cuda_ms(lambda: plain(*args, emit_stats=True), 3)
        if lms is None:
            full = xs[0] if len(xs) == 1 else torch.cat(
                [xs[0], conv3d.upsample_nearest_flat(xs[1], [d // 2 for d in spatial], spatial)
                 if mode == "upconv" else xs[1]], dim=1)
            lms = lib_conv(full, spatial, w, sc, sh)
        cin, cout = int(w.shape[3]), int(w.shape[4])
        n = spatial[0] * spatial[1] * spatial[2]
        record(kern.__name__, err, ms, pms, lms,
               _conv_bound(cin, cout, spatial, sum(x.numel() for x in xs) * 2),
               what, conv_tol, ok, flops=2.0 * 27 * cin * cout * n)
        return k, p, lms

    def grad_case(what, g_v, spatial, w, ca=None):
        """One input-gradient shape (one tensor, or split at ``ca``)."""
        ks = conv3d.conv3x3_input_grad(g_v, spatial, w, ca)
        ps = conv3d.conv3x3_input_grad_plain(g_v, spatial, w, ca)
        torch.cuda.synchronize()
        checks = [_ulp_ok(k, p) for k, p in zip(ks, ps) if k is not None]
        ms = _cuda_ms(lambda: conv3d.conv3x3_input_grad(g_v, spatial, w, ca), 5)
        pms = _cuda_ms(lambda: conv3d.conv3x3_input_grad_plain(g_v, spatial, w, ca), 3)
        cin, cg = int(w.shape[3]), int(w.shape[4])
        n = spatial[0] * spatial[1] * spatial[2]
        record("conv3x3_input_grad", max(e for e, _ in checks), ms, pms,
               lib_conv(g_v, spatial, w, None, None, flip=True),
               _conv_bound(cg, cin, spatial, g_v.numel() * 2), what, grad_tol,
               all(o for _, o in checks), flops=2.0 * 27 * cin * cg * n)

    def wgrad_case(what, ca, cb, cout, spatial, gen):
        """One weight-gradient shape: sources of ``ca`` channels at
        ``spatial`` and (``cb``) at half resolution, a random affine, a bf16
        cotangent; ``gen`` draws them on the card."""
        Z, Y, X = spatial
        lowres = cb > 0

        def draw(z, c, n, relu=True):
            x = torch.randn((z, c, n), generator=gen, device=dev)
            return (torch.relu(x) if relu else x).to(torch.bfloat16)

        xa = draw(Z, ca, Y * X)
        xb = draw(Z // 2, cb, (Y // 2) * (X // 2)) if lowres else None
        g_v = draw(Z, cout, Y * X, relu=False)
        cin = ca + cb
        sc = torch.rand(cin, generator=gen, device=dev) + 0.5
        sh = torch.randn(cin, generator=gen, device=dev) * 0.2
        args = (xa, xb, spatial, g_v, sc, sh, lowres)
        k = conv3d.conv3x3_weight_grad(*args)
        p = conv3d._weight_grad_plain(*args)
        u = (conv3d._full_input(xa, xb, lowres, spatial).float() * sc[None, :, None]
             + sh[None, :, None]).to(torch.bfloat16)
        mag = conv3d._weight_grad_plain(u.abs(), None, spatial, g_v.abs())
        err = (k - p).abs()
        ok = bool((err <= WGRAD_TOL * mag).all())
        ratio = (err / mag.clamp_min(1e-30)).max().item()
        ms = _cuda_ms(lambda: conv3d.conv3x3_weight_grad(*args), 5)
        pms = _cuda_ms(lambda: conv3d._weight_grad_plain(*args), 3)
        lhs, gout = _ncdhw(u, spatial), _ncdhw(g_v, spatial)
        lms = _cuda_ms(lambda: torch.nn.grad.conv3d_weight(lhs, (cout, cin, 3, 3, 3), gout,
                                                           padding=1), 3)
        n = Z * Y * X
        nbytes = 2 * (n * ca + n // 8 * cb + n * cout) + 4 * 27 * cin * cout
        record("conv3x3_weight_grad", err.max().item(), ms, pms, lms,
               _bound(nbytes, 2.0 * 27 * cin * cout * n / PEAK_BF16), what,
               f"tol {WGRAD_TOL} x S = sum |u| |g_v|", ok, flops=2.0 * 27 * cin * cout * n,
               extra={"max_err_over_S": ratio})

    def relu_bf16(n, c):
        return torch.relu(bf16(n[0], c, n[1] * n[2]))

    def gn_two(xa, xb, groups):
        sa, sb = channel_stats(xa), channel_stats(xb)
        c = xa.shape[1] + xb.shape[1]
        gamma = torch.tensor(rng.uniform(0.5, 1.5, c).astype(np.float32), device=dev)
        beta = torch.tensor(rng.normal(size=c).astype(np.float32) * 0.2, device=dev)
        return gn_affine_from_stats((torch.cat([sa[0], sb[0]]), torch.cat([sa[1], sb[1]])),
                                    gamma, beta, groups)

    results = {}
    Z, Y, X = SPATIAL
    h = (Z // 2, Y // 2, X // 2)
    q4 = (Z // 4, Y // 4, X // 4)
    e8 = (Z // 8, Y // 8, X // 8)
    conv_tol = (f"tol 1 bf16 ulp + {CONV_FLOOR}*max, stats rel {STATS_REL}")
    # e0 conv 1: 1 -> 16 at 256^3, GroupNorm affine (1 group) and stats: the
    # FMA kernel (forward, Cin < 8)
    img = torch.tensor(rng.random((Z, 1, Y * X), dtype=np.float32), device=dev).to(torch.bfloat16)
    conv_case("conv e0c1 1->16 @256^3 (+GN affine, stats)", "flat", [img], SPATIAL,
              weights(1, 16), *gn(img, 1))
    del img
    # the two 464-GFLOP single-source convs: e0c2 16 -> 32 at 256^3 and d1c2
    # 64 -> 64 at 128^3; and e3c2 128 -> 256 at 32^3 (X = 32)
    for what, cin, cout, sp, groups in (("e0c2 16->32 @256^3", 16, 32, SPATIAL, 1),
                                        ("d1c2 64->64 @128^3", 64, 64, h, 8),
                                        ("e3c2 128->256 @32^3", 128, 256, e8, 8)):
        x = relu_bf16(sp, cin)
        conv_case(f"conv {what}", "flat", [x], sp, weights(cin, cout), *gn(x, groups))
        del x

    # d1 conv 1 (upconv): [64 skip @128^3 | up2(128 @64^3)] -> 64
    skip, low = relu_bf16(h, 64), relu_bf16(q4, 128)
    sc, sh = gn_two(skip, low, 8)
    w = weights(192, 64)
    _, _, lms = conv_case("conv d1c1 upconv [64@128^3 | up2(128@64^3)]->64", "upconv",
                          [skip, low], h, w, sc, sh)
    # the same conv as parts (the decoder's fallback): upsample materialized
    up = conv3d.upsample_nearest_flat(low, q4, h).contiguous()
    conv_case("conv d1c1 parts [64@128^3 | 128@128^3]->64", "parts", [skip, up], h, w, sc, sh,
              lms=lms)
    del skip, low, up

    # d0 conv 1 (upconv): [128 @64^3 | up2(256 @32^3)] -> 128, K = 27*384: the
    # longest sums. Kernel and plain version each against a float64 conv of
    # the same bf16 operands on the first 16 z slices (what CONV_FLOOR and
    # STATS_REL rest on).
    skip, low = relu_bf16(q4, 128), relu_bf16(e8, 256)
    sc, sh = gn_two(skip, low, 8)
    w = weights(384, 128)
    (ko, ks), (po, ps), _ = conv_case("conv d0c1 upconv [128@64^3 | up2(256@32^3)]->128",
                                      "upconv", [skip, low], q4, w, sc, sh)
    full = torch.cat([skip, conv3d.upsample_nearest_flat(low, e8, q4)], dim=1)[:17].float()
    u = (full * sc[None, :, None] + sh[None, :, None]).to(torch.bfloat16)
    ref = F.conv3d(_ncdhw(u, (17, *q4[1:])).double(),
                   w.to(torch.bfloat16).double().permute(4, 3, 0, 1, 2), padding=1)
    ref = torch.relu(ref)[0, :, :16].permute(1, 0, 2, 3).reshape(16, 128, -1)
    top = ref.abs().max()

    def floor_needed(a, b, rel):
        return (((a - b).abs() - rel * b.abs()) / top).max().item()

    f_kp = floor_needed(ko[:16].double(), po[:16].double(), CONV_REL_ULP)
    f_k = floor_needed(ko[:16].double(), ref, 2.0 ** -8)
    f_p = floor_needed(po[:16].double(), ref, 2.0 ** -8)
    s_kp = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(ks, ps))
    print(f"phase1 d0c1 numerics: floor needed (x max|out|) kernel vs plain beyond 2^-7 rel "
          f"{f_kp!r}; against float64 beyond correct bf16 rounding (2^-8 rel): kernel {f_k!r}, "
          f"plain {f_p!r}; stats kernel vs plain rel {s_kp!r} (CONV_FLOOR {CONV_FLOOR}, "
          f"STATS_REL {STATS_REL})")
    del skip, low, full, u, ref, ko, po

    _phase1_residual_net(torch, rng, dev, bf16, weights, gn, record)
    _phase1_residual_backward(torch, rng, dev, bf16, record)
    _phase1_head(torch, dev, record)
    _phase1_final_conv(torch, dev, record)

    # conv input gradient at the training step's shapes (128^3 input): e0c2,
    # its largest conv (cotangent 32 channels -> gradient 16 channels); the
    # d1c1 upconv at 64^3: cotangent 64 -> [64 | 128] (both halves at 64^3; the
    # 2^3 block sum to 32^3 is the wrapper's plain reduction); d1c2 64 -> 64
    T3 = TRAIN_SPATIAL
    t2 = tuple(d // 2 for d in T3)
    grad_tol = f"tol 1 bf16 ulp + {CONV_FLOOR}*max"
    grad_case("conv input grad e0c2 32->16 @128^3", bf16(T3[0], 32, T3[1] * T3[2]), T3,
              weights(16, 32))
    g_v = bf16(t2[0], 64, t2[1] * t2[2])
    grad_case("conv input grad d1c1 64->[64 | 128] @64^3", g_v, t2, weights(192, 64), 64)
    grad_case("conv input grad d1c2 64->64 @64^3", g_v, t2, weights(64, 64))
    del g_v

    # conv weight gradient at the 12 convs of the 128^3 training net (e0 at
    # 128^3 ... e3 at 16^3; d0c1 [128@32^3 | up2(256@16^3)], d1c1 [64@64^3 |
    # up2(128@32^3)]), inputs from a generator of its own (the phases after
    # this one keep theirs)
    gen = torch.Generator(device=dev).manual_seed(
        int(np.random.default_rng([SEED, 9]).integers(2 ** 62)))
    for what, ca, cb, cout, lvl in (
            ("e0c1 1->16", 1, 0, 16, 0), ("e0c2 16->32", 16, 0, 32, 0),
            ("e1c1 32->32", 32, 0, 32, 1), ("e1c2 32->64", 32, 0, 64, 1),
            ("e2c1 64->64", 64, 0, 64, 2), ("e2c2 64->128", 64, 0, 128, 2),
            ("e3c1 128->128", 128, 0, 128, 3), ("e3c2 128->256", 128, 0, 256, 3),
            ("d0c1 [128 | up2(256)]->128", 128, 256, 128, 2), ("d0c2 128->128", 128, 0, 128, 2),
            ("d1c1 [64 | up2(128)]->64", 64, 128, 64, 1), ("d1c2 64->64", 64, 0, 64, 1)):
        sp = tuple(d >> lvl for d in T3)
        wgrad_case(f"conv weight grad {what} @{sp[0]}^3", ca, cb, cout, sp, gen)

    # TPS flow planes at 256^3, T = 128, from a real fit
    src = rng.uniform(-0.8, 0.8, (1, NUM_KEYPOINTS, 3)).astype(np.float32)
    dst = src + rng.normal(0, 0.03, src.shape).astype(np.float32)
    ctrl = torch.tensor(src, device=dev)
    theta = solvers.fit_tps(ctrl, torch.tensor(dst, device=dev), LMBDA).contiguous()
    planes = tpsflow.tps_planes(theta, ctrl, SPATIAL)
    ref = tpsflow.tps_planes_plain(theta, ctrl, SPATIAL)
    torch.cuda.synchronize()
    err = (planes - ref).abs().max().item()
    ms = _cuda_ms(lambda: tpsflow.tps_planes(theta, ctrl, SPATIAL), 5)
    pms = _cuda_ms(lambda: tpsflow.tps_planes_plain(theta, ctrl, SPATIAL), 2)
    n = Z * Y * X
    record("tps_planes", err, ms, pms, None, _tps_bound(n, NUM_KEYPOINTS, 12 * n, 2, 20),
           "tps_planes 256^3 T=128", f"tol {TPS_ABS}", err <= TPS_ABS)
    del ref

    def fit(T, lm):
        c = torch.tensor(src[:, :T], device=dev).contiguous()
        return solvers.fit_tps(c, torch.tensor(dst[:, :T], device=dev), lm).contiguous(), c

    def planes_run(lm):
        th, c = fit(NUM_KEYPOINTS, lm)
        return ([tpsflow.tps_planes(th, c, SPATIAL)], [tpsflow.tps_planes_plain(th, c, SPATIAL)],
                [tpsflow.tps_planes_plain(th, c, SPATIAL, dtype=torch.float64)])

    against_float64("tps_planes 256^3 T=128", TPS_ABS, False, planes_run)

    # The warp rows: kernel and library each timed call by call on the device
    # (``_call_ms``), with the L2 cleared before every call (``ms``,
    # ``library_ms``: what the bound, which counts device-memory bytes, is
    # held against) and without (``ms_warm``, ``library_ms_warm``). Forward
    # bound: C*V source values and 3N planes read, C*N written; gradient
    # bound: C*V source values, C*N cotangent and 3N planes read, 3N written
    # (4 bytes each).
    flush = torch.ones(64 * 2 ** 20, device=dev)  # 256 MB

    def warp_case(vol, planes, mode, g=None):
        C, n = vol.shape[1], planes[0, 0].numel()
        v = vol[0, 0].numel()
        grid = torch.flip(planes.movedim(1, -1), dims=(-1,)).contiguous()  # xy, for the library
        if g is None:
            name = "warp_planes"
            kern = lambda: resample3d.warp_planes(vol, planes, mode)
            plain = lambda: resample3d.warp_planes_plain(vol, planes, mode)
            lib = lambda: F.grid_sample(vol, grid, mode=mode, padding_mode="border",
                                        align_corners=False)
            nbytes = 4 * (C * v + 3 * n) + 4 * C * n
            what = f"warp_planes {mode} {planes.shape[2]}^3 C={C}"
        else:
            name = "warp_planes_grad"
            kern = lambda: resample3d.warp_planes_grad(vol, planes, g)
            plain = lambda: resample3d.warp_planes_grad_plain(vol, planes, g)
            lib = lambda: torch.ops.aten.grid_sampler_3d_backward(g, vol, grid, 0, 1, False,
                                                                  [False, True])
            nbytes = 4 * (C * v + C * n + 3 * n) + 4 * 3 * n
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if g is None:
            tol, ok = f"tol {WARP_ABS}", err <= WARP_ABS
        else:
            top = ref.abs().max().item()
            tol, ok = f"tol {WARP_GRAD_REL} x max", err <= WARP_GRAD_REL * top
            what = f"warp_planes gradient {planes.shape[2]}^3 C={C} (max |ref| {top:.4g})"
        del out, ref
        ms, lms = _call_ms(kern, 10, flush), _call_ms(lib, 10, flush)
        extra = {"ms_warm": _call_ms(kern, 10), "library_ms_warm": _call_ms(lib, 10)}
        record(name, err, ms, _cuda_ms(plain, 3), lms, _bound(nbytes, 0.0), what, tol, ok,
               extra=extra)

    # the warp at 256^3 on those planes: C = 1, and C = 14 (the register
    # CLI's one-hot segmentation at full width; from a generator of its own)
    vol = torch.tensor(rng.random((1, 1, *SPATIAL), dtype=np.float32), device=dev)
    for mode in ("bilinear", "nearest"):
        warp_case(vol, planes, mode)
    vol = torch.tensor(np.random.default_rng([SEED, 3]).random((1, REG_LABELS, *SPATIAL),
                                                               dtype=np.float32), device=dev)
    for mode in ("bilinear", "nearest"):
        warp_case(vol, planes, mode)
    del vol, planes

    # the training path's TPS and warp kernels at 128^3, T = 64
    T = TRAIN_KEYPOINTS
    n = T3[0] * T3[1] * T3[2]
    ctrl = torch.tensor(src[:, :T], device=dev).contiguous()
    theta = solvers.fit_tps(ctrl, torch.tensor(dst[:, :T], device=dev), LMBDA).contiguous()
    g = torch.tensor(rng.normal(size=(1, 3, *T3)).astype(np.float32), device=dev)
    kt, kc = tpsflow.tps_planes_bwd(theta, ctrl, T3, g)
    pt, pc = tpsflow.tps_planes_bwd_plain(theta, ctrl, T3, g)
    torch.cuda.synchronize()
    err = max((kt - pt).abs().max().item(), (kc - pc).abs().max().item())
    ok = bool((kt - pt).abs().max() <= TPS_BWD_REL * pt.abs().max()
              and (kc - pc).abs().max() <= TPS_BWD_REL * pc.abs().max())
    ms = _cuda_ms(lambda: tpsflow.tps_planes_bwd(theta, ctrl, T3, g), 5)
    pms = _cuda_ms(lambda: tpsflow.tps_planes_bwd_plain(theta, ctrl, T3, g), 2)
    record("tps_planes_bwd", err, ms, pms, None, _tps_bound(n, T, 12 * n, 3, 36),
           f"tps_planes backward 128^3 T={T}, random cotangent (max |g_theta| "
           f"{pt.abs().max().item():.4g}, max |g_ctrl| {pc.abs().max().item():.4g})",
           f"tol {TPS_BWD_REL} x max", ok)

    def bwd_run(lm):
        th, c = fit(T, lm)
        return (tpsflow.tps_planes_bwd(th, c, T3, g), tpsflow.tps_planes_bwd_plain(th, c, T3, g),
                tpsflow.tps_planes_bwd_plain(th, c, T3, g, dtype=torch.float64))

    against_float64(f"tps_planes backward 128^3 T={T}", TPS_BWD_REL, True, bwd_run)

    # the same backward at the 256^3 step's shape, T = 128: 8x the points, and
    # the blocks' rows of partial sums that the second pass adds
    th2, c2 = fit(NUM_KEYPOINTS, LMBDA)
    # (a generator of its own: the phases after this one keep their inputs)
    g2 = torch.tensor(np.random.default_rng([SEED, 1]).normal(size=(1, 3, *SPATIAL))
                      .astype(np.float32), device=dev)
    kt, kc = tpsflow.tps_planes_bwd(th2, c2, SPATIAL, g2)
    pt, pc = tpsflow.tps_planes_bwd_plain(th2, c2, SPATIAL, g2)
    torch.cuda.synchronize()
    err = max((kt - pt).abs().max().item(), (kc - pc).abs().max().item())
    ok = bool((kt - pt).abs().max() <= TPS_BWD_REL * pt.abs().max()
              and (kc - pc).abs().max() <= TPS_BWD_REL * pc.abs().max())
    ms = _cuda_ms(lambda: tpsflow.tps_planes_bwd(th2, c2, SPATIAL, g2), 5)
    pms = _cuda_ms(lambda: tpsflow.tps_planes_bwd_plain(th2, c2, SPATIAL, g2), 1)
    n2 = Z * Y * X
    record("tps_planes_bwd", err, ms, pms, None, _tps_bound(n2, NUM_KEYPOINTS, 12 * n2, 3, 36),
           f"tps_planes backward 256^3 T={NUM_KEYPOINTS}, random cotangent (max |g_theta| "
           f"{pt.abs().max().item():.4g}, max |g_ctrl| {pc.abs().max().item():.4g})",
           f"tol {TPS_BWD_REL} x max", ok)
    del g2, kt, kc, pt, pc

    pts = torch.tensor(rng.uniform(-1, 1, (1, n, 3)).astype(np.float32), device=dev)
    out = tpsflow.tps_flow(theta, ctrl, pts)
    ref = tpsflow.tps_flow_plain(theta, ctrl, pts)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    ms = _cuda_ms(lambda: tpsflow.tps_flow(theta, ctrl, pts), 5)
    pms = _cuda_ms(lambda: tpsflow.tps_flow_plain(theta, ctrl, pts), 2)
    record("tps_flow", err, ms, pms, None, _tps_bound(n, T, 24 * n, 2, 20),
           f"tps_flow N=128^3 points T={T}", f"tol {TPS_ABS}", err <= TPS_ABS)

    def flow_run(lm):
        th, c = fit(T, lm)
        return ([tpsflow.tps_flow(th, c, pts)], [tpsflow.tps_flow_plain(th, c, pts)],
                [tpsflow.tps_flow_plain(th, c, pts, dtype=torch.float64)])

    against_float64(f"tps_flow N=128^3 points T={T}", TPS_ABS, False, flow_run)
    del pts, out, ref

    # the same kernel at the register CLI's shape: the grid form of a tps_*
    # align, the spline at every voxel centre of 256^3, T = 128
    pts = coords.flat_norm_grid(SPATIAL, device=dev).contiguous()
    out = tpsflow.tps_flow(th2, c2, pts)
    ref = tpsflow.tps_flow_plain(th2, c2, pts)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    ms = _cuda_ms(lambda: tpsflow.tps_flow(th2, c2, pts), 5)
    pms = _cuda_ms(lambda: tpsflow.tps_flow_plain(th2, c2, pts), 1)
    record("tps_flow", err, ms, pms, None, _tps_bound(n2, NUM_KEYPOINTS, 24 * n2, 2, 20),
           f"tps_flow N=256^3 grid points T={NUM_KEYPOINTS}", f"tol {TPS_ABS}", err <= TPS_ABS)
    del pts, out, ref, th2, c2

    # the warp and its gradient at 128^3: C = 1 (the MSE step), 4, and 14 (the
    # Dice step's one-hot segmentation, utils.py:one_hot_subsampled_pair)
    # (C = 14 from a generator of its own: the phases after this one keep their
    # inputs)
    planes = tpsflow.tps_planes(theta, ctrl, T3)
    for C in (1, 4, 14):
        r = rng if C < 14 else np.random.default_rng([SEED, 2])
        vol = torch.tensor(r.random((1, C, *T3), dtype=np.float32), device=dev)
        g = torch.tensor(r.normal(size=(1, C, *T3)).astype(np.float32), device=dev)
        warp_case(vol, planes, "bilinear", g)
        if C == 14:
            for mode in ("bilinear", "nearest"):
                warp_case(vol, planes, mode)
    del vol, g, planes
    _phase1_past_the_old_limits(torch, dev, record, flush)
    del flush
    return results


LIMIT_T = 4096     # control points past the 2048 the TPS wrappers once took
LIMIT_B = 70000    # batch items past the grid's 65535 rows


def _phase1_residual_net(torch, rng, dev, bf16, weights, gn, record):
    """The residual U-Nets' kernels at every shape of the 256^3
    ResidualUNetSE3D (f_maps 32, 4 levels: 32@256^3, 64@128^3, 128@64^3,
    256@32^3): a block's last conv with the residual sum and ReLU in its
    epilogue (each level), the 2x max-pool (levels 0-2), the lifts (each
    encoder; fp32 FMA rate), the transposed conv with the skip sum (d0: 256@32^3
    -> 128@64^3; d1: 128@64^3 -> 64@128^3; d2: 64@128^3 -> 32@256^3; library:
    bf16 ``F.conv_transpose3d``), the scSE gate (each level). A rounded conv
    summed with a bf16 tensor and rounded again lies within one bf16 ulp of
    the conv part plus one of the sum of the plain version's; the gate's
    fp32 squeeze and spatial sum in other orders may move a gate by one bf16
    ulp, a gated value by two."""
    import torch.nn.functional as F

    from keymorph_tpu_torch.models.unet import ChannelSpatialSE
    from keymorph_tpu_torch.ops.cuda import conv3d, resblock

    Z, Y, X = SPATIAL
    levels = [(32 << i, (Z >> i, Y >> i, X >> i)) for i in range(4)]  # (C, spatial)

    def sum_ok(k, p, part):
        k, p, part = k.float(), p.float(), part.float()
        err = (k - p).abs()
        tol = CONV_REL_ULP * (part.abs() + p.abs()) + CONV_FLOOR * part.abs().max()
        return err.max().item(), bool((err <= tol).all())

    def side(sp):
        return f"{sp[0]}^3" if sp[0] == sp[1] == sp[2] else "x".join(map(str, sp))

    sum_tol = f"tol 1 bf16 ulp of the conv part + 1 of the sum + {CONV_FLOOR}*max"
    with torch.no_grad():
        # each level's block end: relu(bf16(bf16(conv(GN(y))) + residual)), stats
        for c, sp in levels:
            n = sp[0] * sp[1] * sp[2]
            y, res = torch.relu(bf16(sp[0], c, sp[1] * sp[2])), bf16(sp[0], c, sp[1] * sp[2])
            w = weights(c, c)
            sc, sh = gn(y, 8)
            args = (y, sp, w, sc, sh, None)
            k, _ = conv3d.conv3x3_fused_flat_res(*args, emit_stats=True, residual=res)
            p, _ = conv3d.conv3x3_fused_flat_res_plain(*args, emit_stats=True, residual=res)
            part = conv3d.conv3x3_fused_flat_plain(*args, relu=False)
            err, ok = sum_ok(k, p, part)
            del k, p, part
            ms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat_res(*args, emit_stats=True,
                                                                residual=res), 5)
            pms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat_res_plain(*args, emit_stats=True,
                                                                       residual=res), 3)
            record("conv3x3_fused_flat_res", err, ms, pms, None,
                   _conv_bound(c, c, sp, 2 * c * n * 2),
                   f"conv block end {c}->{c} @{side(sp)} (+GN affine, residual sum, ReLU, "
                   f"stats)", sum_tol, ok, flops=2.0 * 27 * c * c * n)
            del y, res, args

        # the encoders' 2x max-pools: levels 0-2 -> 1-3
        for c, sp in levels[:3]:
            x = bf16(sp[0], c, sp[1] * sp[2])
            k, _ = resblock.maxpool2_flat(x, sp)
            p, _ = resblock.maxpool2_flat_plain(x, sp)
            err = (k.float() - p.float()).abs().max().item()
            del k, p
            ms = _cuda_ms(lambda: resblock.maxpool2_flat(x, sp), 5)
            pms = _cuda_ms(lambda: resblock.maxpool2_flat_plain(x, sp), 3)
            record("maxpool2_flat", err, ms, pms, None,
                   _bound(c * sp[0] * sp[1] * sp[2] * 2 * 9 / 8, 0.0),
                   f"2x max-pool {c}@{side(sp)} -> {side(tuple(s // 2 for s in sp))}", "exact",
                   err == 0.0)
            del x

        # each encoder's lift (1 -> 32 at level 0, C/2 -> C below), with stats
        for cin, (cout, sp) in zip((1, 32, 64, 128), levels):
            x = bf16(sp[0], cin, sp[1] * sp[2])
            wl = torch.tensor(rng.normal(size=(cout, cin)).astype(np.float32) / np.sqrt(cin),
                              device=dev)
            bl = torch.tensor(rng.normal(size=cout).astype(np.float32) * 0.1, device=dev)
            k, ks = resblock.lift1x1_flat(x, wl, bl)
            p, ps = resblock.lift1x1_flat_plain(x, wl, bl)
            err, ok = _conv_check((k, ks), (p, ps))
            del k, p
            ms = _cuda_ms(lambda: resblock.lift1x1_flat(x, wl, bl), 5)
            pms = _cuda_ms(lambda: resblock.lift1x1_flat_plain(x, wl, bl), 3)
            n = sp[0] * sp[1] * sp[2]
            record("lift1x1_flat", err, ms, pms, None,
                   _bound(2 * (cin + cout) * n, 2.0 * cin * cout * n / PEAK_FP32),
                   f"lift {cin}->{cout} @{side(sp)} (+bias, stats)",
                   "tol 1 bf16 ulp + floor, stats rel", ok)
            del x

        # the decoders' transposed convs, skip summed, stats of the sum
        for name, (cin, low), (cout, out) in (("d0", levels[3], levels[2]),
                                              ("d1", levels[2], levels[1]),
                                              ("d2", levels[1], levels[0])):
            x = torch.relu(bf16(low[0], cin, low[1] * low[2]))
            skip = bf16(out[0], cout, out[1] * out[2])
            wt = torch.tensor(rng.normal(size=(cin, cout, 3, 3, 3)).astype(np.float32)
                              / np.sqrt(cin * 27 / 8), device=dev)
            b = torch.tensor(rng.normal(size=cout).astype(np.float32) * 0.1, device=dev)
            k, _ = conv3d.conv_transpose3x3s2_flat(x, out, wt, b, skip=skip, emit_stats=True)
            p, _ = conv3d.conv_transpose3x3s2_flat_plain(x, out, wt, b, skip=skip,
                                                         emit_stats=True)
            part = conv3d.conv_transpose3x3s2_flat_plain(x, out, wt, b)
            err, ok = sum_ok(k, p, part)
            del k, p, part
            ms = _cuda_ms(lambda: conv3d.conv_transpose3x3s2_flat(x, out, wt, b, skip=skip,
                                                                  emit_stats=True), 5)
            pms = _cuda_ms(lambda: conv3d.conv_transpose3x3s2_flat_plain(
                x, out, wt, b, skip=skip, emit_stats=True), 3)
            lhs = _ncdhw(x, low)
            wb, bb = wt.to(torch.bfloat16), b.to(torch.bfloat16)
            lms = _cuda_ms(lambda: F.conv_transpose3d(lhs, wb, bb, stride=2, padding=1,
                                                      output_padding=1), 3)
            n = out[0] * out[1] * out[2]
            flops = 2.0 * 27 * cin * cout * n / 8
            record("conv_transpose3x3s2_flat", err, ms, pms, lms,
                   _bound(2 * (cin * n / 8 + 27 * cin * cout + 2 * cout * n), flops / PEAK_BF16),
                   f"transposed conv {name} {cin}@{side(low)} -> {cout}@{side(out)} (+bias, "
                   f"skip sum, stats)", sum_tol, ok, flops=flops)
            del x, skip, lhs

        # the scSE gate of each level's block output (squeeze from its mean)
        for c, sp in levels:
            se = ChannelSpatialSE(c, 1, torch.bfloat16)
            for prm in se.parameters():
                prm.copy_(torch.tensor(rng.normal(size=prm.shape).astype(np.float32)
                                       / np.sqrt(prm[0].numel() if prm.dim() > 1 else 1)))
            se = se.to(dev)
            x = torch.relu(bf16(sp[0], c, sp[1] * sp[2]))
            n = sp[0] * sp[1] * sp[2]
            mean = torch.sum(x, dim=(0, 2), dtype=torch.float32) / n
            k = resblock.scse_gate_flat(x, se, mean)
            p = resblock.scse_gate_flat_plain(x, se)
            kf, pf = k.float(), p.float()
            err = (kf - pf).abs()
            ok = bool((err <= 2 * CONV_REL_ULP * torch.maximum(kf.abs(), pf.abs())).all())
            differ = float((kf != pf).float().mean())
            del k, p, kf, pf
            ms = _cuda_ms(lambda: resblock.scse_gate_flat(x, se, mean), 5)
            pms = _cuda_ms(lambda: resblock.scse_gate_flat_plain(x, se), 3)
            record("scse_gate_flat", err.max().item(), ms, pms, None, _bound(2 * c * n * 2, 0.0),
                   f"scSE gate {c}@{side(sp)}", "tol 2 bf16 ulps", ok,
                   extra={"share_differing": differ})
            del x, err


def _phase1_residual_backward(torch, rng, dev, bf16, record):
    """The residual U-Nets' backward kernels at every shape of the 128^3
    training net (ResidualUNetSE3D f_maps 32, 4 levels: 32@128^3, 64@64^3,
    128@32^3, 256@16^3): the transposed conv's input gradient (d0: 128@32^3 ->
    256@16^3; d1: 64@64^3 -> 128@32^3; d2: 32@128^3 -> 64@64^3; within one
    bf16 ulp + CONV_FLOOR of its plain version; library: bf16 ``F.conv3d``,
    stride 2) and weight gradient (within WGRAD_TOL of S = the plain weight
    gradient of the magnitudes; library: bf16 ``torch.nn.grad.conv3d_weight``,
    stride 2), and the scSE gate's backward at each level (the input
    gradient within two bf16 ulps but for under 1% of its values, whose
    spatial gate rounds to the neighbouring value in another summation order;
    each per-channel sum, the channel gate's and the spatial gate's weights'
    and bias's, within 1e-3 of its own terms' magnitudes, and each set of
    sums within 1e-2 of its norm in relative L2). Bounds:
    each gradient's useful operations (2 x 27 x Cin x Cout x V/8) or its
    bytes, whichever is larger; the gate's bytes (x and the cotangent read,
    the input gradient written once)."""
    import torch.nn.functional as F

    from keymorph_tpu_torch.ops.cuda import conv3d, resblock

    T3 = TRAIN_SPATIAL
    levels = [(32 << i, tuple(d >> i for d in T3)) for i in range(4)]

    def side(sp):
        return f"{sp[0]}^3" if sp[0] == sp[1] == sp[2] else "x".join(map(str, sp))

    with torch.no_grad():
        for name, (cin, low), (cout, out) in (("d0", levels[3], levels[2]),
                                              ("d1", levels[2], levels[1]),
                                              ("d2", levels[1], levels[0])):
            x = torch.relu(bf16(low[0], cin, low[1] * low[2]))
            g = bf16(out[0], cout, out[1] * out[2])
            wt = torch.tensor(rng.normal(size=(cin, cout, 3, 3, 3)).astype(np.float32)
                              / np.sqrt(cout * 27), device=dev)
            n = out[0] * out[1] * out[2]
            flops = 2.0 * 27 * cin * cout * n / 8
            k = conv3d.conv_transpose3x3s2_input_grad(g, out, wt)
            p = conv3d.conv_transpose3x3s2_input_grad_plain(g, out, wt)
            err, ok = _ulp_ok(k, p)
            del k, p
            ms = _cuda_ms(lambda: conv3d.conv_transpose3x3s2_input_grad(g, out, wt), 5)
            pms = _cuda_ms(lambda: conv3d.conv_transpose3x3s2_input_grad_plain(g, out, wt), 3)
            gl, wb = _ncdhw(g, out), wt.to(torch.bfloat16)
            lms = _cuda_ms(lambda: F.conv3d(gl, wb, stride=2, padding=1), 3)
            record("conv_transpose3x3s2_input_grad", err, ms, pms, lms,
                   _bound(2 * (cout * n + 27 * cin * cout + cin * n / 8), flops / PEAK_BF16),
                   f"transposed conv input gradient {name} {cout}@{side(out)} -> "
                   f"{cin}@{side(low)}", "tol 1 bf16 ulp + floor", ok, flops=flops)

            k = conv3d.conv_transpose3x3s2_weight_grad(x, out, g)
            p = conv3d._tconv_weight_grad_plain(x, out, g)
            mag = conv3d._tconv_weight_grad_plain(x.abs(), out, g.abs())
            ratio = ((k - p).abs() / mag.clamp_min(1e-30)).max().item()
            ok = bool(((k - p).abs() <= WGRAD_TOL * mag).all())
            err = (k - p).abs().max().item()
            del k, p, mag
            ms = _cuda_ms(lambda: conv3d.conv_transpose3x3s2_weight_grad(x, out, g), 5)
            pms = _cuda_ms(lambda: conv3d._tconv_weight_grad_plain(x, out, g), 1)
            xl = _ncdhw(x, low)
            lms = _cuda_ms(lambda: torch.nn.grad.conv3d_weight(gl, (cin, cout, 3, 3, 3), xl,
                                                               stride=2, padding=1), 3)
            record("conv_transpose3x3s2_weight_grad", err, ms, pms, lms,
                   _bound(2 * (cin * n / 8 + cout * n) + 4 * 27 * cin * cout,
                          flops / PEAK_BF16),
                   f"transposed conv weight gradient {name} {cin}@{side(low)} x "
                   f"{cout}@{side(out)}", f"tol {WGRAD_TOL} x S", ok, flops=flops,
                   extra={"err_over_S": ratio})
            del x, g, gl, xl

        for c, sp in levels:
            n = sp[0] * sp[1] * sp[2]
            x = torch.relu(bf16(sp[0], c, sp[1] * sp[2]))
            g = bf16(sp[0], c, sp[1] * sp[2])
            gc = torch.sigmoid(torch.tensor(rng.normal(size=c).astype(np.float32))).to(
                torch.bfloat16).float().to(dev)
            ws = (torch.tensor(rng.normal(size=c + 1).astype(np.float32)) / np.sqrt(c)).to(
                torch.bfloat16).float().to(dev)
            k = resblock.scse_gate_bwd(x, gc, ws, g)
            p = resblock.scse_gate_bwd_plain(x, gc, ws, g)
            kx, px = k[0].float(), p[0].float()
            err = (kx - px).abs()
            off = float((err > 2 * CONV_REL_ULP * torch.maximum(kx.abs(), px.abs())
                         + 1e-6 * px.abs().max()).float().mean())
            xf, ga = x.float(), g.float().abs()
            mag_c = (ga * xf).sum(dim=(0, 2))
            mag_w = torch.cat([((ga * xf).sum(dim=1, keepdim=True) * xf).sum(dim=(0, 2)),
                               ga.sum(dim=1).sum().reshape(1)]) * float(ws.abs().max() + 1)
            # each channel's sum (the channel gate's, then the spatial gate's
            # weights and bias) against the magnitude of its own terms, and
            # the C (C + 1) sums together against their own norm: a signed sum
            # over 10^4-10^6 voxels is ~1/sqrt(V) of its terms' magnitude, so
            # the first alone would pass a sum that is zeroed or doubled
            sums, rel, ok = 0.0, 0.0, off < 0.01
            for got, want, mag in ((k[1], p[1], mag_c), (k[2], p[2], mag_w)):
                e = (got - want).abs()
                sums = max(sums, (e / mag.clamp_min(1e-30)).max().item())
                rel = max(rel, (e.norm() / want.norm().clamp_min(1e-30)).item())
                ok = ok and bool((e <= 1e-3 * mag + 1e-6).all())
            ok = ok and rel <= 1e-2
            del k, p, kx, px, xf, ga, mag_c, mag_w
            ms = _cuda_ms(lambda: resblock.scse_gate_bwd(x, gc, ws, g), 5)
            pms = _cuda_ms(lambda: resblock.scse_gate_bwd_plain(x, gc, ws, g), 3)
            record("scse_gate_bwd", err.max().item(), ms, pms, None, _bound(3 * c * n * 2, 0.0),
                   f"scSE gate backward {c}@{side(sp)}",
                   "tol 2 bf16 ulps (99%), sums 1e-3 S each and 1e-2 of their norm", ok,
                   extra={"share_off": off, "sums_over_S": sums, "sums_rel_l2": rel})
            del x, g, err


def _head64(torch, vol, slab=16):
    """The centre of mass of channel-last ``vol`` (1, Z, Y, X, C) in float64
    against the fp32 ``linspace`` weights both versions take, its marginal
    masses taken over z-slabs of ``slab`` planes (a float64 copy of 256
    channels at 256^3 would take 34 GB)."""
    _, Z, Y, X, C = vol.shape
    m = [torch.zeros((n, C), dtype=torch.float64, device=vol.device) for n in (Z, Y, X)]
    for z0 in range(0, Z, slab):
        v = torch.relu(vol[0, z0:z0 + slab].double())
        m[0][z0:z0 + slab] = v.sum(dim=(1, 2))
        m[1] += v.sum(dim=(0, 2))
        m[2] += v.sum(dim=(0, 1))
        del v
    out = []
    for mk, n in zip(m, (Z, Y, X)):
        line = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=vol.device).double()
        out.append((mk * line[:, None]).sum(dim=0) / (mk.sum(dim=0) + 1e-8))
    return torch.stack(out, dim=-1)[None] * 2.0 - 1.0


def _phase1_head(torch, dev, record):
    """The keypoint head on 256 bf16 heatmaps at the DoubleConv net's 128^3
    and the residual net's 256^3 (channel-last, as both executors write
    them): ``heatmap_com`` (one read) against ``center_of_mass_plain`` (the
    ReLU copy and three marginal sums), each held against float64; the
    library time is ``torch.relu`` and the three ``torch.sum``s alone; the
    bound, the heatmaps read once."""
    from keymorph_tpu_torch.models.layers import center_of_mass_plain
    from keymorph_tpu_torch.ops.cuda import heatmap

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for side in (128, 256):
        vol = torch.randn((1, side, side, side, 256), generator=gen, device=dev).to(torch.bfloat16)

        def relu_sums():
            v = torch.relu(vol)
            return [torch.sum(v, dim=tuple(i + 1 for i in range(3) if i != k),
                              dtype=torch.float32) for k in range(3)]

        k, p = heatmap.heatmap_com(vol), center_of_mass_plain(vol)
        ref = _head64(torch, vol)
        dk, dp = ((a.double() - ref).abs().max().item() for a in (k, p))
        err = (k - p).abs().max().item()
        del k, p, ref
        ms = _cuda_ms(lambda: heatmap.heatmap_com(vol), 10)
        pms = _cuda_ms(lambda: center_of_mass_plain(vol), 3)
        lms = _cuda_ms(relu_sums, 3)
        rows, blocks = heatmap.plan((side,) * 3, 256, 2)
        record("heatmap_com", err, ms, pms, lms, _bound(vol.numel() * 2, 0.0),
               f"keypoint head 256@{side}^3 bf16 (ReLU, 4 moments; {blocks} blocks of "
               f"{rows} rows)", f"each within HEAT_F64 {HEAT_F64} of float64",
               dk <= HEAT_F64 and dp <= HEAT_F64,
               extra={"kernel_vs_float64": dk, "plain_vs_float64": dp,
                      "read_TB_per_s": vol.numel() * 2 / ms / 1e9})
        del vol
        torch.cuda.empty_cache()


def _phase1_final_conv(torch, dev, record):
    """The U-Nets' final 1x1 conv, 32 -> 256 channels at the DoubleConv
    net's 128^3 heatmaps and the residual net's 256^3, and the 128^3
    training net's 32 -> 128: ``final_conv1x1`` against
    ``final_conv1x1_plain``, one bf16 ulp of each output plus CONV_FLOOR of
    the range (the fp32 sum in another order), held 16 planes at a time (an
    fp32 copy of 256 channels at 256^3 would take 17 GB); the library
    yardstick a bf16 ``torch.matmul`` plus the bias in bf16 (two writes of
    the heatmaps); the bound, the features read and the heatmaps written
    once (or the products at the bf16 peak)."""
    from keymorph_tpu_torch.ops.cuda import heatmap

    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    for side, cin, k in ((128, 32, 256), (256, 32, 256), (128, 32, 128)):
        spatial = (side,) * 3
        xf = torch.randn((side, cin, side * side), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, cin), generator=gen, device=dev) / cin ** 0.5
        b = torch.randn(k, generator=gen, device=dev) * 0.1
        out = torch.empty((*spatial, k), dtype=torch.bfloat16, device=dev)
        ref = torch.empty_like(out)
        heatmap.final_conv1x1(xf, spatial, w, b, out)
        heatmap.final_conv1x1_plain(xf, spatial, w, b, ref)
        top = max(ref[z:z + 16].float().abs().max().item() for z in range(0, side, 16))
        err, ok = 0.0, bool(out.isfinite().all())
        for z in range(0, side, 16):
            kz, pz = out[z:z + 16].float(), ref[z:z + 16].float()
            d = (kz - pz).abs()
            err = max(err, d.max().item())
            ok &= bool((d <= CONV_REL_ULP * pz.abs() + CONV_FLOOR * top).all())
            del kz, pz, d
        del ref
        wb, bb = w.t().to(torch.bfloat16), b.to(torch.bfloat16)
        ms = _cuda_ms(lambda: heatmap.final_conv1x1(xf, spatial, w, b, out), 20)
        pms = _cuda_ms(lambda: heatmap.final_conv1x1_plain(xf, spatial, w, b, out), 3)
        lms = _cuda_ms(lambda: torch.matmul(xf.transpose(1, 2), wb) + bb, 3)
        nbytes = xf.numel() * 2 + out.numel() * 2
        bound = _bound(nbytes, 2.0 * cin * out.numel() / PEAK_BF16)
        warps, tpw, group = heatmap.final_conv_plan(cin, k)
        record("final_conv1x1", err, ms, pms, lms, bound,
               f"final 1x1 conv {cin}->{k} @{side}^3 ({warps} warps of {tpw} tiles a block, "
               f"{-(-k // group)} launch)", f"tol 1 bf16 ulp + {CONV_FLOOR}*max", ok,
               extra={"TB_per_s": nbytes / ms / 1e9, "bound_share": bound[0] / ms})
        del xf, out
        torch.cuda.empty_cache()


def _phase1_past_the_old_limits(torch, dev, record, flush):
    """Phase 1's TPS kernels at T = LIMIT_T (B4 on a 64^3 grid, B4p and B7
    on 32^3 points, from a real fit) and ``tps_flow`` and ``warp_planes`` at
    B = LIMIT_B on 4^3 volumes, each against its plain version (from a
    generator of its own: the phases after this one keep their inputs).
    Over 4096 control points the kernels' and the plain versions' fp32 sums
    of the spline each lie about TPS_ABS from float64 or more, in other
    orders, so B4 and B4p are held as phase 1 holds every TPS kernel against
    float64: no farther from it than FLOAT64_FACTOR x their plain version,
    or TPS_ABS; the three distances are printed.
    B7 sums over grid points, not control points: TPS_BWD_REL x max. The
    warp: WARP_ABS."""
    import torch.nn.functional as F

    from keymorph_tpu_torch.ops.cuda import resample3d, tpsflow
    from keymorph_tpu_torch.transforms import solvers

    rng = np.random.default_rng([SEED, 5])
    T = LIMIT_T
    src = torch.tensor(rng.uniform(-0.8, 0.8, (1, T, 3)).astype(np.float32), device=dev)
    dst = src + torch.tensor(rng.normal(0, 0.03, (1, T, 3)).astype(np.float32), device=dev)
    theta = solvers.fit_tps(src, dst, LMBDA).contiguous()

    def dist(a, b):
        return (a.double() - b.double()).abs().max().item()

    def held64(name, k, p, r, ms, pms, bound, what):
        dk, dp = dist(k, r), dist(p, r)
        tol = max(TPS_ABS, FLOAT64_FACTOR * dp)
        record(name, dist(k, p), ms, pms, None, bound, what,
               f"from float64 <= max({TPS_ABS}, {FLOAT64_FACTOR} x the plain version's)",
               dk <= tol, extra={"kernel_vs_float64": dk, "plain_vs_float64": dp})

    # B4 on a 64^3 grid; float64 on 4 of its 64 planes (the whole grid in
    # float64 would take 48 GB)
    sp = (64, 64, 64)
    k = tpsflow.tps_planes(theta, src, sp)
    p = tpsflow.tps_planes_plain(theta, src, sp)
    zs = torch.tensor([0, 21, 42, 63], device=dev)
    pts = tpsflow._grid_points(sp, dev).reshape(64, -1, 3)[zs].reshape(1, -1, 3)
    r = tpsflow.tps_flow_plain(theta, src, pts, dtype=torch.float64)
    r = r.transpose(1, 2).reshape(1, 3, 4, 64, 64)
    n = 64 ** 3
    held64("tps_planes", k[:, :, zs], p[:, :, zs], r,
           _cuda_ms(lambda: tpsflow.tps_planes(theta, src, sp), 3),
           _cuda_ms(lambda: tpsflow.tps_planes_plain(theta, src, sp), 1),
           _tps_bound(n, T, 12 * n, 2, 20), f"tps_planes 64^3 T={T}")
    del k, p, r, pts

    # B4p and B7 on 32^3 points
    n = 32 ** 3
    pts = torch.tensor(rng.uniform(-1, 1, (1, n, 3)).astype(np.float32), device=dev)
    held64("tps_flow", tpsflow.tps_flow(theta, src, pts), tpsflow.tps_flow_plain(theta, src, pts),
           tpsflow.tps_flow_plain(theta, src, pts, dtype=torch.float64),
           _cuda_ms(lambda: tpsflow.tps_flow(theta, src, pts), 3),
           _cuda_ms(lambda: tpsflow.tps_flow_plain(theta, src, pts), 1),
           _tps_bound(n, T, 24 * n, 2, 20), f"tps_flow N=32^3 points T={T}")
    sp = (32, 32, 32)
    g = torch.tensor(rng.normal(size=(1, 3, *sp)).astype(np.float32), device=dev)
    kt, kc = tpsflow.tps_planes_bwd(theta, src, sp, g)
    pt, pc = tpsflow.tps_planes_bwd_plain(theta, src, sp, g)
    torch.cuda.synchronize()
    ok = bool((kt - pt).abs().max() <= TPS_BWD_REL * pt.abs().max()
              and (kc - pc).abs().max() <= TPS_BWD_REL * pc.abs().max())
    record("tps_planes_bwd", max(dist(kt, pt), dist(kc, pc)),
           _cuda_ms(lambda: tpsflow.tps_planes_bwd(theta, src, sp, g), 3),
           _cuda_ms(lambda: tpsflow.tps_planes_bwd_plain(theta, src, sp, g), 1), None,
           _tps_bound(n, T, 12 * n, 3, 36),
           f"tps_planes backward 32^3 T={T}, random cotangent (max |g_theta| "
           f"{pt.abs().max().item():.4g}, max |g_ctrl| {pc.abs().max().item():.4g})",
           f"tol {TPS_BWD_REL} x max", ok)
    del theta, src, dst, pts, g, kt, kc, pt, pc

    # B = LIMIT_B: tps_flow (T = 8, each item its own fit) and warp_planes
    B, sp, T = LIMIT_B, (4, 4, 4), 8
    n = 64
    src = torch.tensor(rng.uniform(-0.8, 0.8, (B, T, 3)).astype(np.float32), device=dev)
    dst = src + torch.tensor(rng.normal(0, 0.05, (B, T, 3)).astype(np.float32), device=dev)
    theta = solvers.fit_tps(src, dst, LMBDA).contiguous()
    pts = torch.tensor(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32), device=dev)
    err = dist(tpsflow.tps_flow(theta, src, pts), tpsflow.tps_flow_plain(theta, src, pts))
    record("tps_flow", err, _cuda_ms(lambda: tpsflow.tps_flow(theta, src, pts), 3),
           _cuda_ms(lambda: tpsflow.tps_flow_plain(theta, src, pts), 1), None,
           _tps_bound(B * n, T, B * (24 * n + 12 * (2 * T + 4)), 2, 20),
           f"tps_flow B={B} x {n} points T={T}", f"tol {TPS_ABS}", err <= TPS_ABS)
    vol = torch.tensor(rng.random((B, 1, *sp), dtype=np.float32), device=dev)
    planes = torch.tensor(rng.uniform(-1.2, 1.2, (B, 3, *sp)).astype(np.float32), device=dev)
    grid = torch.flip(planes.movedim(1, -1), dims=(-1,)).contiguous()
    for mode in ("bilinear", "nearest"):
        err = dist(resample3d.warp_planes(vol, planes, mode),
                   resample3d.warp_planes_plain(vol, planes, mode))
        lib = lambda: F.grid_sample(vol, grid, mode=mode, padding_mode="border",
                                    align_corners=False)
        record("warp_planes", err, _call_ms(lambda: resample3d.warp_planes(vol, planes, mode), 5,
                                            flush),
               _cuda_ms(lambda: resample3d.warp_planes_plain(vol, planes, mode), 1),
               _call_ms(lib, 5, flush), _bound(4 * B * (n + 3 * n) + 4 * B * n, 0.0),
               f"warp_planes {mode} B={B} x 4^3 C=1", f"tol {WARP_ABS}", err <= WARP_ABS)


def _make_pairs(torch, rng, dev, spatial=SPATIAL, n_pairs=N_PAIRS, noise_amp=0.2):
    """``n_pairs`` (fixed, moving) volumes (1, 1, *spatial) in [0, ~1.2]:
    Gaussian blobs plus ``noise_amp`` x white noise; the moving blobs are
    displaced by a few voxels each. Parameters and noise come from the numpy
    generator."""
    axes = [torch.linspace(-1, 1, s, device=dev) for s in spatial]
    pairs = []
    for _ in range(n_pairs):
        c = rng.uniform(-0.6, 0.6, (8, 3))
        width = rng.uniform(0.05, 0.2, 8)
        amp = rng.uniform(0.3, 1.0, 8)
        shift = rng.normal(0, 0.03, (8, 3))
        vols = []
        for cs in (c, c + shift):
            v = torch.zeros(spatial, device=dev)
            for (cz, cy, cx), wd, a in zip(cs, width, amp):
                v += a * (torch.exp(-(axes[0] - cz) ** 2 / wd)[:, None, None]
                          * torch.exp(-(axes[1] - cy) ** 2 / wd)[None, :, None]
                          * torch.exp(-(axes[2] - cx) ** 2 / wd)[None, None, :])
            noise = torch.tensor(rng.random(spatial, dtype=np.float32), device=dev)
            vols.append((v.clamp(max=1.0) + noise_amp * noise)[None, None].contiguous())
        pairs.append(tuple(vols))
    return pairs


def phase2(torch, net, pairs):
    """Serve the pairs through the kernels; return per-pair outputs."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.resample import align_img, align_planes

    outs, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    for img_f, img_m in pairs:
        t0 = time.perf_counter()
        pf, pm, _ = net(img_f, img_m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        planes = align_pair(pf, pm, "tps", SPATIAL, lmbda=LMBDA, compute_grid="planes")["planes"]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        warped = align_planes(planes, img_m)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        outs.append((pf, pm, planes, warped))
        times.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))
    # pair 0 once more through the grid form: the TPS kernel in points mode
    pf, pm, planes, warped = outs[0]
    t0 = time.perf_counter()
    grid = align_pair(pf, pm, "tps", SPATIAL, lmbda=LMBDA, compute_grid=True)["grid"]
    warped_g = align_img(grid, pairs[0][1])
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d_grid = (torch.flip(grid.movedim(-1, 1), dims=(1,)) - planes).abs().max().item()
    d_warp = (warped_g - warped).abs().max().item()
    del grid, warped_g
    for i, (e, s, w, t) in enumerate(times):
        print(f"phase2 pair {i}: extract {e * 1e3:.3f} ms, solve+flow {s * 1e3:.3f} ms, "
              f"warp {w * 1e3:.3f} ms, total {t * 1e3:.3f} ms")
    print(f"phase2 pair 0 grid form (solve + tps_flow at 256^3 points + warp): {grid_ms:.3f} ms; "
          f"grid vs planes {d_grid!r} (tol {TPS_ABS}: linspace grid vs idx*step-1), warped "
          f"{d_warp!r} (not checked: it carries that difference)")
    print(f"phase2 peak device memory {peak:.3f} GiB; counters {json.dumps(counts)}")
    if not d_grid <= TPS_ABS:
        raise AssertionError("phase 2 grid form disagrees with the planes form")
    for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "maxpool2_flat",
                 "tps_planes", "tps_flow", "warp_planes"):
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"phase 2 never launched the {name} kernel")
    if counts["heatmap_com"]["launches"] != 2 * len(pairs):
        raise AssertionError(f"phase 2: the head kernel launched "
                             f"{counts['heatmap_com']['launches']} times, not 2 a pair")
    if counts["final_conv1x1"]["launches"] != 2 * len(pairs):
        raise AssertionError(f"phase 2: the final conv kernel launched "
                             f"{counts['final_conv1x1']['launches']} times, not 2 a pair")
    if any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"phase 2 ran a plain version: {counts}")
    for pf, pm, planes, warped in outs:
        for t, shape in ((pf, (1, NUM_KEYPOINTS, 3)), (planes, (1, 3, *SPATIAL)),
                         (warped, (1, 1, *SPATIAL))):
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"phase 2 output {tuple(t.shape)} not finite {shape}")
        if not bool((pf.abs() <= 1).all() and (pm.abs() <= 1).all()):
            raise AssertionError("phase 2 keypoints leave [-1, 1]")
    return outs, counts, times


def phase3(torch, net, pairs, kernel_outs):
    """The same pairs through the plain versions on the card; compare.

    Each stage of the kernel path is held tightly on its own inputs: the
    planes against the plain spline on the kernel path's own keypoints
    (TPS_ABS), the warped image against the plain warp on the kernel path's
    own planes (WARP_ABS). The end-to-end distances (keypoints and planes,
    kernel path vs plain path) carry the random-weight net's sensitivity to
    one-ulp differences of its bf16 convs, so each pair's are held against a
    yardstick: the plain path against itself on that pair's volumes moved by
    half a bf16 ulp."""
    from keymorph_tpu_torch.models.fast_unet import fast_unet_forward
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.models.layers import center_of_mass_plain
    from keymorph_tpu_torch.ops.cuda import resample3d

    def keypoints(img):
        return center_of_mass_plain(fast_unet_forward(net.backbone, img, plain=True))

    def plain_planes(pf, pm):
        return align_pair(pf, pm, "tps", SPATIAL, lmbda=LMBDA, compute_grid="planes",
                          plain=True)["planes"]

    def dist(a, b):
        return (a - b).abs().max().item()

    ok = True
    for i, ((img_f, img_m), (kpf, kpm, kplanes, kwarped)) in enumerate(zip(pairs, kernel_outs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf, pm = keypoints(img_f), keypoints(img_m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        planes = plain_planes(pf, pm)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        warped = resample3d.warp_planes_plain(img_m, planes)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"phase3 pair {i} plain path: extract {(t1 - t0) * 1e3:.3f} ms, "
              f"solve+flow {(t2 - t1) * 1e3:.3f} ms, warp {(t3 - t2) * 1e3:.3f} ms, "
              f"total {(t3 - t0) * 1e3:.3f} ms")
        # each kernel stage on the kernel path's own inputs
        d_flow = dist(plain_planes(kpf, kpm), kplanes)
        d_warp = dist(resample3d.warp_planes_plain(img_m, kplanes), kwarped)
        print(f"phase3 pair {i} kernel stages on their own inputs: planes vs the plain spline on "
              f"the kernel path's keypoints {d_flow!r} (tol {TPS_ABS}), warped vs the plain warp "
              f"on the kernel path's planes {d_warp!r} (tol {WARP_ABS}); warped on each path's "
              f"own planes {dist(warped, kwarped)!r} (not checked: it carries the planes' "
              f"difference)")
        # end to end against this pair's yardstick
        d_kp = max(dist(pf, kpf), dist(pm, kpm))
        d_planes = dist(planes, kplanes)
        del warped
        pf1, pm1 = keypoints(img_f * (1 + PERTURB)), keypoints(img_m * (1 + PERTURB))
        y_kp = max(dist(pf1, pf), dist(pm1, pm))
        y_planes = dist(plain_planes(pf1, pm1), planes)
        tol_kp = max(KEYPOINT_ABS, NOISE_FACTOR * y_kp)
        tol_planes = max(PLANES_ABS, NOISE_FACTOR * y_planes)
        print(f"phase3 pair {i} kernel path vs plain path: keypoints {d_kp!r} (yardstick "
              f"{y_kp!r}, tol {tol_kp!r}), planes {d_planes!r} (yardstick {y_planes!r}, tol "
              f"{tol_planes!r}); yardstick: the plain path vs itself on this pair's volumes "
              f"moved by {PERTURB} relative, tol = max({KEYPOINT_ABS}, {NOISE_FACTOR} x yardstick)")
        ok &= (d_flow <= TPS_ABS and d_warp <= WARP_ABS and d_kp <= tol_kp
               and d_planes <= tol_planes)
    if not ok:
        raise AssertionError("kernel path and plain path disagree")


# the port's __global__ functions (csrc/*.cu), as the profiler names them
PORT_KERNELS = ("conv3x3_mma_kernel", "conv3x3_fma_kernel", "tps_planes_kernel",
                "tps_flow_kernel", "tps_planes_bwd_kernel", "warp_planes_kernel",
                "warp_planes_grad_kernel", "heatmap_moments_kernel", "heatmap_finish_kernel")


def _profile(torch, label, fn):
    """Run ``fn`` under torch.profiler (``tools/trace_summary.py:profile_fn``:
    device busy is the union of the device's kernel and copy intervals) and
    print the host wall time, the device busy time, the device's idle share,
    and device time by kernel name."""
    from keymorph_tpu_torch.tools.trace_summary import profile_fn

    _, prof = profile_fn(fn)
    busy = prof["busy_ms"]
    if busy is None:
        print(f"{label}: host wall {prof['wall_ms']:.3f} ms; torch.profiler recorded "
              f"no device activity, device idle share not measured")
        return
    print(f"{label}: host wall {prof['wall_ms']:.3f} ms, device busy {busy:.3f} ms, "
          f"device idle share {prof['idle_share']:.4f}")
    tag = label.split()[0]
    # the 18 largest entries, and the port's own kernels wherever they rank
    for rank, (name, ms, n) in enumerate(prof["ops"]):
        if rank < 18 or any(k in name for k in PORT_KERNELS):
            print(f"{tag} {ms:.3f} ms {n}x share_of_busy {ms / busy:.4f} {name[:110]}")


def phase4(torch, net, pairs):
    """One steady pair on the kernel path under torch.profiler."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops.resample import align_planes

    img_f, img_m = pairs[1]  # served in phases 2 and 3 already: steady state

    def pair():
        pf, pm, _ = net(img_f, img_m)
        planes = align_pair(pf, pm, "tps", SPATIAL, lmbda=LMBDA, compute_grid="planes")["planes"]
        align_planes(planes, img_m)

    _profile(torch, "phase4 pair", pair)


TRAIN_PATH_KERNELS = ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
                      "conv3x3_weight_grad", "tps_planes", "tps_planes_bwd", "warp_planes",
                      "warp_planes_grad")


def _train_config(spatial):
    from keymorph_tpu_torch.training.config import Config

    return Config(num_keypoints=NUM_KEYPOINTS, transform_type="tps_loguniform",
                  loss_fn="mse", max_train_keypoints=TRAIN_KEYPOINTS, lr=TRAIN_LR,
                  batch_size=1, img_size=tuple(spatial), backbone="truncatedunet",
                  use_amp=True, debug_mode=True)


def _grads(net):
    return {k: p.grad.detach().clone() for k, p in net.named_parameters() if p.grad is not None}


def _align_grads(torch, first, points, affines, plain, grid=False):
    """The step's alignment alone, in fp32: the MSE of the moving volume
    warped by ``align_pair``'s flow from ``points`` (the keypoints phase 5's
    initial weights give, the step's subset for TPS), and its gradient to
    the fixed and moving keypoints, through the kernels or (``plain``) their
    plain versions. ``grid``: the TPS flow on the grid path (``tps_flow``,
    then the warp of the grid's planes), as the same-resolution step takes
    it."""
    from keymorph_tpu_torch.losses import mse_loss
    from keymorph_tpu_torch.models.keymorph import align_pair, parse_transform_type
    from keymorph_tpu_torch.ops.cuda import resample3d
    from keymorph_tpu_torch.ops.resample import grid_to_planes

    img_f, img_m = first["pair"]
    align_type, spec = parse_transform_type(first["config"].transform_type)
    lmbda = None
    if align_type == "tps":
        lmbda = first["lmbda"] if first["lmbda"] is not None else torch.full(
            (1,), spec, device=img_f.device)
    use_planes = align_type == "tps" and not affines and not grid
    pf, pm = (p.detach().clone().requires_grad_(True) for p in points)
    aff_f, aff_m = affines if affines else (None, None)
    flow = align_pair(pf, pm, align_type, img_f.shape[2:], lmbda=lmbda,
                      compute_grid="planes" if use_planes else True, aff_f=aff_f, aff_m=aff_m,
                      moving_shape=img_m.shape[2:], plain=plain)
    planes = flow["planes"] if use_planes else grid_to_planes(flow["grid"])
    warp = resample3d.warp_planes_plain if plain else resample3d.warp_planes
    mse_loss(img_f, warp(img_m, planes)).backward()
    return pf.grad, pm.grad


def phase5(torch, rng, dev):
    """The canonical training step at 128^3 through the kernels: a first
    step with injected lambda and keypoint subset (kept for phase 6), then
    run_train's 3 debug-mode steps. Returns what phases 6 and 8 need and the
    launch counts of the 3 steps."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.training.config import build_backbone
    from keymorph_tpu_torch.training.train import (
        TrainState, make_optimizer, make_train_step, run_train)
    from keymorph_tpu_torch.models.unet import init_weights

    config = _train_config(TRAIN_SPATIAL)
    gen = torch.Generator().manual_seed(SEED + 1)
    net = KeyMorphNet(init_weights(build_backbone(config), gen), NUM_KEYPOINTS).to(dev)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    state = TrainState.create(net, make_optimizer(config, net))
    step = make_train_step(net, config)
    # smooth volumes: with white noise the warp's gradient to the planes is
    # discontinuous at every voxel boundary, and phase 6 would compare chaos
    pairs = _make_pairs(torch, rng, dev, TRAIN_SPATIAL, 3, noise_amp=0.0)
    lmbda = torch.tensor([0.5], device=dev)
    idx = torch.tensor(rng.permutation(NUM_KEYPOINTS)[:TRAIN_KEYPOINTS].copy(), device=dev)

    log = []

    def timed_step(st, g, img_f, img_m, seg_f, seg_m, aug_scale, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, g, img_f, img_m, seg_f, seg_m, aug_scale, **kw)
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - t0) * 1e3, float(m["loss"]), float(m["grad_norm"])))
        return st, m

    # the first step (also the warm-up): fixed lambda and keypoint subset
    torch.cuda.reset_peak_memory_stats()
    state, _ = timed_step(state, gen, *pairs[0], None, None, 1.0, lmbda=lmbda, keypoint_idx=idx)
    first = {"ms": log[0][0], "loss": log[0][1], "grad_norm": log[0][2], "grads": _grads(net),
             "init": init, "pair": pairs[0], "lmbda": lmbda, "idx": idx, "config": config}
    print(f"phase5 first step (lambda 0.5, fixed subset): {log[0][0]:.3f} ms, "
          f"loss {log[0][1]!r}, grad_norm {log[0][2]!r}")

    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    loader = [({"img": f}, {"img": m}) for f, m in pairs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    state, stats, gen = run_train(loader, state, timed_step, config, 1, gen)
    counts = kernels.counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (ms, loss, gn) in enumerate(log[1:]):
        print(f"phase5 step {i}: {ms:.3f} ms, loss {loss!r}, grad_norm {gn!r}")
    print(f"phase5 run_train stats {json.dumps(stats)}; peak device memory {peak:.3f} GiB; "
          f"counters {json.dumps(counts)}")
    if len(log) != 4 or state.step != 4:
        raise AssertionError(f"phase 5 took {len(log)} steps, state.step {state.step}")
    if not all(np.isfinite(v) for _, loss, gn in log for v in (loss, gn)):
        raise AssertionError("phase 5: a loss or gradient norm is not finite")
    stuck, n_grad = [], 0
    for k, p in net.named_parameters():
        if p.grad is None:
            continue
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"phase 5: gradient of {k} is not finite")
        n_grad += 1
        if bool((p.grad != 0).any()) and not bool((p.detach() != before[k]).any()):
            stuck.append(k)
    print(f"phase5 {n_grad} of {len(before)} parameters have gradients; unchanged by 3 steps: "
          f"{stuck}")
    if stuck or n_grad != len(before):
        raise AssertionError(f"phase 5: parameters without gradient or unchanged: {stuck}")
    for name in TRAIN_PATH_KERNELS:
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"phase 5 never launched the {name} kernel")
    if any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"phase 5 ran a plain version: {counts}")
    return first, (state, timed_step, gen, pairs), counts


def hold_step(torch, rng, dev, first, label, affines=()):
    """Phase 5's first step (or one of phase 10's, ``first``) again with
    every kernel replaced by its plain version on the card (same weights,
    volumes, lambda, keypoint subset; ``affines``: a real-world step's
    aff_f, aff_m), and once more on volumes perturbed by half a bf16 ulp:
    the plain step's own answer to rounding-level noise is the yardstick.
    Then the step's alignment alone, through the kernels and through the
    plain versions (:func:`_align_grads`). Prints the readings under the
    rule above; returns whether they hold."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.training.config import build_backbone
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer, make_train_step

    config = first["config"]

    def plain_step(pair):
        net = KeyMorphNet(build_backbone(config), NUM_KEYPOINTS).to(dev)
        net.load_state_dict(first["init"])
        state = TrainState.create(net, make_optimizer(config, net))
        step = make_train_step(net, config, plain=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, None, *pair, None, None, 1.0, *affines, lmbda=first["lmbda"],
                        keypoint_idx=first["idx"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, float(m["loss"]), float(m["grad_norm"]), _grads(net)

    kernels.reset_counters()
    ms, loss, gn, grads = plain_step(first["pair"])
    counts = kernels.counters()
    if any(c["launches"] for c in counts.values()):
        raise AssertionError(f"{label} launched a kernel: {counts}")
    noisy = tuple(v * (1.0 + PERTURB * torch.tensor(
        rng.choice([-1.0, 1.0], size=tuple(v.shape)).astype(np.float32), device=dev))
        for v in first["pair"])
    _, loss_n, gn_n, grads_n = plain_step(noisy)

    # the alignment alone, on the keypoints of the plain extraction
    with torch.no_grad():
        net = KeyMorphNet(build_backbone(config), NUM_KEYPOINTS).to(dev)
        net.load_state_dict(first["init"])
        points = net(*first["pair"], plain=True)[:2]
        del net
    if first["config"].transform_type.startswith("tps"):
        points = tuple(p[:, first["idx"]] for p in points)
    aligned = _hold_align(torch, label, first, points, affines)
    print(f"{label} plain step: {ms:.3f} ms (kernel step {first['ms']:.3f} ms incl. warm-up)")
    held = _hold_readings(label, (first["loss"], first["grad_norm"], first["grads"]),
                          (loss, gn, grads), (loss_n, gn_n, grads_n))
    return held and aligned


def _hold_align(torch, label, first, points, affines=(), grid=False):
    """The step's alignment alone (:func:`_align_grads`) through the kernels
    and through the plain versions: their gradients to the keypoints within
    ALIGN_GRAD_REL (ALIGN_GRAD_REL_RW in real-world coordinates). Prints the
    reading; returns whether it holds."""
    g_kernel = _align_grads(torch, first, points, affines, plain=False, grid=grid)
    g_plain = _align_grads(torch, first, points, affines, plain=True, grid=grid)
    d_align = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_kernel, g_plain))
    tol_align = ALIGN_GRAD_REL_RW if affines else ALIGN_GRAD_REL
    print(f"{label} the alignment alone (fp32), its gradient to the keypoints, kernels vs plain: "
          f"rel L2 {d_align!r} (tol {tol_align!r})")
    return d_align <= tol_align


def _hold_readings(label, kernel, plain, noisy):
    """Phase 6's rule on readings of one step, each (loss, grad_norm,
    {parameter: gradient}): through the kernels, through the plain versions,
    and (``noisy``) through the plain versions with the net's input
    perturbed by PERTURB, the yardstick. Prints the readings and the bars
    they exceed; returns whether they hold."""
    (k_loss, k_gn, k_grads), (loss, gn, grads), (loss_n, gn_n, grads_n) = kernel, plain, noisy

    def rel_l2(ga, gb):
        per = {k: ((ga[k] - g).norm() / g.norm().clamp_min(1e-30)).item() for k, g in gb.items()}
        num = sum(((ga[k] - g) ** 2).sum().item() for k, g in gb.items())
        den = sum((g ** 2).sum().item() for g in gb.values())
        return per, (num / den) ** 0.5

    d_loss = abs(k_loss - loss) / abs(loss)
    d_gn = abs(k_gn - gn) / abs(gn)
    rel, whole = rel_l2(k_grads, grads)
    y_loss, y_gn = abs(loss_n - loss) / abs(loss), abs(gn_n - gn) / abs(gn)
    base, base_whole = rel_l2(grads_n, grads)
    tol_loss = max(TRAIN_LOSS_REL, NOISE_FACTOR * y_loss)
    tol_gn = max(TRAIN_GRAD_NORM_REL, NOISE_FACTOR * y_gn)
    worst = max(rel, key=lambda k: rel[k] / max(TRAIN_GRAD_REL_L2, NOISE_FACTOR * base[k]))
    print(f"{label} plain step: loss {loss!r} vs {k_loss!r}: rel {d_loss!r} (tol {tol_loss!r}); "
          f"grad_norm {gn!r} vs {k_gn!r}: rel {d_gn!r} (tol {tol_gn!r}); whole "
          f"gradient rel L2 {whole!r} (tol {TRAIN_GRAD_WHOLE_REL_L2!r})")
    print(f"{label} plain step with its input perturbed by {PERTURB} relative: loss rel "
          f"{y_loss!r}, grad_norm rel {y_gn!r}, whole gradient rel L2 {base_whole!r}")
    print(f"{label} per-parameter gradient rel L2, kernel vs plain: median "
          f"{float(np.median(list(rel.values())))!r}, max {max(rel.values())!r}; perturbed plain "
          f"vs plain: median {float(np.median(list(base.values())))!r}, max "
          f"{max(base.values())!r}; tolerance per parameter max({TRAIN_GRAD_REL_L2}, "
          f"{NOISE_FACTOR} x its perturbed-plain error); nearest to it: {worst} kernel "
          f"{rel[worst]!r}, perturbed {base[worst]!r}")
    for k in rel:
        print(f"{label}   {k}: kernel {rel[k]:.4f} perturbed {base[k]:.4f}")
    floor = GRAD_WHOLE_FLOOR * float(sum((g ** 2).sum().item() for g in grads.values())) ** 0.5
    beyond = [k for k in rel if rel[k] > max(TRAIN_GRAD_REL_L2, NOISE_FACTOR * base[k])]
    held = {k: (k_grads[k] - grads[k]).norm().item() for k in beyond}
    beyond = [k for k in beyond if held[k] > floor]
    print(f"{label} beyond their relative bar, held to {GRAD_WHOLE_FLOOR} x the whole "
          f"gradient's norm ({floor!r}): {held}; beyond both: {len(beyond)} of {len(rel)}")
    exceeded = [bar for bar, ok in (("loss", d_loss <= tol_loss), ("grad_norm", d_gn <= tol_gn),
                                    ("whole gradient", whole <= TRAIN_GRAD_WHOLE_REL_L2),
                                    ("per parameter", not beyond)) if not ok]
    print(f"{label} bars exceeded: {exceeded}")
    return not exceeded


def phase6(torch, rng, dev, first):
    """Phase 5's first step held against the same step on the plain
    versions (:func:`hold_step`)."""
    if not hold_step(torch, rng, dev, first, "phase6"):
        raise AssertionError("phase6: kernel training step and plain training step disagree")


def phase7(torch, net, pairs):
    """One training step at 256^3 on the serving net; with block-level
    gradient checkpointing if it does not fit without."""
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer, make_train_step

    config = _train_config(SPATIAL)
    gen = torch.Generator().manual_seed(SEED + 2)
    for ckpt in (False, True):
        net.backbone.use_checkpoint = ckpt
        state = TrainState.create(net, make_optimizer(config, net))
        step = make_train_step(net, config)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()
        t0 = time.perf_counter()
        try:
            state, m = step(state, gen, *pairs[0], None, None, 1.0)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            net.zero_grad(set_to_none=True)
            print(f"phase7 256^3 step, use_checkpoint={ckpt}: out of device memory")
            continue
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        print(f"phase7 256^3 step, use_checkpoint={ckpt}: {ms:.3f} ms (first step at this "
              f"size), loss {loss!r}, grad_norm {gn!r}, peak device memory {peak:.3f} GiB; "
              f"counters {json.dumps(kernels.counters())}")
        net.backbone.use_checkpoint = False
        net.zero_grad(set_to_none=True)
        if not (np.isfinite(loss) and np.isfinite(gn)):
            raise AssertionError("phase 7: loss or gradient norm not finite")
        return
    raise AssertionError("phase 7: the 256^3 step does not fit even with checkpointing")


def phase8(torch, train):
    """One steady 128^3 training step under torch.profiler."""
    state, step, gen, pairs = train
    _profile(torch, "phase8 step",
             lambda: step(state, gen, *pairs[1], None, None, 1.0))


APPROX_CENTERS = 64          # phase 9's approximate TPS: 64 of the 128 keypoints
GROUP_SPATIAL = (128, 128, 128)
GROUP_SUBJECTS = 4
GROUP_ITERS = 5
SERVE_TYPES = ["affine", "rigid", "tps_1"]
# phase 10: the canonical step in these modes (the real-world step on the
# anisotropic scanner affines below), each held against its plain version
# under phase 6's rule
TRAIN_MODES = (("affine", False), ("rigid", False), ("tps_0.1", True))


def _scanner_affines(torch, dev, spatial):
    """Anisotropic voxel -> world affines (1, 4, 4) of a pair of ``spatial``
    volumes, each centred on the scanner's origin: the fixed one 1.0 x 0.9 x
    1.2 mm, the moving one 1.05 x 0.95 x 1.15 mm turned 10 degrees about the
    first axis and shifted by a few millimetres (coordinates reach ~150 mm
    at 256^3)."""
    def affine(spacing, angle, shift):
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        a = np.eye(4)
        a[:3, :3] = rot @ np.diag(spacing)
        a[:3, 3] = -(a[:3, :3] @ (np.asarray(spatial) / 2.0)) + shift
        return torch.tensor(a[None].astype(np.float32), device=dev)

    return (affine((1.0, 0.9, 1.2), 0.0, (0.0, 0.0, 0.0)),
            affine((1.05, 0.95, 1.15), np.deg2rad(10.0), (3.0, -2.0, 4.0)))


def _spread(points):
    """RMS distance of each subject's keypoints to the group mean (N, K, 3)."""
    return (points - points.mean(dim=0, keepdim=True)).norm(dim=-1).pow(2).mean().sqrt().item()


def phase9(torch, rng, dev, net, pairs):
    """The registration API at the flagship width: KeyMorph serving in
    normalized and real-world coordinates and with approximate TPS, and
    groupwise registration; each kernel stage then held on its own inputs
    against its plain version. Returns the path's launch counts."""
    from keymorph_tpu_torch.models.keymorph import KeyMorph, _groupwise_iterate, align_pair
    from keymorph_tpu_torch.ops import coords
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.cuda import resample3d, tpsflow
    from keymorph_tpu_torch.ops.planes import affine_register_warp, planes_to_grid
    from keymorph_tpu_torch.ops.resample import align_img, align_planes, grid_to_planes
    from keymorph_tpu_torch.transforms import solvers

    img_f, img_m = pairs[2]
    aff_f, aff_m = _scanner_affines(torch, dev, SPATIAL)
    models = {"normalized": KeyMorph(net.backbone, NUM_KEYPOINTS, device=dev),
              "real-world": KeyMorph(net.backbone, NUM_KEYPOINTS, device=dev,
                                     align_keypoints_in_real_world_coords=True),
              "approximate": KeyMorph(net.backbone, NUM_KEYPOINTS, device=dev,
                                      num_tps_centers=APPROX_CENTERS)}
    calls = {"normalized": (SERVE_TYPES, {}),
             "real-world": (SERVE_TYPES, {"aff_f": aff_f, "aff_m": aff_m}),
             "approximate": (["tps_1"], {})}
    group = torch.cat([v for pair in _make_pairs(torch, rng, dev, GROUP_SPATIAL,
                                                 GROUP_SUBJECTS // 2) for v in pair])
    for mode, model in models.items():  # first calls: cuSOLVER and cuBLAS set-up
        model(img_f, img_m, calls[mode][0], **calls[mode][1])
    models["normalized"].groupwise_register(group, ["affine", "tps_1"], num_iters=1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    res, warped, warp_ms = {}, {}, {}
    for mode, model in models.items():
        types, kw = calls[mode]
        res[mode] = model(img_f, img_m, types, return_aligned_points=True, **kw)
        for name, r in res[mode].items():
            warped[mode, name], warp_ms[mode, name] = timed(lambda: align_img(r["grid"], img_m))
    inverse = torch.linalg.inv_ex(res["normalized"]["affine"]["matrix"])[0]
    (aff_warped, aff_planes), aff_ms = timed(lambda: affine_register_warp(inverse, img_m))
    r = res["approximate"]["tps_1"]
    planes, planes_ms = timed(lambda: align_pair(
        r["points_f"], r["points_m"], "tps", SPATIAL, lmbda=r["tps_lmbda"],
        compute_grid="planes", tps_centers=APPROX_CENTERS)["planes"])
    planes_warped, planes_warp_ms = timed(lambda: align_planes(planes, img_m))
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    gw, gw_ms = timed(lambda: models["normalized"].groupwise_register(
        group, ["affine", "tps_1"], num_iters=GROUP_ITERS))
    group_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = kernels.counters()

    for mode in models:
        for name, r in res[mode].items():
            print(f"phase9 {mode} {name}: extract {r['time_keypoint_extract'] * 1e3:.3f} ms, "
                  f"align {r['time_align'] * 1e3:.3f} ms, warp {warp_ms[mode, name]:.3f} ms")
    print(f"phase9 affine through affine_register_warp (planes + warp): {aff_ms:.3f} ms; "
          f"approximate TPS planes (fit + tps_planes, T={APPROX_CENTERS}) {planes_ms:.3f} ms, "
          f"warp {planes_warp_ms:.3f} ms")
    print(f"phase9 groupwise {GROUP_SUBJECTS} subjects at {GROUP_SPATIAL[0]}^3, affine and "
          f"tps_1, {GROUP_ITERS} iterations: {gw_ms:.3f} ms (affine {gw['affine']['time'] * 1e3:.3f} "
          f"ms, tps_1 {gw['tps_1']['time'] * 1e3:.3f} ms to the aligned points)")
    for name, g in gw.items():
        print(f"phase9 groupwise {name}: keypoint spread (RMS distance to the group mean) "
              f"before {_spread(g['grouppoints_m'])!r}, after {_spread(g['grouppoints_a'])!r}")
    print(f"phase9 peak device memory: serving {serve_peak:.3f} GiB, groupwise "
          f"{group_peak:.3f} GiB; counters {json.dumps(counts)}")
    for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_planes", "tps_flow",
                 "warp_planes"):
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"phase 9 never launched the {name} kernel")
    if any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"phase 9 ran a plain version: {counts}")

    # each kernel stage on its own inputs against its plain version
    def dist(a, b):
        return (a - b).abs().max().item()

    ok, grids = True, {}
    for mode in models:
        kw = {"aff_f": aff_f, "aff_m": aff_m, "moving_shape": SPATIAL} if mode == "real-world" else {}
        for name, r in res[mode].items():
            out = r["grid"]
            if not (tuple(out.shape) == (1, *SPATIAL, 3) and bool(torch.isfinite(out).all())
                    and bool(torch.isfinite(r["points_a"]).all())):
                raise AssertionError(f"phase 9 {mode} {name}: grid or points not finite")
            d_warp = dist(warped[mode, name], resample3d.warp_planes_plain(img_m, grid_to_planes(out)))
            line = f"phase9 {mode} {name}: warp vs plain on its grid {d_warp!r} (tol {WARP_ABS})"
            ok &= d_warp <= WARP_ABS
            if name.startswith("tps"):
                plain = align_pair(r["points_f"], r["points_m"], "tps", SPATIAL,
                                   lmbda=r["tps_lmbda"], plain=True,
                                   tps_centers=APPROX_CENTERS if mode == "approximate" else None,
                                   **kw)["grid"]
                grids[mode] = (out, plain)
                if mode != "real-world":  # held below, against float64
                    d_grid = dist(out, plain)
                    line += f"; tps_flow grid vs plain {d_grid!r} (tol {TPS_ABS})"
                    ok &= d_grid <= TPS_ABS
            print(line)
    r = res["approximate"]["tps_1"]
    d_aff = dist(aff_warped, resample3d.warp_planes_plain(img_m, aff_planes))
    d_aff_grid = dist(planes_to_grid(aff_planes), res["normalized"]["affine"]["grid"])
    d_planes = dist(planes, align_pair(r["points_f"], r["points_m"], "tps", SPATIAL,
                                       lmbda=r["tps_lmbda"], compute_grid="planes",
                                       tps_centers=APPROX_CENTERS, plain=True)["planes"])
    d_pw = dist(planes_warped, resample3d.warp_planes_plain(img_m, planes))
    print(f"phase9 affine_register_warp vs plain warp on its planes {d_aff!r} (tol {WARP_ABS}); "
          f"its planes vs the affine grid {d_aff_grid!r} (tol {TPS_ABS}); approximate tps_planes "
          f"vs plain {d_planes!r} (tol {TPS_ABS}), its warp vs plain {d_pw!r} (tol {WARP_ABS})")
    ok &= d_aff <= WARP_ABS and d_aff_grid <= TPS_ABS and d_planes <= TPS_ABS and d_pw <= WARP_ABS

    # The real-world spline on its own inputs: kernel and plain version each
    # against float64, every output taken to normalized coordinates in
    # float64. In millimetres the fp32 sum of w_t U_t (U up to ~5e5 at 256^3)
    # is itself inexact, so the two fp32 evaluations may each lie as far from
    # the truth as the plain one: the grids are held to each other within
    # twice the plain version's distance from float64 (plus TPS_ABS).
    r = res["real-world"]["tps_1"]
    rf = coords.convert_points_norm2real(r["points_f"], aff_f, SPATIAL)
    rm = coords.convert_points_norm2real(r["points_m"], aff_m, SPATIAL)
    theta = solvers.fit_tps(rf, rm, r["tps_lmbda"]).contiguous()
    pts = coords.convert_points_norm2real(coords.flat_norm_grid(SPATIAL, device=dev), aff_f,
                                          SPATIAL).contiguous()
    to_norm = torch.linalg.inv(aff_m[0].double())
    sizes = torch.tensor(SPATIAL, device=dev, dtype=torch.float64)

    def norm(moved):
        vox = moved.double() @ to_norm[:3, :3].T + to_norm[:3, 3]
        return 2.0 * (vox + 0.5) / sizes - 1.0

    ref = norm(tpsflow.tps_flow_plain(theta, rf.contiguous(), pts, dtype=torch.float64))
    dk = dist(norm(tpsflow.tps_flow(theta, rf.contiguous(), pts)), ref)
    dp = dist(norm(tpsflow.tps_flow_plain(theta, rf.contiguous(), pts)), ref)
    top = (rf.abs().max().item(), pts.abs().max().item())
    d_rw = dist(*grids["real-world"])
    print(f"phase9 real-world tps_flow (control points up to {top[0]:.1f} mm, grid up to "
          f"{top[1]:.1f} mm) against float64, normalized units: kernel {dk!r}, plain {dp!r} "
          f"(tol max({TPS_ABS}, {FLOAT64_FACTOR} x plain)); the real-world grid vs plain "
          f"{d_rw!r} (tol {2.0 * dp + TPS_ABS!r} = 2 x plain's distance + {TPS_ABS})")
    ok &= dk <= max(TPS_ABS, FLOAT64_FACTOR * dp) and d_rw <= 2.0 * dp + TPS_ABS
    del ref, pts

    # groupwise: the batched extraction against the plain path (with phase
    # 3's yardstick), the TPS grids against the plain spline
    from keymorph_tpu_torch.models.fast_unet import fast_unet_forward
    from keymorph_tpu_torch.models.layers import center_of_mass_plain

    def keypoints(vols):
        return center_of_mass_plain(fast_unet_forward(net.backbone, vols, plain=True))

    kp = gw["affine"]["grouppoints_m"]
    plain_kp = keypoints(group)
    d_kp = dist(kp, plain_kp)
    y_kp = dist(keypoints(group * (1 + PERTURB)), plain_kp)
    tol_kp = max(KEYPOINT_ABS, NOISE_FACTOR * y_kp)
    # (the same batch of 4 as the run's grids: the fit's LU, and so theta,
    # depends on the batch size's algorithm, and the TPS system is
    # ill-conditioned enough to show it)
    lmbda = torch.ones(GROUP_SUBJECTS, device=dev)
    _, mean = _groupwise_iterate(kp, lmbda[:1], None, "tps", GROUP_ITERS)
    d_gg = dist(gw["tps_1"]["groupgrids"],
                align_pair(mean.expand_as(kp), kp, "tps", GROUP_SPATIAL, lmbda=lmbda,
                           plain=True)["grid"])
    print(f"phase9 groupwise: batched keypoints vs the plain path {d_kp!r} (yardstick {y_kp!r}, "
          f"tol {tol_kp!r}); tps_1 grids vs the plain spline {d_gg!r} (tol {TPS_ABS})")
    ok &= d_kp <= tol_kp and d_gg <= TPS_ABS
    for g in gw.values():
        if not all(bool(torch.isfinite(v).all()) for k, v in g.items() if k != "time"):
            raise AssertionError("phase 9 groupwise output not finite")
    if not ok:
        raise AssertionError("phase 9: a kernel stage disagrees with its plain version")

    # the rigid fit's SVD on the card: a (1, 3, 3) cuSOLVER call
    pf, pm = res["normalized"]["rigid"]["points_f"], res["normalized"]["rigid"]["points_m"]
    H = (pf - pf.mean(1, keepdim=True)).transpose(1, 2) @ (pm - pm.mean(1, keepdim=True))
    svd_ms = _cuda_ms(lambda: torch.linalg.svd(H, full_matrices=False), 50)
    rigid_ms = _cuda_ms(lambda: solvers.fit_rigid(pf, pm), 50)
    affine_ms = _cuda_ms(lambda: solvers.fit_affine(pf, pm), 50)
    _, svd_host = timed(lambda: torch.linalg.svd(H, full_matrices=False))
    print(f"phase9 rigid fit on the card (T={NUM_KEYPOINTS}): fit_rigid {rigid_ms:.4f} ms a call "
          f"(50 back to back), of it torch.linalg.svd (1, 3, 3) {svd_ms:.4f} ms; fit_affine "
          f"{affine_ms:.4f} ms; one svd call on the host clock {svd_host:.4f} ms")
    return counts


def phase10(torch, rng, dev, first):
    """The canonical 128^3 step as affine, rigid and real-world TPS
    registration, each from phase 5's initial weights on phase 5's first
    pair, held against the same step on the plain versions (phase 6's rule,
    :func:`hold_step`). Returns the launch counts of the three kernel steps
    and, for each step's label, whether it holds against its plain step."""
    import dataclasses

    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.training.config import build_backbone
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer, make_train_step

    total, held = None, {}
    needed = ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
              "warp_planes", "warp_planes_grad")
    for transform_type, rw in TRAIN_MODES:
        config = dataclasses.replace(first["config"], transform_type=transform_type,
                                     align_keypoints_in_real_world_coords=rw)
        net = KeyMorphNet(build_backbone(config), NUM_KEYPOINTS).to(dev)
        net.load_state_dict(first["init"])
        state = TrainState.create(net, make_optimizer(config, net))
        step = make_train_step(net, config)
        affines = _scanner_affines(torch, dev, TRAIN_SPATIAL) if rw else ()
        label = f"phase10 {transform_type}{' real-world' if rw else ''}"
        torch.cuda.synchronize()
        kernels.reset_counters()
        t0 = time.perf_counter()
        state, m = step(state, None, *first["pair"], None, None, 1.0, *affines,
                        keypoint_idx=first["idx"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.counters()
        total = counts if total is None else {
            k: {c: total[k][c] + v[c] for c in v} for k, v in counts.items()}
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        print(f"{label} step: {ms:.3f} ms (first at this mode), loss {loss!r}, grad_norm "
              f"{gn!r}; counters {json.dumps(counts)}")
        grads = _grads(net)
        if not (np.isfinite(loss) and np.isfinite(gn)
                and all(bool(torch.isfinite(g).all()) for g in grads.values())):
            raise AssertionError(f"{label}: loss, grad_norm or a gradient is not finite")
        for name in needed + (("tps_flow",) if rw else ()):
            if counts[name]["launches"] <= 0:
                raise AssertionError(f"{label} never launched the {name} kernel")
        if any(c["plain_calls"] for c in counts.values()):
            raise AssertionError(f"{label} ran a plain version: {counts}")
        held[label] = hold_step(torch, rng, dev, {**first, "config": config, "lmbda": None,
                                                  "ms": ms, "loss": loss, "grad_norm": gn,
                                                  "grads": grads}, label, affines)
        del net, state, step, grads
        torch.cuda.empty_cache()
    return total, held


# phase 11: the register CLI on an IXI-like pair at the flagship width
REG_SHAPE = (256, 256, 150)          # an IXI T1 scan's grid
REG_SPACING = (0.94, 0.94, 1.2)      # and its voxel size, mm
REG_LABELS = 14                      # labels 0-13 of each scan's segmentation
REG_ALIGNS = ["rigid", "affine", "tps_1"]
REG_METRICS = ["mse", "harddice", "harddiceroi", "hausd", "jdstd", "jdlessthan0"]
REG_AUGS = ["rot0", "rot45"]
# The CLI's metric JSONs against a float64 recomputation on the CPU from the
# plain versions' warps of the CLI's own grids (whose labels and images must
# equal the CLI's saved ones exactly, WARP_ABS): the mse within MSE_REL of
# its value (an fp32 mean over 16.7e6 voxels on the card); the Dice values,
# from identical labels and so from identical counts, each region's within
# DICE_ABS, one fp32 ulp of 1.0 (the fp32 division and 1 - x), their mean
# within one such ulp per region (each enters the fp32 sum with its own
# rounding); the Hausdorff distance exactly (the same masks, float64 on the
# host in both); jdstd within JD_STD_ABS and jdlessthan0 within JD_LT0_ABS
# (fp32 central differences of a grid whose steps are 2/256, each off by up
# to ~6e-8, give each determinant ~2e-7 of rounding; JD_LT0_ABS is 16 of
# the 252^3 cropped voxels). Measured at seed 0 on NVIDIA H100 80GB HBM3,
# 700.00 W: mse 7.5e-8, Dice 7.6e-8 (regions 4.4e-8), jdstd 8.1e-8,
# jdlessthan0 0, over 6 aligns.
MSE_REL = 1e-6
DICE_ABS = 2.0 ** -23
DICE_MEAN_ABS = (REG_LABELS - 1) * DICE_ABS
JD_STD_ABS = 1e-6
JD_LT0_ABS = 1e-6


def _register_files(aligns, augs, i=0, fixed="fixed", moving="moving"):
    """The file names ``run_eval`` writes for pair ``i`` with segmentations
    and no keypoint weights, by its naming scheme
    (``keymorph_tpu_torch/cli/eval_pairwise.py``, ``_save_pair_common``,
    ``_save_pair_align`` and the metrics paths)."""
    names = {f"img_f_{i}-{fixed}.npy", f"seg_f_{i}-{fixed}.npy", f"points_f_{i}-{fixed}.npy"}
    for aug in augs:
        names |= {f"img_m_{i}-{moving}-{aug}.npy", f"seg_m_{i}-{moving}-{aug}.npy",
                  f"points_m_{i}-{moving}-{aug}.npy"}
        for align in aligns:
            tag = f"{i}-{fixed}-{moving}-{aug}-{align}"
            names |= {f"metrics-{aug}-{align}.json", f"img_a_{tag}.npy", f"grid_{tag}.npy",
                      f"seg_a_{tag}.npy", f"points_a_{tag}.npy"}
    return names


def _phantom(torch, rng, dev):
    """An IXI-like pair (REG_SHAPE): Gaussian blobs as ``_make_pairs`` makes
    them (the moving blobs displaced by a few voxels) plus 0.2 x white
    noise, and for each scan a REG_LABELS-label segmentation (label k where
    blob k dominates above a threshold, else 0). Returns host numpy
    [(img, seg), (img, seg)]."""
    axes = [torch.linspace(-1, 1, s, device=dev) for s in REG_SHAPE]
    n_blobs = REG_LABELS - 1
    c = rng.uniform(-0.6, 0.6, (n_blobs, 3))
    width = rng.uniform(0.02, 0.08, n_blobs)
    amp = rng.uniform(0.3, 1.0, n_blobs)
    shift = rng.normal(0, 0.03, (n_blobs, 3))
    out = []
    for cs in (c, c + shift):
        img = torch.zeros(REG_SHAPE, device=dev)
        best = torch.zeros(REG_SHAPE, device=dev)
        seg = torch.zeros(REG_SHAPE, dtype=torch.int16, device=dev)
        for k, ((cz, cy, cx), wd, a) in enumerate(zip(cs, width, amp)):
            g = (torch.exp(-(axes[0] - cz) ** 2 / wd)[:, None, None]
                 * torch.exp(-(axes[1] - cy) ** 2 / wd)[None, :, None]
                 * torch.exp(-(axes[2] - cx) ** 2 / wd)[None, None, :])
            img += a * g
            take = (g > best) & (g > 0.3)
            seg[take] = k + 1
            best = torch.maximum(best, g)
        noise = torch.tensor(rng.random(REG_SHAPE, dtype=np.float32), device=dev)
        out.append(((img.clamp(max=1.0) + 0.2 * noise).cpu().numpy(), seg.cpu().numpy()))
    return out


def _ixi_affine(angle_deg):
    """Voxel -> world of a REG_SHAPE scan of REG_SPACING voxels centred on
    the scanner's origin, turned by ``angle_deg`` about the first axis."""
    a = np.deg2rad(angle_deg)
    aff = np.eye(4)
    aff[:3, :3] = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                            [0, np.sin(a), np.cos(a)]]) @ np.diag(REG_SPACING)
    aff[:3, 3] = -(aff[:3, :3] @ (np.asarray(REG_SHAPE) / 2.0))
    return aff


def phase11(torch, dev):
    """The register CLI end to end at full width on the flagship net's
    seeded weights, from a reference-format checkpoint; every kernel stage
    then held against its plain version on the CLI's own outputs, every
    metric against a float64 recomputation, the keypoints against the plain
    route. Returns the path's launch counts and the directory of its inputs
    (the .nii.gz scans and ``weights.pt``), which phase 15 reuses and the
    caller removes."""
    import shutil
    import tempfile

    from keymorph_tpu_torch import metrics as M
    from keymorph_tpu_torch import utils as U
    from keymorph_tpu_torch.augment import build_affine_matrix, fixed_affine_params
    from keymorph_tpu_torch.cli import register
    from keymorph_tpu_torch.cli.eval_pairwise import _build_metric_dict, _per_pair_dice
    from keymorph_tpu_torch.cli.script_utils import load_dict_from_json, parse_test_aug
    from keymorph_tpu_torch.data import Preprocessor, save_nifti
    from keymorph_tpu_torch.data.nifti import gzip_reader
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops import resample
    from keymorph_tpu_torch.ops.cuda import resample3d
    from keymorph_tpu_torch.tools.trace_summary import profile_fn
    from keymorph_tpu_torch.transforms.affine import affine_flow

    size = SPATIAL[0]
    rng = np.random.default_rng([SEED, 11])
    net = KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **UNET),
                                   torch.Generator().manual_seed(SEED)), NUM_KEYPOINTS).to(dev)
    net.eval()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase11_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        (img_f, seg_f), (img_m, seg_m) = _phantom(torch, rng, dev)
        files = {}
        for name, data, aff in (("fixed", img_f, _ixi_affine(0.0)),
                                ("fixed_seg", seg_f, _ixi_affine(0.0)),
                                ("moving", img_m, _ixi_affine(10.0)),
                                ("moving_seg", seg_m, _ixi_affine(10.0))):
            files[name] = str(tmp / f"{name}.nii.gz")
            save_nifti(files[name], data, aff)
        weights = tmp / "weights.pt"
        torch.save({"state_dict": {"backbone." + k: v.cpu()
                                   for k, v in net.backbone.state_dict().items()}}, weights)
        write_s = time.perf_counter() - t0
        out_dir = tmp / "out"
        argv = ["--moving", files["moving"], "--fixed", files["fixed"],
                "--moving_seg", files["moving_seg"], "--fixed_seg", files["fixed_seg"],
                "--backbone", "truncatedunet", "--use_amp", "--num_keypoints", str(NUM_KEYPOINTS),
                "--size", str(size), "--list_of_aligns", *REG_ALIGNS,
                "--list_of_metrics", *REG_METRICS, "--list_of_augs", *REG_AUGS,
                "--load_path", str(weights), "--save_dir", str(out_dir)]
        print(f"phase11 inputs: {REG_SHAPE} at {REG_SPACING} mm, {REG_LABELS} labels, .nii.gz "
              f"written in {write_s:.3f} s; python -m keymorph_tpu_torch.cli.register "
              f"{' '.join(a if not a.startswith(str(tmp)) else '<tmp>/' + Path(a).name for a in argv)}")

        # every warp of the path goes through ops/resample.py:grid_sample:
        # tally its calls by (mode, channels)
        warps, real = {}, resample.grid_sample

        def tallied(img, grid, mode="bilinear"):
            key = f"{mode} C={img.shape[1]}"
            warps[key] = warps.get(key, 0) + 1
            return real(img, grid, mode=mode)

        stages = {}
        resample.grid_sample = tallied
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_counters()
            metrics, prof = profile_fn(lambda: register.main(argv, stage_times=stages))
            counts = kernels.counters()
        finally:
            resample.grid_sample = real
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print("phase11 stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; the run's wall {prof['wall_ms'] / 1e3:.3f} (decode and preprocess run in "
              f"the prefetch thread; the rest is building the model and loading the weights)")
        busy = ("not measured (torch.profiler recorded no device activity)"
                if prof["busy_ms"] is None else f"{prof['busy_ms'] / 1e3:.3f} s, "
                f"{prof['busy_ms'] / prof['wall_ms']:.4f} of the run's wall")
        print(f"phase11 device busy {busy}; peak device memory {peak:.3f} GiB; gzip reader "
              f"{gzip_reader()}")
        for name, ms, n in prof["ops"][:12]:
            print(f"phase11 {ms:.3f} ms {n}x {name[:110]}")
        print(f"phase11 counters {json.dumps(counts)}; warp_planes launches by (mode, C) "
              f"{json.dumps(warps)}")

        # launches: every kernel of the path, the warp in each form, no plain version
        for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_flow",
                     "warp_planes"):
            if counts[name]["launches"] <= 0:
                raise AssertionError(f"phase 11 never launched the {name} kernel")
        if any(c["plain_calls"] for c in counts.values()):
            raise AssertionError(f"phase 11 ran a plain version: {counts}")
        # the augmentation warps the image (bilinear, C = 1) and its one-hot
        # segmentation (nearest, C = REG_LABELS), the scorer both (bilinear)
        want_warps = {"bilinear C=1", f"nearest C={REG_LABELS}", f"bilinear C={REG_LABELS}"}
        if set(warps) != want_warps or sum(warps.values()) != counts["warp_planes"]["launches"]:
            raise AssertionError(f"phase 11 warps {warps} vs launches {counts['warp_planes']}")

        # the metric keys and the artifact files, by the harness's schemes
        keys = set(_build_metric_dict(REG_METRICS, REG_AUGS, REG_ALIGNS, [("fixed", "moving")]))
        pair_dir = out_dir / "register" / "0_fixed_moving"
        got = set(p.name for p in pair_dir.iterdir())
        want = _register_files(REG_ALIGNS, REG_AUGS)
        print(f"phase11 metric keys {len(metrics)} (expected {len(keys)}), artifacts "
              f"{len(got)} (expected {len(want)})")
        if set(metrics) != keys or any(len(v) != 1 for v in metrics.values()) or got != want:
            raise AssertionError(f"phase 11 keys or artifacts differ: keys {sorted(set(metrics) ^ keys)}, "
                                 f"files {sorted(got ^ want)}")

        def load(name):
            return np.load(pair_dir / name)

        # the CLI's preprocessing is the Preprocessor's
        pre = Preprocessor(size=(size,) * 3)
        ref_f = pre.load(files["fixed"], files["fixed_seg"])
        ref_m = pre.load(files["moving"], files["moving_seg"])
        if not (np.array_equal(load("img_f_0-fixed.npy"), ref_f["img"])
                and np.array_equal(load("seg_f_0-fixed.npy"), ref_f["seg"].astype(np.int64))):
            raise AssertionError("phase 11: the CLI's fixed volumes are not the Preprocessor's")
        n_cls = int(max(ref_f["seg"].max(), ref_m["seg"].max())) + 1
        img_f_t = torch.tensor(ref_f["img"][None], device=dev)
        img_f64 = torch.tensor(ref_f["img"][None], dtype=torch.float64)
        seg_f_oh = U.one_hot(torch.tensor(ref_f["seg"][None].astype(np.int64)), n_cls)
        seg_f64 = seg_f_oh.double()
        ch0_f = M.ch0_mask(seg_f_oh)
        ch_mask = torch.ones((1, n_cls), dtype=torch.float64)
        ok, worst = True, {}

        def check(name, got_v, want_v, bar):
            nonlocal ok
            d = float(np.max(np.abs(np.asarray(got_v, np.float64) - np.asarray(want_v))))
            worst[name] = max(worst.get(name, 0.0), d)
            ok &= d <= bar
            return d

        for aug in REG_AUGS:
            # the augmentation through the plain warps
            M_aug = build_affine_matrix(fixed_affine_params(1, 3, parse_test_aug(aug), device=dev))
            planes = resample.grid_to_planes(affine_flow(torch.linalg.inv(M_aug), (size,) * 3))
            img_m0 = torch.tensor(ref_m["img"][None], device=dev)
            seg_m0 = U.one_hot(torch.tensor(ref_m["seg"][None].astype(np.int64), device=dev), n_cls)
            img_m_aug = resample3d.warp_planes_plain(img_m0, planes, "bilinear")
            seg_m_aug = resample3d.warp_planes_plain(seg_m0, planes, "nearest")
            del seg_m0, planes
            d_img = (img_m_aug[0].cpu() - torch.tensor(load(f"img_m_0-moving-{aug}.npy"))).abs().max().item()
            lab_ok = np.array_equal(seg_m_aug.argmax(1).cpu().numpy(),
                                    load(f"seg_m_0-moving-{aug}.npy"))
            print(f"phase11 {aug}: augmented moving image vs the plain warp {d_img!r} (tol "
                  f"{WARP_ABS}), its segmentation's labels equal: {lab_ok}")
            ok &= d_img <= WARP_ABS and lab_ok

            # keypoints against the plain route on the same preprocessed pair
            with torch.no_grad():
                pf, pm, _ = net(img_f_t, img_m_aug, plain=True)
                pf1, pm1, _ = net(img_f_t * (1 + PERTURB), img_m_aug * (1 + PERTURB), plain=True)
            d_kp = max(np.abs(load("points_f_0-fixed.npy") - pf[0].cpu().numpy()).max(),
                       np.abs(load(f"points_m_0-moving-{aug}.npy") - pm[0].cpu().numpy()).max())
            y_kp = max((pf1 - pf).abs().max().item(), (pm1 - pm).abs().max().item())
            tol_kp = max(KEYPOINT_ABS, NOISE_FACTOR * y_kp)
            print(f"phase11 {aug}: the CLI's keypoints vs the plain route {float(d_kp)!r} "
                  f"(yardstick {y_kp!r}, tol {tol_kp!r})")
            ok &= d_kp <= tol_kp

            for align in REG_ALIGNS:
                tag = f"0-fixed-moving-{aug}-{align}"
                grid = torch.tensor(load(f"grid_{tag}.npy")[None], device=dev)
                planes = resample.grid_to_planes(grid)
                img_a = resample3d.warp_planes_plain(img_m_aug, planes, "bilinear")
                seg_a = resample3d.warp_planes_plain(seg_m_aug, planes, "bilinear")
                del planes
                d_img = (img_a[0].cpu() - torch.tensor(load(f"img_a_{tag}.npy"))).abs().max().item()
                labels = seg_a.argmax(1)
                lab_ok = np.array_equal(labels[0].cpu().numpy(), load(f"seg_a_{tag}.npy")[0])
                ok &= d_img <= WARP_ABS and lab_ok
                # every metric again, float64 on the CPU
                saved = load_dict_from_json(pair_dir / f"metrics-{aug}-{align}.json")
                mse = float(((img_f64 - img_a.cpu().double()) ** 2).mean())
                seg_a_host = seg_a.cpu()
                del seg_a
                hd_mean, hd_regions = _per_pair_dice(seg_a_host, seg_f64, True, ch_mask, True,
                                                     dtype=torch.float64)
                hausd = M.hausdorff_from_ch0_masks(M.ch0_mask(seg_a_host), ch0_f)
                det = M.jacobian_determinant(grid.cpu().movedim(-1, 1), dtype=torch.float64)
                jd_std = float(torch.std(det, correction=0))
                jd_lt0 = float(torch.mean((det <= 0).double()))
                del seg_a_host, det, grid
                d_mse = check("mse rel", saved["mse"] / mse - 1.0, 0.0, MSE_REL)
                d_hd = check("harddice", saved["harddice"], 1.0 - float(hd_mean[0]),
                             DICE_MEAN_ABS)
                d_roi = check("harddiceroi", saved["harddiceroi"],
                              (1.0 - hd_regions[0]).numpy(), DICE_ABS)
                d_hs = check("hausd", saved["hausd"], hausd, 0.0)
                d_js = check("jdstd", saved["jdstd"], jd_std, JD_STD_ABS)
                d_jl = check("jdlessthan0", saved["jdlessthan0"], jd_lt0, JD_LT0_ABS)
                print(f"phase11 {aug} {align}: warped image vs plain {d_img!r} (tol {WARP_ABS}), "
                      f"labels equal {lab_ok}; JSON vs float64: mse {saved['mse']!r} rel "
                      f"{d_mse!r} (tol {MSE_REL}), harddice {saved['harddice']!r} {d_hd!r} "
                      f"(tol {DICE_MEAN_ABS!r}), harddiceroi {d_roi!r} (tol {DICE_ABS!r}), "
                      f"hausd {saved['hausd']!r} "
                      f"{d_hs!r} (tol 0), jdstd {saved['jdstd']!r} {d_js!r} (tol {JD_STD_ABS}), "
                      f"jdlessthan0 {saved['jdlessthan0']!r} {d_jl!r} (tol {JD_LT0_ABS})")
            del img_m_aug, seg_m_aug
        print(f"phase11 largest distances from the float64 recomputation: {json.dumps(worst)}")
        if not ok:
            raise AssertionError("phase 11: the register CLI's outputs disagree with the plain "
                                 "versions or the float64 metrics")
        return counts, tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        shutil.rmtree(tmp / "out", ignore_errors=True)


# phase 12: the main CLI, pretraining, the same-resolution step and the
# backbones that are not on the serving path, at the flagship width
RUN_SUBJECTS = (("T1", True), ("T1", True), ("T2", True), ("T1", False), ("T2", False))
RUN_SIZE = (128, 128, 128)           # the model's size (--img_size)
# the fp32 resize against float64 of the same weights: sums of at most ~6
# terms an axis in three passes (x max|ref|)
RESIZE_REL = 1e-6
# heatmaps through the kernels vs the plain route: a bf16 output is within
# one ulp of the same fp32 sum in either route, 2^-8 of the largest value
# (x max|plain|), or NOISE_FACTOR x the plain route against itself on
# volumes moved by PERTURB
HEATMAP_REL = 2.0 ** -8
RUN_LOG_KEYS = {"train": {"epoch", "mse", "loss", "grad_norm", "epoch_time", "steps_per_sec"},
                "pretrain": {"epoch", "mse", "loss", "epoch_time"}}
OTHER_BACKBONES = (("conv", dict(backbone="conv", use_amp=False)),
                   ("residualunetse", dict(backbone="residualunetse", use_amp=False)),
                   ("residualunetse on the kernels", dict(backbone="residualunetse", use_amp=True)),
                   ("linear head", dict(kp_layer="linear")))
# what the bf16 residual net's step launches besides the DoubleConv step's kernels
RESIDUAL_TRAIN_KERNELS = ("conv3x3_fused_flat_res", "conv3x3_weight_grad",
                          "conv_transpose3x3s2_flat", "conv_transpose3x3s2_input_grad",
                          "conv_transpose3x3s2_weight_grad", "scse_gate_flat", "scse_gate_bwd",
                          "lift1x1_flat")


def _add_counts(total, counts):
    return counts if total is None else {
        k: {c: total[k][c] + v[c] for c in v} for k, v in counts.items()}


def _expect(label, counts, names, plain_ok=False):
    """Every kernel of ``names`` launched; no plain version ran unless
    ``plain_ok`` (a path that holds a kernel against its plain version)."""
    for name in names:
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"{label} never launched the {name} kernel")
    if not plain_ok and any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"{label} ran a plain version: {counts}")


def _payload(model_dir, epoch):
    import torch

    return torch.load(model_dir / "checkpoints" / f"epoch{epoch}_model" / "checkpoint.pt",
                      map_location="cpu", weights_only=True)


def _train_log(model_dir):
    with open(model_dir / "train_log.jsonl") as fh:
        return [json.loads(line) for line in fh]


def _phase12_cli(torch, rng, dev, tmp):
    """(a) and (c): ``cli.run`` pretrains the flagship net, hands its weights
    to a same-resolution TPS run, resumes that run, and evaluates it, on
    RUN_SUBJECTS IXI-like scans written as .nii.gz. Returns the runs' summed
    launch counts and the subjects' paths."""
    from keymorph_tpu_torch.cli import hyperparameters as hp
    from keymorph_tpu_torch.cli import run
    from keymorph_tpu_torch.cli.eval_pairwise import _build_metric_dict
    from keymorph_tpu_torch.data import save_nifti
    from keymorph_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    rows, paths = [], []
    scans = [s for _ in range((len(RUN_SUBJECTS) + 1) // 2) for s in _phantom(torch, rng, dev)]
    for i, ((mod, train), (img, seg)) in enumerate(zip(RUN_SUBJECTS, scans)):
        img_p, seg_p = str(tmp / f"sub{i}.nii.gz"), str(tmp / f"sub{i}_seg.nii.gz")
        save_nifti(img_p, img, _ixi_affine(5.0 * i))
        save_nifti(seg_p, seg, _ixi_affine(5.0 * i))
        rows.append(f"{img_p},{seg_p},None,{mod},{train}")
        paths.append(img_p)
    csv = tmp / "data.csv"
    csv.write_text("img_path,seg_path,mask_path,modality,train\n" + "\n".join(rows) + "\n")
    print(f"phase12 inputs: {len(RUN_SUBJECTS)} subjects {REG_SHAPE} at {REG_SPACING} mm with "
          f"{REG_LABELS}-label segmentations, .nii.gz written in {time.perf_counter() - t0:.3f} s")

    out = tmp / "out"
    common = ["--num_keypoints", str(NUM_KEYPOINTS), "--data_path", str(csv), "--train_dataset",
              "csv", "--save_dir", str(out), "--backbone", "truncatedunet", "--use_amp",
              "--img_size", *map(str, RUN_SIZE), "--lr", str(TRAIN_LR), "--log_interval", "1",
              "--seed", str(SEED)]
    train = common + ["--job_name", "train", "--transform_type", "tps_loguniform",
                      "--train_same_resolution"]
    pre_ckpt = out / "pretrain" / "checkpoints" / "epoch2_model"
    runs = (
        ("pretrain", common + ["--job_name", "pretrain", "--run_mode", "pretrain",
                               "--debug_mode"]),
        ("train (weights-only handoff)", train + ["--run_mode", "train", "--debug_mode",
                                                  "--load_path", str(pre_ckpt),
                                                  "--load_weights_only"]),
        ("train --resume_latest", train + ["--run_mode", "train", "--resume_latest",
                                           "--epochs", "3", "--steps_per_epoch", "2"]),
        ("eval", common + ["--job_name", "train", "--run_mode", "eval", "--debug_mode",
                           "--load_path", str(out / "train" / "checkpoints" / "epoch3_model")]),
    )
    needed = {"pretrain": ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv",
                           "conv3x3_input_grad", "warp_planes"),
              "train": ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
                        "tps_flow", "warp_planes", "warp_planes_grad"),
              "eval": ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "warp_planes")}
    total = None
    for label, argv in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()
        t0 = time.perf_counter()
        run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.counters()
        print(f"phase12 cli {label}: {wall:.3f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; launches "
              f"{json.dumps({k: c['launches'] for k, c in counts.items()})}")
        _expect(f"phase 12 cli {label}", counts, needed[label.split()[0]])
        total = _add_counts(total, counts)

    # keymorph_tpu's files and keys
    pre, trained = out / "pretrain", out / "train"
    p2, t2, t3 = _payload(pre, 2), _payload(trained, 2), _payload(trained, 3)
    logs = {"pretrain": _train_log(pre), "train": _train_log(trained)}
    with open(trained / "eval" / "summary_unimodal.json") as fh:
        summary_uni = json.load(fh)
    checks = {
        "pretrain checkpoint": (set(p2) == {"params", "opt_state", "step", "epoch", "ref_points"}
                                and p2["step"] == 6
                                and tuple(p2["ref_points"].shape) == (1, NUM_KEYPOINTS, 3)
                                and float(p2["ref_points"].abs().max()) <= 1.0),
        # the handoff restarts the optimizer: 2 debug epochs of 3 steps, then 2 more
        "train checkpoints": (set(t2) == set(t3) == {"params", "opt_state", "step", "epoch"}
                              and t2["step"] == 6 and t3["step"] == 8 and t3["epoch"] == 3
                              and all(float(s["step"]) == 8
                                      for s in t3["opt_state"]["state"].values())),
        "pretrain log epochs": [r["epoch"] for r in logs["pretrain"]] == [1, 2],
        "train log epochs (the resumed run began at 3)":
            [r["epoch"] for r in logs["train"]] == [1, 2, 3],
        "log keys": all(set(r) == RUN_LOG_KEYS[k] and np.isfinite(r["loss"])
                        for k, rs in logs.items() for r in rs),
        "args.json": all((d / "args.json").is_file() for d in (pre, trained)),
        # debug mode scores the test loader's first pair (T1, T1) in each suite
        "T1:T1 scored": all(summary_uni[f"{m}:T1:T1:rot0:affine"] is not None
                            for m in hp.EVAL_METRICS),
    }
    for suite, names in (("unimodal", hp.EVAL_UNI_NAMES), ("multimodal", hp.EVAL_MULTI_NAMES)):
        with open(trained / "eval" / f"summary_{suite}.json") as fh:
            summary = json.load(fh)
        keys = set(_build_metric_dict(hp.EVAL_METRICS, ["rot0"], ["affine"], names))
        checks[f"summary_{suite} keys"] = set(summary) == keys and all(
            v is None or np.isfinite(v) for v in summary.values())
        scored = {k: v for k, v in summary.items() if v is not None}
        print(f"phase12 eval summary_{suite}.json: {len(summary)} keys, scored {scored}")
    print(f"phase12 train_log.jsonl: pretrain {json.dumps(logs['pretrain'])}; train "
          f"{json.dumps(logs['train'])}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 12: the CLI's files differ from keymorph_tpu's: {failed}")
    return total, paths


def _phase12_steps(torch, rng, dev, img):
    """(b): the pretrain step on ``img`` (1, 1, *RUN_SIZE) and the
    same-resolution step at REG_SHAPE, each through the kernels and again on
    the plain versions (phase 6's rule, the yardstick moving the net's input
    only; the same-resolution step's alignment alone on the grid path), and
    the resize against float64.
    Returns the kernel steps' launch counts and, for each step's label,
    whether it holds against its plain step (the resize raises)."""
    import dataclasses

    from keymorph_tpu_torch import augment
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.resize import resize_trilinear, resize_weights
    from keymorph_tpu_torch.training.config import build_backbone
    from keymorph_tpu_torch.training.pretrain import (
        PRETRAIN_MAX_PARAMS, make_pretrain_step, pick_reference_subject)
    from keymorph_tpu_torch.training.train import (
        TrainState, make_optimizer, make_train_step_sameres)

    config = dataclasses.replace(_train_config(RUN_SIZE), train_same_resolution=True)
    init = init_weights(build_backbone(config), torch.Generator().manual_seed(SEED + 12))
    init = {f"backbone.{k}": v for k, v in init.state_dict().items()}

    def state_of(perturb=False):
        net = KeyMorphNet(build_backbone(config), NUM_KEYPOINTS).to(dev)
        net.load_state_dict(init)
        if perturb:  # the yardstick: only the net's input moves, the loss's volumes do not
            features = net.features
            net.features = lambda v, plain=False: features(v * (1.0 + PERTURB * torch.tensor(
                rng.choice([-1.0, 1.0], size=tuple(v.shape)).astype(np.float32), device=dev)),
                plain=plain)
        return net, TrainState.create(net, make_optimizer(config, net))

    def reading(net, m):
        grads = _grads(net)
        gn = float(sum((g.float() ** 2).sum() for g in grads.values()) ** 0.5)
        return float(m["loss"]), gn, grads

    # the pretrain step
    _, ref_points, _ = pick_reference_subject([{"img": img.cpu().numpy()}], config, seed=SEED,
                                              device=dev)
    aug = augment.sample_affine_params(torch.Generator(device=dev).manual_seed(SEED), 1, 3,
                                       PRETRAIN_MAX_PARAMS, 1.0, device=dev)

    def pretrain_step(plain, perturb=False):
        net, state = state_of(perturb)
        step = make_pretrain_step(net, config, plain=plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, None, img, ref_points, 1.0, aug_params=aug)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, reading(net, m)

    # the same-resolution step: a smooth pair at the scans' own grid
    pair = _make_pairs(torch, rng, dev, REG_SHAPE, 1, noise_amp=0.0)[0]
    lmbda = torch.tensor([0.5], device=dev)
    idx = torch.tensor(rng.permutation(NUM_KEYPOINTS)[:TRAIN_KEYPOINTS].copy(), device=dev)

    def sameres_step(plain, perturb=False):
        net, state = state_of(perturb)
        step = make_train_step_sameres(net, config, plain=plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, None, *pair, None, None, 1.0, lmbda=lmbda, keypoint_idx=idx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, reading(net, m)

    total, held = None, {}
    for label, fn, needed in (
            ("pretrain step", pretrain_step,
             ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
              "warp_planes")),
            ("same-resolution step", sameres_step,
             ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
              "tps_flow", "warp_planes", "warp_planes_grad"))):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()
        ms, kern = fn(False)
        counts = kernels.counters()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _expect(f"phase 12 {label}", counts, needed)
        total = _add_counts(total, counts)
        ms2, _ = fn(False)
        plain_ms, plain = fn(True)
        _, perturbed = fn(True, perturb=True)
        print(f"phase12 {label}: {ms:.3f} ms (first), {ms2:.3f} ms (second), plain {plain_ms:.3f}"
              f" ms; peak device memory {peak:.3f} GiB; loss {kern[0]!r}, grad_norm {kern[1]!r}")
        held[f"phase12 {label}"] = _hold_readings(f"phase12 {label}", kern, plain, perturbed)

    # the same-resolution step's alignment alone at REG_SHAPE on the grid
    # path, on the keypoints of the plain extraction (phase 6's rule)
    with torch.no_grad():
        net, _ = state_of()
        points = net(*(resize_trilinear(v, RUN_SIZE) for v in pair), plain=True)[:2]
        del net
    step_of = {"pair": pair, "config": config, "lmbda": lmbda}
    held["phase12 same-resolution step"] &= _hold_align(
        torch, "phase12 same-resolution step", step_of, tuple(p[:, idx] for p in points),
        grid=True)

    # the resize (REG_SHAPE -> RUN_SIZE) against float64 of the same weights
    vol = pair[0]
    got = resize_trilinear(vol, RUN_SIZE)
    ref = vol.double()
    for axis, (n_in, n_out) in enumerate(zip(REG_SHAPE, RUN_SIZE)):
        w = resize_weights(n_in, n_out, device=dev, dtype=torch.float64)
        ref = torch.tensordot(ref.movedim(axis + 2, -1), w, dims=1).movedim(-1, axis + 2)
    d = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    rs_ms = _cuda_ms(lambda: resize_trilinear(vol, RUN_SIZE), 20)
    print(f"phase12 resize {REG_SHAPE} -> {RUN_SIZE}: {rs_ms:.4f} ms; vs float64 {d!r} "
          f"(tol {RESIZE_REL})")
    if d > RESIZE_REL:
        raise AssertionError("phase 12: the resize disagrees with float64")
    return total, held


def _phase12_backbones(torch, rng, dev, subject):
    """(d): the bf16 'cr' U-Net's heatmaps through the kernels against its
    plain route (phase 3's yardstick rule); one 128^3 training step each for
    the fp32 ConvNet (the CLI's default), the fp32 ResidualUNetSE3D (its
    module), the bf16 ResidualUNetSE3D (on the kernels, forward and backward)
    and the linear keypoint head on the flagship net, timed on CUDA events
    after a first step. Returns the kernel routes' launch counts."""
    import dataclasses

    from keymorph_tpu_torch.data import Preprocessor
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.layers import center_of_mass
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.training.config import build_backbone
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer, make_train_step

    img = torch.tensor(Preprocessor(size=RUN_SIZE).load(subject)["img"][None], device=dev)
    net = KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, layer_order="cr",
                                                   **UNET),
                                   torch.Generator().manual_seed(SEED + 13)),
                      NUM_KEYPOINTS).to(dev)
    with torch.no_grad():
        kernels.reset_counters()
        k_feat = net.features(img)
        counts = kernels.counters()
        _expect("phase 12 'cr' U-Net", counts, ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv"))
        p_feat = net.features(img, plain=True)
        n_feat = net.features(img * (1 + PERTURB), plain=True)
        k_ms = _cuda_ms(lambda: net.features(img), 3)
        p_ms = _cuda_ms(lambda: net.features(img, plain=True), 1)
    top = p_feat.float().abs().max().item()
    d = (k_feat.float() - p_feat.float()).abs().max().item() / top
    y = (n_feat.float() - p_feat.float()).abs().max().item() / top
    d_kp = (center_of_mass(k_feat) - center_of_mass(p_feat)).abs().max().item()
    y_kp = (center_of_mass(n_feat) - center_of_mass(p_feat)).abs().max().item()
    tol, tol_kp = max(HEATMAP_REL, NOISE_FACTOR * y), max(KEYPOINT_ABS, NOISE_FACTOR * y_kp)
    print(f"phase12 'cr' U-Net at {RUN_SIZE}: heatmaps {k_ms:.3f} ms through the kernels, "
          f"{p_ms:.3f} ms plain; kernels vs plain {d!r} x max (yardstick {y!r}, tol {tol!r}); "
          f"keypoints {d_kp!r} (yardstick {y_kp!r}, tol {tol_kp!r})")
    if d > tol or d_kp > tol_kp:
        raise AssertionError("phase 12: the 'cr' U-Net's heatmaps through the kernels disagree "
                             "with its plain route")
    del net, k_feat, p_feat, n_feat
    total = counts

    pair = _make_pairs(torch, rng, dev, RUN_SIZE, 1, noise_amp=0.0)[0]
    for label, over in OTHER_BACKBONES:
        config = dataclasses.replace(_train_config(RUN_SIZE), **over)
        net = KeyMorphNet(build_backbone(config), NUM_KEYPOINTS,
                          keypoint_layer=config.kp_layer).to(dev)
        init_weights(net, torch.Generator().manual_seed(SEED + 14))
        state = TrainState.create(net, make_optimizer(config, net))
        step = make_train_step(net, config)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()
        t0 = time.perf_counter()
        state, m1 = step(state, None, *pair, None, None, 1.0)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m2 = step(state, None, *pair, None, None, 1.0)
        end.record()
        torch.cuda.synchronize()
        counts = kernels.counters()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(m[k]) for m in (m1, m2) for k in ("loss", "grad_norm")]
        grads_ok = all(bool(torch.isfinite(p.grad).all()) for p in net.parameters()
                       if p.grad is not None)
        print(f"phase12 {label} ({'bf16' if config.use_amp else 'fp32'} {config.backbone}, "
              f"{config.kp_layer} head) {RUN_SIZE[0]}^3 step: {start.elapsed_time(end):.3f} ms on CUDA "
              f"events "
              f"(first {first_ms:.3f} ms on the host clock), peak device memory {peak:.3f} GiB; "
              f"loss, grad_norm {losses}; launches "
              f"{json.dumps({k: c['launches'] for k, c in counts.items()})}")
        if not (all(np.isfinite(losses)) and grads_ok):
            raise AssertionError(f"phase 12 {label}: a loss or gradient is not finite")
        residual = config.use_amp and config.backbone.startswith("residual")
        _expect(f"phase 12 {label}", counts,
                ("tps_planes", "tps_planes_bwd", "warp_planes", "warp_planes_grad")
                + (("conv3x3_fused_flat", "conv3x3_input_grad") if config.use_amp else ())
                + (RESIDUAL_TRAIN_KERNELS if residual else ()))
        total = _add_counts(total, counts)
        del net, state, step
        torch.cuda.empty_cache()
    return total


def phase12(torch, rng, dev):
    """The main CLI, pretraining, the same-resolution step and the other
    backbones (module docstring, phase 12). Returns the summed launch counts
    of every kernel route it drove."""
    import shutil
    import tempfile

    from keymorph_tpu_torch.data import Preprocessor

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase12_", dir=ROOT / "build"))
    try:
        stages = {}
        t0 = time.perf_counter()
        cli_counts, paths = _phase12_cli(torch, rng, dev, tmp)
        stages["cli (a, c)"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        img = torch.tensor(Preprocessor(size=RUN_SIZE).load(paths[0])["img"][None], device=dev)
        step_counts, held = _phase12_steps(torch, rng, dev, img)
        if not all(held.values()):
            raise AssertionError(f"phase 12: kernel and plain steps disagree: "
                                 f"{[k for k, ok in held.items() if not ok]}")
        stages["steps (b)"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        bb_counts = _phase12_backbones(torch, rng, dev, paths[0])
        stages["backbones (d)"] = time.perf_counter() - t0
        print("phase12 stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        return _add_counts(_add_counts(cli_counts, step_counts), bb_counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 13: 2D registration, LC2 and ImageLC2, brain extraction, and the
# decoder's parts form on the flagship net at an IXI scan's native grid
TWO_D_SHAPE = (256, 256)          # the in-plane size of the flagship volumes
TWO_D_BATCH = 8
TWO_D_TYPES = ["rigid", "affine", "tps_1"]
TWO_D_LABELS = 4                  # labels 0-3 of each slice's label map
TWO_D_AUG = (0.1, 0.1, 0.3, 0.05)  # tests/test_2d_pipeline.py's training step
TWO_D_STEPS = ("affine", "tps_loguniform")
TWO_D_MORE_STEPS = 3
# the card against the CPU, both fp32 (cuDNN with TF32 off and the CPU's
# convs sum in other orders): each output within the larger of its floor and
# CARD_CPU_FACTOR x the CPU route's distance from the same call in float64
# (the backbone and the keypoint head in float64; the fit, the grid and the
# warp are fp32 in the port, as in keymorph_tpu, and take the float64
# keypoints). The factor is not phase 3's 2: the card's fp32 convs lie
# further from float64 than the CPU's (the 2D U-Net's heatmaps at 256^2,
# batch 16: cuDNN 6.0e-6, PyTorch's convs without cuDNN 4.1e-6, the CPU
# 2.6e-6 x max; tools/conv_precision_2d.py on NVIDIA H100 80GB HBM3,
# 700.00 W), so card vs CPU reads up to (1 + 2.3) x the CPU's own distance
# where both errors add.
CARD_CPU_FACTOR = 4.0
TWO_D_LMBDA = 0.5                  # the first TPS step's injected lambda, as phase 5's
TWO_D_KEYPOINT_ABS = 1e-5          # normalized units
TWO_D_GRID_ABS = 1e-5
TWO_D_WARP_ABS = 1e-5              # images in [0, 1.2]
TWO_D_LABEL_SHARE = 1e-3           # share of warped labels that may differ
TWO_D_STAGE_ABS = 1e-5             # a stage on the card's own inputs: fit + grid
TWO_D_LOSS_REL = 1e-5
TWO_D_GRAD_NORM_REL = 1e-4
LOGIT_REL = 1e-5                   # x max |logit|, the brain extractor
LC2_ABS = 1e-5                     # scores in [0, 1], against float64
LC2_CUBES = (4, 51)                # LC2() on 4 odd cubes of 51^3
IMAGE_LC2_SIZE = 255               # ImageLC2(51, (5,)) on one 255^3 pair: 125 patches


def _slices(torch, rng, dev):
    """TWO_D_BATCH (fixed, moving) image pairs (B, 1, *TWO_D_SHAPE) in [0, ~1.2]:
    Gaussian blobs plus 0.2 x white noise, the moving blobs displaced by a
    few pixels, and the moving image's label map (label k where blob k
    dominates above 0.3, else 0)."""
    shape = TWO_D_SHAPE
    axes = [torch.linspace(-1, 1, s, device=dev) for s in shape]
    out = {"f": [], "m": [], "seg_m": []}
    for _ in range(TWO_D_BATCH):
        nb = TWO_D_LABELS - 1
        c = rng.uniform(-0.6, 0.6, (nb, 2))
        width = rng.uniform(0.03, 0.12, nb)
        amp = rng.uniform(0.3, 1.0, nb)
        shift = rng.normal(0, 0.03, (nb, 2))
        for key, cs in (("f", c), ("m", c + shift)):
            img = torch.zeros(shape, device=dev)
            best = torch.zeros(shape, device=dev)
            seg = torch.zeros(shape, device=dev)
            for k, ((cy, cx), wd, a) in enumerate(zip(cs, width, amp)):
                g = (torch.exp(-(axes[0] - cy) ** 2 / wd)[:, None]
                     * torch.exp(-(axes[1] - cx) ** 2 / wd)[None, :])
                img += a * g
                seg[(g > best) & (g > 0.3)] = k + 1
                best = torch.maximum(best, g)
            noise = torch.tensor(rng.random(shape, dtype=np.float32), device=dev)
            out[key].append((img.clamp(max=1.0) + 0.2 * noise)[None])
            if key == "m":
                out["seg_m"].append(seg[None])
    return {k: torch.stack(v) for k, v in out.items()}


def _com64(torch, heat):
    """The center-of-mass head in float64 (the port's sums in fp32)."""
    spatial = heat.shape[1:-1]
    v = torch.relu(heat.double())
    coords = []
    for k in range(len(spatial)):
        axes = tuple(i + 1 for i in range(len(spatial)) if i != k)
        m = v.sum(dim=axes)
        line = torch.linspace(0.0, 1.0, spatial[k], dtype=torch.float64, device=heat.device)
        coords.append((m * line[None, :, None]).sum(dim=1) / (m.sum(dim=1) + 1e-8))
    return torch.stack(coords, dim=-1) * 2.0 - 1.0


def _dist(a, b):
    return (a.double().cpu() - b.double().cpu()).abs().max().item()


def _phase13_serve(torch, rng, dev, config, data):
    """(a): KeyMorph.forward at dim 2 on the card and on the CPU; every grid
    warped bilinear (images) and nearest (label maps)."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops.resample import align_img
    from keymorph_tpu_torch.training.config import build_backbone, build_model

    models = {"card": build_model(config, device=dev), "cpu": build_model(config, device="cpu")}
    for m in models.values():
        m.eval()
    f, m_img, seg = data["f"], data["m"], data["seg_m"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, walls = {}, {}
    for where, model in models.items():
        d = dev if where == "card" else torch.device("cpu")
        t0 = time.perf_counter()
        res = model(f.to(d), m_img.to(d), transform_type=TWO_D_TYPES, return_aligned_points=True)
        warps = {t: (align_img(r["grid"], m_img.to(d)), align_img(r["grid"], seg.to(d), "nearest"))
                 for t, r in res.items()}
        if where == "card":
            torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0
        out[where] = res, warps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card, card_w = out["card"]

    # times on CUDA events: the pair's extraction, each type's fit + grid, each warp
    net = models["card"].net
    with torch.no_grad():
        ext_ms = _cuda_ms(lambda: net(f, m_img), 3)
        pf, pm = card[TWO_D_TYPES[0]]["points_f"], card[TWO_D_TYPES[0]]["points_m"]
        align_ms, warp_ms = {}, {}
        for t in TWO_D_TYPES:
            align_type = t.split("_")[0]
            lm = torch.ones((TWO_D_BATCH,), device=dev) if align_type == "tps" else None
            align_ms[t] = _cuda_ms(lambda: align_pair(pf, pm, align_type, TWO_D_SHAPE, lmbda=lm,
                                                      num_chunks=4), 5)
            warp_ms[t] = _cuda_ms(lambda: align_img(card[t]["grid"], m_img), 10)
    print(f"phase13 (a) 2D serving, UNet2D f_maps 64 x 4 levels fp32, {TWO_D_BATCH} pairs at "
          f"{TWO_D_SHAPE}, {config.num_keypoints} keypoints, {TWO_D_TYPES}: extract {ext_ms:.3f} "
          f"ms; align (fit + grid) {json.dumps({k: round(v, 4) for k, v in align_ms.items()})} "
          f"ms; warp {json.dumps({k: round(v, 4) for k, v in warp_ms.items()})} ms (CUDA events); "
          f"forward + warps {walls['card'] * 1e3:.3f} ms on the card, {walls['cpu'] * 1e3:.3f} ms "
          f"on the CPU (host clock); peak device memory {peak:.3f} GiB")

    # the float64 call: the backbone and the head in float64, then the fp32
    # fit, grid and warps on the CPU from its keypoints
    net64 = models["cpu"].net
    bb64 = build_backbone(config, dtype=torch.float64).to(dev)
    bb64.load_state_dict(net64.backbone.state_dict())
    with torch.no_grad():
        kp64 = [_com64(torch, bb64(v.double()).movedim(1, -1)).float().cpu() for v in (f, m_img)]
    del bb64
    cpu, cpu_w = out["cpu"]
    ok = True
    for t in TWO_D_TYPES:
        align_type, lm = t.split("_")[0], cpu[t]["tps_lmbda"]
        with torch.no_grad():
            y = align_pair(*kp64, align_type, TWO_D_SHAPE, lmbda=lm, num_chunks=4,
                           compute_aligned_points=True)
            y_img = align_img(y["grid"], m_img.cpu())
            y_seg = align_img(y["grid"], seg.cpu(), "nearest")
            # each stage on the card's own inputs: the fit and grid from the
            # card's keypoints, the warps of the card's grid
            st = align_pair(card[t]["points_f"].cpu(), card[t]["points_m"].cpu(), align_type,
                            TWO_D_SHAPE, lmbda=None if lm is None else lm.cpu(), num_chunks=4)
            st_img = align_img(card[t]["grid"].cpu(), m_img.cpu())
            st_seg = align_img(card[t]["grid"].cpu(), seg.cpu(), "nearest")
        rows = []
        for name, got, ref, yard_of, floor in (
                ("keypoints", (card[t]["points_f"], card[t]["points_m"]),
                 (cpu[t]["points_f"], cpu[t]["points_m"]), kp64, TWO_D_KEYPOINT_ABS),
                ("grid", (card[t]["grid"],), (cpu[t]["grid"],), (y["grid"],), TWO_D_GRID_ABS),
                ("aligned points", (card[t]["points_a"],), (cpu[t]["points_a"],),
                 (y["points_a"],), TWO_D_GRID_ABS),
                ("warped image", (card_w[t][0],), (cpu_w[t][0],), (y_img,), TWO_D_WARP_ABS)):
            d = max(_dist(a, b) for a, b in zip(got, ref))
            yard = max(_dist(b, c) for b, c in zip(ref, yard_of))
            own = max(_dist(a, c) for a, c in zip(got, yard_of))
            tol = max(floor, CARD_CPU_FACTOR * yard)
            rows.append(f"{name} {d!r} (yardstick {yard!r}, tol {tol!r}; the card from the "
                        f"float64 call {own!r})")
            ok &= d <= tol
        share = (card_w[t][1].cpu() != cpu_w[t][1]).float().mean().item()
        y_share = (y_seg != cpu_w[t][1]).float().mean().item()
        tol_share = max(TWO_D_LABEL_SHARE, CARD_CPU_FACTOR * y_share)
        d_st = _dist(st["grid"], card[t]["grid"])
        d_img, d_seg = _dist(st_img, card_w[t][0]), _dist(st_seg, card_w[t][1])
        print(f"phase13 (a) {t}, card vs CPU: " + "; ".join(rows)
              + f"; warped labels differ at {share!r} of pixels (yardstick {y_share!r}, tol "
              f"{tol_share!r}); on the card's own inputs: fit + grid {d_st!r} (tol "
              f"{TWO_D_STAGE_ABS}), warp {d_img!r} (tol {TWO_D_WARP_ABS}), labels {d_seg!r} (tol 0)")
        ok &= (share <= tol_share and d_st <= TWO_D_STAGE_ABS and d_img <= TWO_D_WARP_ABS
               and d_seg == 0.0)
        for v in list(card[t].values()) + list(card_w[t]):
            if torch.is_tensor(v) and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"phase 13 (a) {t}: an output is not finite")
        if card[t]["grid"].shape != (TWO_D_BATCH, *TWO_D_SHAPE, 2):
            raise AssertionError(f"phase 13 (a) {t}: grid {tuple(card[t]['grid'].shape)}")
    if not ok:
        raise AssertionError("phase 13 (a): the card's 2D registration disagrees with the CPU's")


def _phase13_train(torch, rng, dev, config, data):
    """(b): the 2D training step (MSE, 64 of 128 keypoints, augmentation) as
    affine and as tps_loguniform: a first step with injected draws (the
    augmentation parameters and the keypoint subset drawn once, lambda
    TWO_D_LMBDA as phase 5 injects it), then TWO_D_MORE_STEPS with every
    draw from the generator; the first step's loss and grad_norm against the
    CPU's."""
    import dataclasses

    from keymorph_tpu_torch import augment
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import build_backbone
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer, make_train_step

    f, m_img = data["f"], data["m"]
    ok = True
    for tt in TWO_D_STEPS:
        cfg = dataclasses.replace(config, transform_type=tt)
        init = init_weights(build_backbone(cfg), torch.Generator().manual_seed(SEED + 131))
        init = {f"backbone.{k}": v for k, v in init.state_dict().items()}
        g = torch.Generator(device=dev).manual_seed(SEED + 132)
        aug = augment.sample_affine_params(g, TWO_D_BATCH, 2, TWO_D_AUG, 1.0, device=dev)
        lmbda = idx = None
        if tt.startswith("tps"):
            lmbda = torch.full((TWO_D_BATCH,), TWO_D_LMBDA, device=dev)
            idx = torch.randperm(cfg.num_keypoints, generator=g,
                                 device=dev)[:cfg.max_train_keypoints]

        def first_step(d, dtype=torch.float32, keep=False):
            net = KeyMorphNet(build_backbone(cfg, dtype=dtype), cfg.num_keypoints, dim=2).to(d)
            net.load_state_dict(init)
            state = TrainState.create(net, make_optimizer(cfg, net))
            step = make_train_step(net, cfg)
            mv = (lambda v: None if v is None else v.to(d))
            t0 = time.perf_counter()
            state, m = step(state, None, f.to(d, dtype), m_img.to(d, dtype), None, None, 1.0,
                            lmbda=mv(lmbda), keypoint_idx=mv(idx), aug_params=[mv(p) for p in aug])
            if d == dev:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return (net, state, step, m, wall) if keep else (float(m["loss"]),
                                                             float(m["grad_norm"]), wall)

        torch.cuda.reset_peak_memory_stats()
        before = {k: v.to(dev) for k, v in init.items()}
        net, state, step, m1, first_s = first_step(dev, keep=True)
        changed = [k for k, p in net.named_parameters()
                   if p.grad is not None and not torch.equal(p.detach(), before[k])]
        with_grad = [k for k, p in net.named_parameters() if p.grad is not None]
        finite = (np.isfinite(float(m1["loss"])) and np.isfinite(float(m1["grad_norm"]))
                  and all(bool(torch.isfinite(p.grad).all()) for p in net.parameters()
                          if p.grad is not None))
        gen = torch.Generator(device=dev).manual_seed(SEED + 133)
        times, losses = [], [float(m1["loss"])]
        for _ in range(TWO_D_MORE_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, gen, f, m_img, None, None, 1.0)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            finite &= np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kern = (float(m1["loss"]), float(m1["grad_norm"]))
        del net, state, step
        torch.cuda.empty_cache()
        cpu_loss, cpu_gn, cpu_s = first_step(torch.device("cpu"))
        y_loss, y_gn, _ = first_step(dev, torch.float64)
        rows = []
        for name, k, c, y, floor in (("loss", kern[0], cpu_loss, y_loss, TWO_D_LOSS_REL),
                                     ("grad_norm", kern[1], cpu_gn, y_gn, TWO_D_GRAD_NORM_REL)):
            d, yard = abs(k - c) / abs(c), abs(c - y) / abs(y)
            tol = max(floor, CARD_CPU_FACTOR * yard)
            rows.append(f"{name} {k!r} vs {c!r}: {d!r} (yardstick {yard!r}, tol {tol!r}; the "
                        f"card from the float64 call {abs(k - y) / abs(y)!r})")
            ok &= d <= tol
        print(f"phase13 (b) 2D step {tt} (batch {TWO_D_BATCH} at {TWO_D_SHAPE}, MSE, "
              f"{cfg.max_train_keypoints} of {cfg.num_keypoints} keypoints, augmentation "
              f"{TWO_D_AUG}): first {first_s * 1e3:.3f} ms (host clock), then "
              f"{', '.join(f'{t:.3f}' for t in times)} ms (CUDA events); peak device memory "
              f"{peak:.3f} GiB; losses {losses}; CPU first step {cpu_s:.3f} s; "
              + "; ".join(rows))
        if not finite:
            raise AssertionError(f"phase 13 (b) {tt}: a loss or gradient is not finite")
        if set(changed) != set(with_grad) or not with_grad:
            raise AssertionError(f"phase 13 (b) {tt}: parameters with a gradient unchanged: "
                                 f"{sorted(set(with_grad) - set(changed))}")
    if not ok:
        raise AssertionError("phase 13 (b): the card's 2D step disagrees with the CPU's")


def _clean_rule(mask, threshold=0.2):
    """keymorph_tpu's brain-mask cleanup, restated: label the face-connected
    components of ``mask``, keep each whose size over the largest one's
    exceeds ``threshold``."""
    import scipy.ndimage

    labeled, num = scipy.ndimage.label(mask > 0)
    if num == 0:
        return np.zeros(mask.shape, np.uint8)
    sizes = np.bincount(labeled.ravel(), minlength=num + 1)[1:]
    keep = np.flatnonzero(sizes / sizes.max() > threshold) + 1
    return np.isin(labeled, keep).astype(np.uint8)


def _phase13_brain(torch, dev, scan):
    """(c): extract_brain with seeded SimpleUnet weights on an IXI-like scan
    preprocessed to 256^3 (a trilinear resize on the card, ``ops/resize.py``,
    then min-max scaling, as ``tools/extract_brains.py`` scales)."""
    from keymorph_tpu_torch import brain_extract
    from keymorph_tpu_torch.models.unet import SimpleUnet, init_weights
    from keymorph_tpu_torch.ops.resize import resize_trilinear

    t0 = time.perf_counter()
    data = resize_trilinear(torch.tensor(scan[None, None], device=dev), SPATIAL)
    x = ((data - data.min()) / (data.max() - data.min()).clamp(min=1e-6)).cpu()
    prep_s = time.perf_counter() - t0
    model = init_weights(SimpleUnet(), torch.Generator().manual_seed(SEED + 134))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    masks = brain_extract.extract_brain(model, x, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    xd = x.to(dev)
    logit_ms = _cuda_ms(lambda: brain_extract.brain_logits(model, xd, device=dev), 3)
    card_d = brain_extract.brain_logits(model, xd, device=dev)[:, 0]
    # thresholded as extract_brain does it: the sigmoid on the card (its
    # rounding of a logit within ~1e-7 of 0 may differ from the CPU's)
    raw = (torch.sigmoid(card_d) > 0.5).cpu().numpy()
    card = card_d.cpu()
    t0 = time.perf_counter()
    cpu = brain_extract.brain_logits(model, x, device="cpu")[:, 0]
    cpu_s = time.perf_counter() - t0
    m64 = SimpleUnet(dtype=torch.float64)
    m64.load_state_dict(model.state_dict())
    ref = brain_extract.brain_logits(m64, xd, device=dev)[:, 0].cpu()
    del m64
    top = ref.abs().max().item()
    d, yard = _dist(card, cpu) / top, _dist(cpu, ref) / top
    tol = max(LOGIT_REL, CARD_CPU_FACTOR * yard)
    p_card, p_cpu = torch.sigmoid(card), torch.sigmoid(cpu)
    bar = 0.25 * tol * top  # the sigmoid's slope is at most 1/4
    near = (p_cpu - 0.5).abs() <= bar
    flips = ((p_card > 0.5) != (p_cpu > 0.5))
    rule = np.stack([_clean_rule(r) for r in raw])[:, None]
    port = np.stack([brain_extract.clean_mask(r) for r in raw])[:, None]
    print(f"phase13 (c) brain extraction, SimpleUnet (4, 8, 16, 32 / 32, 16, 8, 4) fp32 on an "
          f"IXI-like {REG_SHAPE} scan resized to {SPATIAL}: extract_brain {wall:.3f} s (host "
          f"clock, the cleanup on the host included), logits {logit_ms:.3f} ms (CUDA events), "
          f"preprocessing {prep_s:.3f} s, CPU logits {cpu_s:.3f} s; peak device memory "
          f"{peak:.3f} GiB; logits card vs CPU {d!r} x max (yardstick {yard!r}, tol {tol!r}; "
          f"the card from float64 {_dist(card, ref) / top!r}); "
          f"mask voxels {int(masks.sum())}, raw {int(raw.sum())}; threshold flips "
          f"{int(flips.sum())}, all within {bar!r} of 0.5: {bool((~flips | near).all())}; "
          f"clean_mask vs keymorph_tpu's rule on the card's raw mask: "
          f"{bool(np.array_equal(port, rule))}; extract_brain's masks vs them: "
          f"{int((masks != rule).sum())} voxels differ")
    if not (d <= tol and bool((~flips | near).all()) and np.array_equal(port, rule)
            and np.array_equal(masks, rule)):
        raise AssertionError("phase 13 (c): the brain extraction disagrees with the CPU route "
                             "or keymorph_tpu's cleanup rule")


def _phase13_lc2(torch, rng, dev):
    """(d): LC2() on LC2_CUBES odd cubes and ImageLC2(51, (5,)) on one
    IMAGE_LC2_SIZE^3 pair, each against float64 on the CPU."""
    from keymorph_tpu_torch import metrics as M

    def pair(shape):
        mr = torch.tensor(rng.normal(size=shape).astype(np.float32), device=dev)
        us = torch.tanh(2 * mr) + 0.3 * torch.tensor(rng.normal(size=shape).astype(np.float32),
                                                     device=dev)
        return us, mr

    n, s = LC2_CUBES
    rows, ok = [], True
    for label, fn, fn64, shape in (
            (f"LC2() on {n} x {s}^3", M.LC2(), M.LC2(dtype=torch.float64), (n, 1, s, s, s)),
            (f"ImageLC2(51, (5,)) on {IMAGE_LC2_SIZE}^3", M.ImageLC2(51, (5,)),
             M.ImageLC2(51, (5,), dtype=torch.float64), (1, 1) + (IMAGE_LC2_SIZE,) * 3)):
        us, mr = pair(shape)
        ms = _cuda_ms(lambda: fn(us, mr), 5)
        got = fn(us, mr)
        ref = fn64(us.cpu(), mr.cpu())
        d = _dist(got, ref)
        rows.append(f"{label}: {ms:.3f} ms (CUDA events), {got.cpu().numpy().round(6).tolist()} "
                    f"vs float64 {d!r} (tol {LC2_ABS})")
        ok &= d <= LC2_ABS and bool(torch.isfinite(got).all())
    print("phase13 (d) " + "; ".join(rows))
    if not ok:
        raise AssertionError("phase 13 (d): LC2 on the card disagrees with float64")


def _phase13_parts(torch, dev, scan):
    """(e): the flagship net's kernel executor on one IXI-like scan at its
    native REG_SHAPE: the skips at the 75 -> 37 and 37 -> 18 levels are not
    twice the deeper tensor, so both decoders run the concat-free parts
    form. Heatmaps and keypoints against the plain route under phase 3's
    yardstick. Returns the launch counts."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.layers import center_of_mass
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels

    net = KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **UNET),
                                   torch.Generator().manual_seed(SEED)), NUM_KEYPOINTS).to(dev)
    vol = torch.tensor(scan[None, None], device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        kernels.reset_counters()
        k_feat = net.features(vol)
        torch.cuda.synchronize()
        counts = kernels.counters()
        _expect("phase 13 (e)", counts, ("conv3x3_fused_flat", "conv3x3_fused_flat_parts"))
        p_feat = net.features(vol, plain=True)
        n_feat = net.features(vol * (1 + PERTURB), plain=True)
        k_ms = _cuda_ms(lambda: net.features(vol), 3)
    top = p_feat.float().abs().max().item()
    d = (k_feat.float() - p_feat.float()).abs().max().item() / top
    y = (n_feat.float() - p_feat.float()).abs().max().item() / top
    d_kp = (center_of_mass(k_feat) - center_of_mass(p_feat)).abs().max().item()
    y_kp = (center_of_mass(n_feat) - center_of_mass(p_feat)).abs().max().item()
    tol, tol_kp = max(HEATMAP_REL, NOISE_FACTOR * y), max(KEYPOINT_ABS, NOISE_FACTOR * y_kp)
    print(f"phase13 (e) flagship net at {REG_SHAPE}: heatmaps {tuple(k_feat.shape)} in "
          f"{k_ms:.3f} ms (CUDA events); launches "
          f"{json.dumps({k: c['launches'] for k, c in counts.items() if c['launches']})}; "
          f"kernels vs plain {d!r} x max (yardstick {y!r}, tol {tol!r}); keypoints {d_kp!r} "
          f"(yardstick {y_kp!r}, tol {tol_kp!r})")
    if d > tol or d_kp > tol_kp:
        raise AssertionError("phase 13 (e): the parts form's heatmaps disagree with the plain "
                             "route")
    return counts


def phase13(torch, dev):
    """2D registration, LC2, brain extraction and the parts form (module
    docstring, phase 13). Returns the launch counts of (e), the one path of
    the phase with kernels."""
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.training.config import Config

    rng = np.random.default_rng([SEED, 13])
    stages = {}
    config = Config(dim=2, backbone="unet", num_keypoints=NUM_KEYPOINTS, loss_fn="mse",
                    max_train_keypoints=TRAIN_KEYPOINTS, max_random_affine_augment_params=TWO_D_AUG,
                    seed=SEED)
    t0 = time.perf_counter()
    data = _slices(torch, rng, dev)
    (scan, _), _ = _phantom(torch, rng, dev)
    stages["inputs"] = time.perf_counter() - t0
    kernels.reset_counters()
    for label, fn in (("(a) serve", lambda: _phase13_serve(torch, rng, dev, config, data)),
                      ("(b) train", lambda: _phase13_train(torch, rng, dev, config, data)),
                      ("(c) brain", lambda: _phase13_brain(torch, dev, scan)),
                      ("(d) lc2", lambda: _phase13_lc2(torch, rng, dev))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        stages[label] = time.perf_counter() - t0
    counts = kernels.counters()
    head = counts.pop("heatmap_com")  # 2D keypoints served on the card take the head kernel
    if head["plain_calls"] or any(c["launches"] or c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"phase 13 (a)-(d) moved a kernel or plain-version counter but "
                             f"the head's: {counts}, head {head}")
    t0 = time.perf_counter()
    parts_counts = _phase13_parts(torch, dev, scan)
    stages["(e) parts"] = time.perf_counter() - t0
    print("phase13 stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; (a)-(d) moved no kernel and no plain-version counter but the head's "
          f"({head['launches']} launches)")
    return parts_counts


# ---------------------------------------------------------------------------
# phase 14: the parallel layer (keymorph_tpu_torch/parallel/) on
# torch.distributed: (a) a world of 1 on NCCL in this process, (b) a world of
# 2 on cuda:0 over gloo (NCCL refuses two ranks on one card), each rank a
# process of this script (``--phase14-rank``)
# ---------------------------------------------------------------------------

P14_TIMEOUT = 60          # s, every process group's
P14_DEADLINE = 420        # s, the 2-rank world's join: start, paths, rank 0's references
P14_TRAIN_BATCH = 2       # 128^3 rows of the 2-rank step, a row a rank
P14_PAIRS = 4             # 256^3 pairs of the fan-out register, two a rank
P14_GROUP = 4             # 128^3 subjects of groupwise_register(mesh=...)
P14_TYPES = ("affine", "tps_1")
# the spatial path on the other backbones, heads and extents, each one pair on
# 'space' 2: name -> (build_backbone family, bf16, (D, H, W), weight_keypoints)
P14_SPATIAL = {
    "convnet": ("conv", False, SPATIAL, None),                 # fp32, instance norm
    "residualunetse": ("residualunetse", False, TRAIN_SPATIAL, None),  # fp32, 5 levels
    "variance": ("truncatedunet", True, SPATIAL, "variance"),  # the flagship, weighted
    "d150": ("truncatedunet", True, (150, 256, 256), None),    # an IXI scan's 150 slices
}
# the kernels each path must launch, on every rank (the spatial path's
# extraction is the U-Net's module path: no conv kernel)
P14_PATHS = {
    "train": TRAIN_PATH_KERNELS,
    "register": ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_flow"),
    "groupwise": ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_flow"),
    "spatial": ("tps_flow", "warp_planes"),
    **{f"spatial {name}": ("tps_flow", "warp_planes") for name in P14_SPATIAL},
}


def _p14_net(torch, dev):
    """The flagship net with phase 14's seeded weights (the same in every
    process: the generator is the CPU's)."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights

    gen = torch.Generator().manual_seed(SEED + 14)
    return KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **UNET), gen),
                       NUM_KEYPOINTS).to(dev)


def _p14_spatial_net(torch, dev, name):
    """P14_SPATIAL's net ``name`` with seeded weights (the same in every
    process): the family as ``build_backbone`` makes it (the flagship's
    widths for the TruncatedUNet3D), the variance weighting's scales and
    biases drawn as a trained net's are not 1 and 0."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import Config, build_backbone

    family, amp, _, weighting = P14_SPATIAL[name]
    gen = torch.Generator().manual_seed(SEED + 140 + list(P14_SPATIAL).index(name))
    backbone = build_backbone(Config(num_keypoints=NUM_KEYPOINTS, backbone=family,
                                     norm_type="instance", use_amp=amp))
    net = KeyMorphNet(init_weights(backbone, gen), NUM_KEYPOINTS, weighting)
    if weighting == "variance":
        with torch.no_grad():
            net.scales.copy_(torch.rand(NUM_KEYPOINTS, generator=gen) + 0.5)
            net.biases.copy_(torch.rand(NUM_KEYPOINTS, generator=gen) * 0.1)
    return net.to(dev).eval()


def _p14_spatial_unsplit(torch, net, f, m, scale):
    """The unsplit module path of one pair, volumes scaled by ``scale``:
    (keypoints, the weighted ``tps_1`` grid, the warped moving volume)."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops.resample import align_img

    feats = [net.backbone(v * scale).movedim(1, -1) for v in (f, m)]
    kp = [net.keypoints_from_features(x) for x in feats]
    weights = (net.weight_by_variance(*feats) if net.weight_keypoints == "variance"
               else None)
    grid = align_pair(*kp, "tps", f.shape[2:], lmbda=LMBDA, weights=weights)["grid"]
    return kp, grid, align_img(grid, m)


def _p14_inputs(torch, dev):
    """Phase 14's inputs, the same in every process (seeded numpy): the
    step's batch at 128^3 (smooth, as phase 5's) with its injected lambdas
    and keypoint subset, the register's pairs and the spatial pair at 256^3,
    the group at 128^3."""
    rng = np.random.default_rng([SEED, 14])

    def batch(spatial, n, noise):
        return tuple(torch.cat(v) for v in zip(*_make_pairs(torch, rng, dev, spatial, n, noise)))

    return {"train": batch(TRAIN_SPATIAL, P14_TRAIN_BATCH, 0.0),
            "register": batch(SPATIAL, P14_PAIRS, 0.2),
            "group": batch(TRAIN_SPATIAL, P14_GROUP, 0.2)[0],
            "spatial": batch(SPATIAL, 1, 0.2),
            "lmbda": torch.tensor([0.5, 2.0], device=dev)[:P14_TRAIN_BATCH],
            "idx": torch.tensor(rng.permutation(NUM_KEYPOINTS)[:TRAIN_KEYPOINTS].copy(),
                                device=dev)}


def _timed(torch, out, label, fn):
    """``fn()`` on the host clock up to a synchronize, its launches counted
    from 0 just before and read just after (``out["ms"]``, ``out["counts"]``)."""
    from keymorph_tpu_torch.ops import cuda as kernels

    torch.cuda.synchronize()
    kernels.reset_counters()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    out["ms"][label] = (time.perf_counter() - t0) * 1e3
    out["counts"][label] = kernels.counters()
    return res


def _p14_step_readings(torch, dev, config, inputs, rows, mesh=None, scale=1.0):
    """One canonical step (phase 14's weights, the injected lambdas and
    subset) on ``rows`` of the step's batch scaled by ``scale``: sharded over
    ``mesh``, or the unsharded kernel step. Returns (readings (loss,
    grad_norm, gradients), the net, the step, the state)."""
    from keymorph_tpu_torch.parallel import make_sharded_train_step
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer, make_train_step

    net = _p14_net(torch, dev)
    state = TrainState.create(net, make_optimizer(config, net))
    step = (make_train_step(net, config) if mesh is None
            else make_sharded_train_step(net, config, mesh))
    img_f, img_m = (v[rows] * scale for v in inputs["train"])
    state, m = step(state, None, img_f, img_m, None, None, 1.0, lmbda=inputs["lmbda"][rows],
                    keypoint_idx=inputs["idx"])
    return (float(m["loss"]), float(m["grad_norm"]), _grads(net)), net, step, state


def _p14_hold_step(torch, dev, config, inputs, rows, got, label):
    """A sharded step's readings under phase 6's rule against the unsharded
    kernel step on the same rows, its yardstick the unsharded step on the
    rows moved by PERTURB."""
    plain = _p14_step_readings(torch, dev, config, inputs, rows)[0]
    noisy = _p14_step_readings(torch, dev, config, inputs, rows, scale=1.0 + PERTURB)[0]
    return _hold_readings(label, got, plain, noisy)


def _p14_register_single(torch, net, img_f, img_m):
    """The single-process kernel path, pair by pair: keypoints, then the
    ``tps_1`` grid of ``align_pair(compute_grid=True)``."""
    from keymorph_tpu_torch.models.keymorph import align_pair

    outs = []
    with torch.no_grad():
        for i in range(img_f.shape[0]):
            pf, pm, _ = net(img_f[i: i + 1], img_m[i: i + 1])
            grid = align_pair(pf, pm, "tps", img_f.shape[2:], lmbda=LMBDA)["grid"]
            outs.append((pf, pm, grid))
    return tuple(torch.cat(v) for v in zip(*outs))


def _p14_dist(a, b):
    return (a.float() - b.float()).abs().max().item()


def _p14_batch_stages(torch, net, img_f, img_m):
    """A batch of pairs through the single-process kernel path at once
    against pair by pair, stage by stage: each stage runs on the whole
    batch and on each row alone, on the same inputs (the rows' outputs of
    the stage before it), so a difference belongs to that stage. Returns
    {stage: largest |difference|}: the heatmaps (the conv kernels and the
    executor's glue), the keypoints (``center_of_mass``), the TPS fit
    (``fit_tps``'s theta, ``solve_ex``), the flow (``tps_flow`` at every
    voxel centre) and the warped moving image (``warp_planes``)."""
    from keymorph_tpu_torch.ops import coords
    from keymorph_tpu_torch.ops.cuda.tpsflow import tps_flow
    from keymorph_tpu_torch.ops.resample import align_img
    from keymorph_tpu_torch.transforms.solvers import fit_tps

    B = img_f.shape[0]
    d = {}

    def stage(name, fn, *inputs):
        whole = fn(*inputs)
        rows = torch.cat([fn(*(x[i: i + 1] for x in inputs)) for i in range(B)])
        d[name] = max(d.get(name, 0.0), _p14_dist(whole, rows))
        return rows

    with torch.no_grad():
        heat = [stage("heatmaps", net.features, v) for v in (img_f, img_m)]
        pf, pm = (stage("keypoints", net.keypoints_from_features, h) for h in heat)
        del heat
        lmbda = torch.full((B,), LMBDA, device=img_f.device)
        theta = stage("fit", fit_tps, pf, pm, lmbda)
        points = coords.flat_norm_grid(SPATIAL, device=img_f.device).expand(B, -1, 3).contiguous()
        flow = stage("flow", lambda t, c, x: tps_flow(t.contiguous(), c.contiguous(), x),
                     theta, pf, points)
        del points
        grid = torch.flip(flow.reshape(B, *SPATIAL, 3), dims=(-1,))
        del flow
        stage("warp", align_img, grid, img_m)
    return d


def _p14_worker(torch, rank, tmp):
    """One rank of phase 14 (b): the 2-rank step, the fan-out register, the
    mesh groupwise and the spatial pair, on cuda:0 over gloo; then rank 0
    alone computes every single-process reference and the distances.
    Writes ``result_<rank>.pt`` under ``tmp``."""
    import datetime

    import torch.distributed as dist

    from keymorph_tpu_torch import _build
    from keymorph_tpu_torch.models.keymorph import KeyMorph, align_pair
    from keymorph_tpu_torch.models.layers import center_of_mass
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D
    from keymorph_tpu_torch.ops.resample import align_img
    from keymorph_tpu_torch.parallel import (
        launch, make_mesh, make_sharded_register_fn, make_spatial_register_fn, sharded)
    from keymorph_tpu_torch.training.config import Config

    km = _import_port()
    km.disable_tf32()
    _build.library()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=P14_TIMEOUT)
    dist.init_process_group("gloo", init_method=launch.store_url(tmp), rank=rank,
                            world_size=2, timeout=timeout)
    inputs = _p14_inputs(torch, dev)
    out = {"ms": {}, "counts": {}}
    data = make_mesh(data=2, space=1, device_type="cuda", timeout=timeout)
    config = _train_config(TRAIN_SPATIAL)
    rows = slice(0, P14_TRAIN_BATCH)

    # the 2-rank step (the first, then a second), and its gradient all-reduce alone
    got, net, step, state = _timed(torch, out, "train", lambda: _p14_step_readings(
        torch, dev, config, inputs, rows, data))
    img_f, img_m = inputs["train"]
    _timed(torch, out, "train second", lambda: step(
        state, None, img_f, img_m, None, None, 1.0, lmbda=inputs["lmbda"],
        keypoint_idx=inputs["idx"]))
    for i in range(3):
        _timed(torch, out, f"grad all-reduce {i}", lambda: sharded._all_reduce_grads(net, data))
    out["grad_mb"] = sum(p.grad.numel() * 4 for p in net.parameters() if p.grad is not None) / 1e6
    del net, step, state

    # the fan-out register of the pairs
    reg_net = _p14_net(torch, dev).eval()
    fn = make_sharded_register_fn(reg_net, Config(num_keypoints=NUM_KEYPOINTS,
                                                  transform_type="tps_1"), data)
    reg = _timed(torch, out, "register", lambda: fn(*inputs["register"]))
    _timed(torch, out, "register second", lambda: fn(*inputs["register"]))

    # groupwise with the subjects over the ranks
    model = KeyMorph(TruncatedUNet3D(dtype=torch.bfloat16, **UNET), NUM_KEYPOINTS, device=dev)
    model.net.load_state_dict(reg_net.state_dict())
    model.eval()
    group = _timed(torch, out, "groupwise", lambda: model.groupwise_register(
        inputs["group"], transform_type=list(P14_TYPES), mesh=data))

    # one pair split over 'space'
    space = make_mesh(data=1, space=2, device_type="cuda", timeout=timeout)
    sfn = make_spatial_register_fn(reg_net, Config(num_keypoints=NUM_KEYPOINTS,
                                                   transform_type="tps_1"), space)
    spatial = _timed(torch, out, "spatial", lambda: sfn(*inputs["spatial"]))
    _timed(torch, out, "spatial second", lambda: sfn(*inputs["spatial"]))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # one pair on 'space' 2 per P14_SPATIAL net (the same inputs in every process)
    others, out["spatial_peak_gib"] = {}, {}
    for i, (name, (_, _, shape, _)) in enumerate(P14_SPATIAL.items()):
        pair = _make_pairs(torch, np.random.default_rng([SEED, 14, i]), dev, shape, 1)[0]
        snet = _p14_spatial_net(torch, dev, name)
        sfn = make_spatial_register_fn(snet, Config(num_keypoints=NUM_KEYPOINTS,
                                                    transform_type="tps_1"), space)
        torch.cuda.reset_peak_memory_stats()
        res = _timed(torch, out, f"spatial {name}", lambda: sfn(*pair))
        out["spatial_peak_gib"][name] = torch.cuda.max_memory_allocated() / 2 ** 30
        others[name] = (snet, pair, res)
        del sfn
        torch.cuda.empty_cache()
    dist.destroy_process_group()

    if rank == 0:  # the single-process references and the distances
        out["train"] = got
        d = out["dist"] = {}
        grid, pf, pm = reg
        f, m = inputs["register"]
        rpf, rpm, rgrid = _p14_register_single(torch, reg_net, f, m)
        npf, npm, ngrid = _p14_register_single(torch, reg_net, f * (1 + PERTURB),
                                               m * (1 + PERTURB))
        d["register keypoints"] = max(_p14_dist(pf, rpf), _p14_dist(pm, rpm))
        d["register grid"] = _p14_dist(grid, rgrid)
        d["register yardstick keypoints"] = max(_p14_dist(npf, rpf), _p14_dist(npm, rpm))
        d["register yardstick grid"] = _p14_dist(ngrid, rgrid)
        del rgrid, ngrid, grid
        ref = model.groupwise_register(inputs["group"], transform_type=list(P14_TYPES))
        moved = model.groupwise_register(inputs["group"] * (1 + PERTURB),
                                         transform_type=list(P14_TYPES))
        for name in P14_TYPES:
            for k in ("grouppoints_m", "grouppoints_a", "groupgrids"):
                d[f"groupwise {name} {k}"] = _p14_dist(group[name][k], ref[name][k])
                d[f"groupwise {name} {k} yardstick"] = _p14_dist(moved[name][k], ref[name][k])
        img_a, sgrid, spf, spm = spatial
        f, m = inputs["spatial"]
        with torch.no_grad():
            def unsplit(scale):
                kp = [center_of_mass(reg_net.backbone(v * scale).movedim(1, -1)) for v in (f, m)]
                g = align_pair(*kp, "tps", SPATIAL, lmbda=LMBDA)["grid"]
                return kp, g, align_img(g, m)

            (upf, upm), ugrid, uimg = unsplit(1.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unsplit(1.0)
            torch.cuda.synchronize()
            out["unsplit_ms"] = (time.perf_counter() - t0) * 1e3
            (npf, npm), ngrid, nimg = unsplit(1.0 + PERTURB)
            own = align_pair(spf, spm, "tps", SPATIAL, lmbda=LMBDA)["grid"]
            d["spatial stage grid"] = _p14_dist(sgrid, own)
            d["spatial stage image"] = _p14_dist(img_a, align_img(sgrid, m))
        d["spatial keypoints"] = max(_p14_dist(spf, upf), _p14_dist(spm, upm))
        d["spatial grid"] = _p14_dist(sgrid, ugrid)
        d["spatial image"] = _p14_dist(img_a, uimg)
        d["spatial yardstick keypoints"] = max(_p14_dist(npf, upf), _p14_dist(npm, upm))
        d["spatial yardstick grid"] = _p14_dist(ngrid, ugrid)
        d["spatial yardstick image"] = _p14_dist(nimg, uimg)
        del ugrid, ngrid, uimg, nimg, sgrid, img_a, own
        t0 = time.perf_counter()
        for name, (snet, (f, m), (img_a, sgrid, spf, spm)) in others.items():
            with torch.no_grad():
                (upf, upm), ugrid, uimg = _p14_spatial_unsplit(torch, snet, f, m, 1.0)
                (npf, npm), ngrid, nimg = _p14_spatial_unsplit(torch, snet, f, m, 1.0 + PERTURB)
                d[f"spatial {name} stage image"] = _p14_dist(img_a, align_img(sgrid, m))
            d[f"spatial {name} keypoints"] = max(_p14_dist(spf, upf), _p14_dist(spm, upm))
            d[f"spatial {name} grid"] = _p14_dist(sgrid, ugrid)
            d[f"spatial {name} image"] = _p14_dist(img_a, uimg)
            d[f"spatial {name} yardstick keypoints"] = max(_p14_dist(npf, upf),
                                                           _p14_dist(npm, upm))
            d[f"spatial {name} yardstick grid"] = _p14_dist(ngrid, ugrid)
            d[f"spatial {name} yardstick image"] = _p14_dist(nimg, uimg)
            del ugrid, ngrid, uimg, nimg
            torch.cuda.empty_cache()
        out["spatial_references_s"] = time.perf_counter() - t0
    torch.save(out, tmp / f"result_{rank}.pt")


def _p14_spawn(torch, tmp):
    """The 2-rank world: two processes of this script on cuda:0, joined
    with a deadline (``parallel.launch.spawn``: on a failure or at the
    deadline every survivor is killed and the ranks' logs are raised).
    Returns the ranks' results."""
    from keymorph_tpu_torch.parallel import launch

    launch.spawn([[sys.executable, str(Path(__file__).resolve()), "--seed", str(SEED),
                   "--phase14-rank", str(r), "--phase14-dir", str(tmp)] for r in range(2)],
                 tmp, P14_DEADLINE, cwd=ROOT)
    return [torch.load(tmp / f"result_{r}.pt", weights_only=False) for r in range(2)]


def _p14_single(torch, dev, tmp):
    """(a) a world of 1 on NCCL: the sharded step at 128^3 (a row of the
    step's batch) under phase 6's rule against the unsharded kernel step,
    and one 256^3 pair through the fan-out register against the
    single-process kernel path. Returns (the launch counts, the
    readings)."""
    import datetime

    import torch.distributed as dist

    from keymorph_tpu_torch.parallel import make_mesh, make_sharded_register_fn
    from keymorph_tpu_torch.training.config import Config

    timeout = datetime.timedelta(seconds=P14_TIMEOUT)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'store1'}", rank=0,
                            world_size=1, timeout=timeout)
    try:
        mesh = make_mesh(device_type="cuda", timeout=timeout)
        inputs = _p14_inputs(torch, dev)
        config = _train_config(TRAIN_SPATIAL)
        out = {"ms": {}, "counts": {}}
        got = _timed(torch, out, "train", lambda: _p14_step_readings(
            torch, dev, config, inputs, slice(0, 1), mesh))[0]
        held = _p14_hold_step(torch, dev, config, inputs, slice(0, 1), got,
                              "phase14 (a) world-1 step")
        net = _p14_net(torch, dev).eval()
        fn = make_sharded_register_fn(net, Config(num_keypoints=NUM_KEYPOINTS,
                                                  transform_type="tps_1"), mesh)
        f, m = (v[:1] for v in inputs["register"])
        grid, pf, pm = _timed(torch, out, "register", lambda: fn(f, m))
        _timed(torch, out, "register second", lambda: fn(f, m))
        rpf, rpm, rgrid = _p14_register_single(torch, net, f, m)
        d = {"keypoints": max(_p14_dist(pf, rpf), _p14_dist(pm, rpm)),
             "grid": _p14_dist(grid, rgrid)}
        del grid, rgrid
        stages = _p14_batch_stages(torch, net, *(v[:2] for v in inputs["register"]))
    finally:
        dist.destroy_process_group()
    print(f"phase14 (a) world of 1 (NCCL): step {out['ms']['train']:.3f} ms (first, with the "
          f"unsharded step's readings: the rule above), register of one 256^3 pair "
          f"{out['ms']['register']:.3f} / {out['ms']['register second']:.3f} ms (first / "
          f"second); vs the single-process kernel path: keypoints {d['keypoints']!r}, grid "
          f"{d['grid']!r} (tol {KEYPOINT_ABS}, {PLANES_ABS})")
    print(f"phase14 (a) a batch of 2 pairs at 256^3 against the 2 pairs one by one, single-process "
          f"kernel path, largest difference by stage (each on the same inputs; read, not held): "
          f"{json.dumps(stages)}")
    for path in ("train", "register"):
        _expect(f"phase 14 (a) {path}", out["counts"][path], P14_PATHS[path])
    if not held or d["keypoints"] > KEYPOINT_ABS or d["grid"] > PLANES_ABS:
        raise AssertionError("phase 14 (a): the world-1 sharded paths disagree with the "
                             "unsharded ones")
    counts = None
    for path in ("train", "register"):
        counts = _add_counts(counts, out["counts"][path])
    return counts


def phase14(torch, dev):
    """The parallel layer (module docstring, phase 14). Returns the launch
    counts of its paths, summed over (a) and every rank of (b)."""
    import tempfile

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="phase14_", dir=ROOT / "build"))
    counts = _p14_single(torch, dev, tmp)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = _p14_spawn(torch, tmp)
    t2 = time.perf_counter()
    for r, res in enumerate(ranks):
        for path, names in P14_PATHS.items():
            _expect(f"phase 14 (b) rank {r} {path}", res["counts"][path], names)
            counts = _add_counts(counts, res["counts"][path])
    ms = {k: [res["ms"][k] for res in ranks] for k in ranks[0]["ms"]}
    d = ranks[0]["dist"]
    reduce_ms = [ms[f"grad all-reduce {i}"] for i in range(3)]
    print(f"phase14 (b) 2 ranks on cuda:0 (gloo), ms by rank, host clock: step "
          f"{ms['train']} (first), {ms['train second']} (second); its gradient all-reduce "
          f"({ranks[0]['grad_mb']:.1f} MB fp32) {reduce_ms}; fan-out register of {P14_PAIRS} "
          f"pairs at 256^3 {ms['register']} / {ms['register second']}; groupwise_register "
          f"of {P14_GROUP} at 128^3 {ms['groupwise']}; the spatial pair at 256^3 on 'space' 2 "
          f"{ms['spatial']} / {ms['spatial second']} (unsplit, one process: "
          f"{ranks[0]['unsplit_ms']:.3f}, second); peak GiB {[r['peak_gib'] for r in ranks]}")
    print("phase14 (b) the spatial path on 'space' 2, one pair each, host clock ms by rank (first "
          "call) and peak GiB by rank: " + "; ".join(
              f"{name} ({P14_SPATIAL[name][0]}{', bf16' if P14_SPATIAL[name][1] else ', fp32'}, "
              f"{'x'.join(map(str, P14_SPATIAL[name][2]))}"
              f"{', ' + P14_SPATIAL[name][3] + ' weighting' if P14_SPATIAL[name][3] else ''}) "
              f"{ms['spatial ' + name]} ms, {[r['spatial_peak_gib'][name] for r in ranks]} GiB"
              for name in P14_SPATIAL)
          + f"; rank 0's unsplit references {ranks[0]['spatial_references_s']:.3f} s")
    held = _p14_hold_step(torch, dev, _train_config(TRAIN_SPATIAL), _p14_inputs(torch, dev),
                          slice(0, P14_TRAIN_BATCH), ranks[0]["train"], "phase14 (b) 2-rank step")
    checks = {
        "register keypoints": max(KEYPOINT_ABS, NOISE_FACTOR * d["register yardstick keypoints"]),
        "register grid": max(PLANES_ABS, NOISE_FACTOR * d["register yardstick grid"]),
        "spatial keypoints": max(KEYPOINT_ABS, NOISE_FACTOR * d["spatial yardstick keypoints"]),
        "spatial grid": max(PLANES_ABS, NOISE_FACTOR * d["spatial yardstick grid"]),
        "spatial stage grid": TPS_ABS, "spatial stage image": WARP_ABS,
    }
    for name in P14_TYPES:
        key = f"groupwise {name} grouppoints_m"
        checks[key] = max(KEYPOINT_ABS, NOISE_FACTOR * d[key + " yardstick"])
    for name in P14_SPATIAL:
        for what, floor in (("keypoints", KEYPOINT_ABS), ("grid", PLANES_ABS)):
            key = f"spatial {name} {what}"
            checks[key] = max(floor, NOISE_FACTOR * d[f"spatial {name} yardstick {what}"])
        checks[f"spatial {name} stage image"] = WARP_ABS
    print(f"phase14 (b) vs the single-process kernel path (register, groupwise) and the unsplit "
          f"module path (spatial), largest differences: {json.dumps(d)}; held (tol): "
          f"{json.dumps(checks)}; yardstick: the single-process path on its inputs moved by "
          f"{PERTURB} relative")
    bad = [k for k, tol in checks.items() if not d[k] <= tol]
    print(f"phase14 counters (summed over (a) and both ranks of (b)) "
          f"{json.dumps({k: c['launches'] for k, c in counts.items()})}; (a) "
          f"{t1 - t0:.3f} s, (b) {t2 - t1:.3f} s, phase 14 {time.perf_counter() - t0:.3f} s")
    if bad or not held:
        raise AssertionError(f"phase 14 (b) disagrees: {bad}, step held {held}")
    return counts


# phase 15: the tools and the panels
P15_REFUSE_S = 30             # s: --visualize without matplotlib refuses within
P15_SUBJECTS = 4              # make_synthetic_dataset's subjects
P15_SIZE = 128                # and their size
P15_PANEL_PATH = ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_flow", "warp_planes")


def _p15_visualize(torch, dev, reg_dir, out):
    """(a) ``--visualize`` of the register CLI on phase 11's files as a
    subprocess: without matplotlib it must refuse within P15_REFUSE_S,
    naming matplotlib, and write no metric; with it, the panel. Then the
    panels' device part, ``viz._panel_arrays``, on one flagship 256^3 pair:
    its image and keypoints bit for bit those of the same model's
    ``KeyMorph.forward`` + ``align_img``."""
    import importlib.util

    from keymorph_tpu_torch import viz
    from keymorph_tpu_torch.models.keymorph import KeyMorph
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.ops.resample import align_img

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    save_dir = reg_dir / "viz_out"
    argv = [sys.executable, "-m", "keymorph_tpu_torch.cli.register",
            "--moving", str(reg_dir / "moving.nii.gz"), "--fixed", str(reg_dir / "fixed.nii.gz"),
            "--moving_seg", str(reg_dir / "moving_seg.nii.gz"),
            "--fixed_seg", str(reg_dir / "fixed_seg.nii.gz"), "--backbone", "truncatedunet",
            "--use_amp", "--num_keypoints", str(NUM_KEYPOINTS), "--size", str(SPATIAL[0]),
            "--list_of_aligns", "tps_1", "--list_of_metrics", "mse", "--list_of_augs", "rot0",
            "--load_path", str(reg_dir / "weights.pt"), "--save_dir", str(save_dir),
            "--visualize"]
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT,
                       timeout=P15_REFUSE_S if not has_mpl else 600)
    wall = time.perf_counter() - t0
    written = sorted(p.name for p in save_dir.rglob("*")) if save_dir.exists() else []
    if has_mpl:
        ok = r.returncode == 0 and "panel-rot0-tps_1.png" in written
        what = f"matplotlib present: exit {r.returncode}, panels written {ok}"
    else:
        ok = (r.returncode != 0 and "matplotlib" in r.stderr
              and not any(n.startswith("metrics-") for n in written))
        what = (f"matplotlib absent: exit {r.returncode} in {wall:.3f} s (limit {P15_REFUSE_S}), "
                f"stderr names matplotlib {'matplotlib' in r.stderr}, files written {written}; "
                f"last stderr line: {r.stderr.strip().splitlines()[-1][:160] if r.stderr else ''}")
    print(f"phase15 (a) python -m keymorph_tpu_torch.cli.register ... --visualize: {what}")
    if not ok:
        raise AssertionError(f"phase 15 (a): --visualize did not behave: {r.stderr[-3000:]}")

    model = KeyMorph(TruncatedUNet3D(dtype=torch.bfloat16, **UNET), NUM_KEYPOINTS, device=dev)
    model.net.backbone.load_state_dict(init_weights(
        TruncatedUNet3D(dtype=torch.bfloat16, **UNET), torch.Generator().manual_seed(SEED)
    ).state_dict())
    img_f, img_m = _make_pairs(torch, np.random.default_rng([SEED, 15]), dev, SPATIAL, 1)[0]
    viz._panel_arrays(model, img_f, img_m, "tps_1")  # a first call
    arrays = _timed(torch, out, "panels", lambda: viz._panel_arrays(
        model, img_f, img_m, "tps_1"))
    with torch.no_grad():
        res = model(img_f, img_m, transform_type="tps_1", return_aligned_points=True)["tps_1"]
        img_a = align_img(res["grid"], img_m)[0, 0].cpu().numpy()
    same_img = np.array_equal(arrays["img"][2], img_a)
    same_pts = all(np.array_equal(a, res[k][0].cpu().numpy())
                   for a, k in zip(arrays["points"], ("points_m", "points_f", "points_a")))
    print(f"phase15 (a) viz._panel_arrays of one {SPATIAL[0]}^3 pair (tps_1): {out['ms']['panels']:.3f} "
          f"ms (second call, host clock), launches "
          f"{json.dumps({k: c['launches'] for k, c in out['counts']['panels'].items()})}; "
          f"bit for bit KeyMorph.forward + align_img: image {same_img}, keypoints {same_pts}")
    _expect("phase 15 (a) panels", out["counts"]["panels"], P15_PANEL_PATH)
    if not (same_img and same_pts):
        raise AssertionError("phase 15 (a): _panel_arrays differs from forward + align_img")


def _p15_tools(torch, out, reg_dir, extract_s):
    """(b) tps_approx_bench at its defaults and --ranked at 128^3; (c)
    warp_channels_bench at C = 1, 6, 14; (d) make_synthetic_dataset ->
    center_volumes on the card and on the CPU; (e) the flagship extraction's
    FLOPs and phase 2's steady extraction's MFU; (f) conv_microbench at
    256^3."""
    import os

    from keymorph_tpu_torch.data.nifti import load_nifti
    from keymorph_tpu_torch.tools import (center_volumes, flops, make_synthetic_dataset,
                                          tps_approx_bench, warp_channels_bench)

    rec = _timed(torch, out, "tps_approx", lambda: tps_approx_bench.main([]))
    ranked = _timed(torch, out, "tps_approx ranked",
                        lambda: tps_approx_bench.main(["--ranked", "128"]))
    vals = list(rec["ms"].values()) + list(rec["max_abs_d"].values())
    vals += [r[k] for r in ranked["rows"] for k in ("max_abs_d", "mean_abs_d")]
    dice = [r["dice_vs_exact"] for r in ranked["rows"]]
    print(f"phase15 (b) tps_approx_bench {rec['size']}^3 K={rec['K']}: ms {json.dumps(rec['ms'])}, speedup "
          f"{json.dumps(rec['speedup'])}, max |d| from exact {json.dumps(rec['max_abs_d'])}; "
          f"--ranked {ranked['size']}^3 K={ranked['K']}: {len(ranked['rows'])} rows, dice vs exact {dice}")
    if not (np.all(np.isfinite(vals)) and all(0.0 <= x <= 1.0 for x in dice)):
        raise AssertionError("phase 15 (b): tps_approx_bench read a non-finite value")
    _expect("phase 15 (b)", out["counts"]["tps_approx"], ("tps_planes",))
    _expect("phase 15 (b) ranked", out["counts"]["tps_approx ranked"],
            ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_planes", "warp_planes"))

    warp = _timed(torch, out, "warp_channels", lambda: warp_channels_bench.main([]))
    print(f"phase15 (c) warp_channels_bench {warp['S']}^3: " + "; ".join(
        f"C={r['C']} kernel {r['ms']:.4f} ms, F.grid_sample {r['grid_sample_ms']:.4f}, bound "
        f"{r['bound_ms']:.4f}, vs plain {r['max_abs_err_vs_plain']!r}" for r in warp["rows"]))
    _expect("phase 15 (c)", out["counts"]["warp_channels"], ("warp_planes",), plain_ok=True)

    data = reg_dir / "p15_data"
    t0 = time.perf_counter()
    make_synthetic_dataset.main(["--out", str(data), "--n", str(P15_SUBJECTS),
                                 "--size", str(P15_SIZE)])
    made_s = time.perf_counter() - t0
    imgs = data / "imgs"
    imgs.mkdir()
    for f in sorted(data.glob("img*.nii.gz")):
        os.link(f, imgs / f.name)
    argv = ["--img_dir", str(imgs), "--reference", str(imgs / "img0_T1.nii.gz")]
    _timed(torch, out, "center_volumes", lambda: center_volumes.main(
        argv + ["--out_dir", str(data / "card")]))
    t0 = time.perf_counter()
    center_volumes.main(argv + ["--out_dir", str(data / "cpu"), "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    names = sorted(p.name for p in imgs.iterdir())
    d_vol = max(float(np.abs(load_nifti(str(data / "card" / n)).data
                             - load_nifti(str(data / "cpu" / n)).data).max()) for n in names)
    ref_c = center_volumes.intensity_centroid_voxel(load_nifti(str(imgs / names[0])).data)
    moved = [float(np.linalg.norm(center_volumes.intensity_centroid_voxel(
        load_nifti(str(d / n)).data) - ref_c)) for n in names[1:] for d in (imgs, data / "card")]
    print(f"phase15 (d) make_synthetic_dataset {P15_SUBJECTS} x {P15_SIZE}^3 {made_s:.3f} s; "
          f"center_volumes on the card {out['ms']['center_volumes'] / 1e3:.3f} s, on the CPU "
          f"{cpu_s:.3f} s; card vs CPU volumes {d_vol!r} (tol {WARP_ABS}); centroid distance "
          f"from the reference's before / after, voxels: {moved}")
    _expect("phase 15 (d)", out["counts"]["center_volumes"], ("warp_planes",))
    if not (d_vol <= WARP_ABS and all(a > b for a, b in zip(moved[::2], moved[1::2]))):
        raise AssertionError("phase 15 (d): center_volumes on the card differs from the CPU's "
                             "or moved a centroid away")

    from keymorph_tpu_torch.tools import conv_microbench

    rows, total = _timed(torch, out, "conv_microbench", lambda: conv_microbench.main(
        ["--size", str(SPATIAL[0]), "--reps", "3"]))
    print(f"phase15 (f) conv_microbench --size {SPATIAL[0]} --reps 3 (its lines above; CUDA events): "
          f"{total['stages']} stages, kernel {total['kernel_ms']:.4f} ms, F.conv3d bf16 "
          f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms in all; " + ", ".join(
              f"{r['stage']} {r['kernel']} {r['kernel_ms']:.4f} / {r['library_ms']:.4f} / "
              f"{r['bound_ms']:.4f} ({r['bound_by']})" for r in rows))
    vals = [r[k] for r in rows for k in ("kernel_ms", "library_ms", "bound_ms")]
    if len(rows) != 13 or not all(np.isfinite(v) and v > 0 for v in vals):
        raise AssertionError("phase 15 (f): conv_microbench read a missing or non-finite time")
    # the tool times the weight gradient's plain version beside its kernel,
    # once a call: that plain version, and no other, runs
    counts = out["counts"]["conv_microbench"]
    wgrad = counts["conv3x3_weight_grad"]
    if wgrad["plain_calls"] != wgrad["launches"]:
        raise AssertionError(f"phase 15 (f): the weight gradient's plain version ran "
                             f"{wgrad['plain_calls']} times for {wgrad['launches']} launches")
    _expect("phase 15 (f)", {**counts, "conv3x3_weight_grad": {**wgrad, "plain_calls": 0}},
            ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
             "conv3x3_weight_grad"))

    flop = flops.unet_extract_flops(SPATIAL, NUM_KEYPOINTS, UNET["f_maps"], UNET["num_levels"],
                                    UNET["num_truncated_layers"])
    print(f"phase15 (e) flops: the flagship extraction at {SPATIAL[0]}^3 {flop:.6e} FLOP; phase 2's steady "
          f"extraction {extract_s * 1e3:.3f} ms a volume, MFU "
          f"{flops.mfu(flop, extract_s):.4f} of {flops.H100_BF16_PEAK_FLOPS:.3e} FLOP/s bf16")


def phase15(torch, dev, reg_dir, extract_s):
    """The tools and the panels (module docstring, phase 15). Returns the
    launch counts of their device paths."""
    t0 = time.perf_counter()
    out = {"ms": {}, "counts": {}}
    _p15_visualize(torch, dev, reg_dir, out)
    torch.cuda.empty_cache()
    _p15_tools(torch, out, reg_dir, extract_s)
    counts = None
    for c in out["counts"].values():
        counts = _add_counts(counts, c)
    print(f"phase15 counters (summed over its device paths) "
          f"{json.dumps({k: c['launches'] for k, c in counts.items()})}; phase 15 "
          f"{time.perf_counter() - t0:.3f} s")
    return counts


# phase 16: the benchmark, the entry points and the pair example
P16_ITERS = 8                 # the bench's chained registrations (BENCH_ITERS)
P16_RANKS = 2                 # dryrun_multichip's gloo ranks on the one card
P16_EXAMPLE_SIZE = 128        # the example's --size (its default)
P16_ENTRY_ABS = 1e-5          # the entry's floors (phase 13's 2D floors): keypoints, matrix, image
P16_BENCH_PATH = ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_planes",
                  "warp_planes")
P16_DRYRUN_PATH = ("tps_planes", "tps_planes_bwd", "tps_flow", "warp_planes",
                   "warp_planes_grad")
P16_EXAMPLE_PATH = ("tps_flow", "warp_planes")


def _p16_bench(torch, dev, out):
    """(a) ``bench.run`` at 256^3 with the stages and the batch rows; its
    first warped volume against phase 2's calls on the bench's own net and
    pair, bit for bit."""
    from keymorph_tpu_torch import bench
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops.resample import align_planes

    rec, first = _timed(torch, out, "bench", lambda: bench.run(
        SPATIAL[0], NUM_KEYPOINTS, P16_ITERS, stages=True, throughput=True, device=dev,
        seed=SEED, return_first=True))
    print(f"phase16 (a) python -m keymorph_tpu_torch.bench at {SPATIAL[0]}^3 with BENCH_THROUGHPUT=1 "
          f"and seed {SEED} ({out['ms']['bench'] / 1e3:.3f} s); its line:")
    print(json.dumps(rec))
    net, img_f, img_m, _ = bench.setup(SPATIAL[0], NUM_KEYPOINTS, dev, SEED)
    with torch.no_grad():
        pf, pm, _ = net(img_f, img_m)
        planes = align_pair(pf, pm, "tps", SPATIAL, lmbda=LMBDA, compute_grid="planes")["planes"]
        warped = align_planes(planes, img_m)
    same = torch.equal(warped, first)
    st, rows = rec["stages"], rec["per_batch"]
    print(f"phase16 (a) the bench's first warped volume against phase 2's calls on its net and "
          f"pair: bit for bit {same} (max |d| {(warped - first).abs().max().item()!r}); launches "
          f"{json.dumps({k: c['launches'] for k, c in out['counts']['bench'].items()})}")
    _expect("phase 16 (a) bench", out["counts"]["bench"], P16_BENCH_PATH)
    vals = [rec["value"]] + [st[k] for k in ("extract_ms", "solve_flow_ms", "warp_ms",
                                             "register_ms", "extract_mfu", "solve_flow_mfu",
                                             "warp_hbm_frac", "busy_ms", "idle_share")]
    vals += [r[k] for r in rows.values() for k in ("latency_ms", "regs_per_sec", "peak_gib")]
    if not (same and list(rows) == ["1", "2", "4", "8"] and rec["device"]
            and all(v is not None and np.isfinite(v) and v >= 0 for v in vals)
            and rec["value"] == 1e3 / st["register_ms"] and first.shape == (1, 1, *SPATIAL)):
        raise AssertionError("phase 16 (a): the bench's record or first volume is wrong")


def _p16_entry(torch, dev, out, rng):
    """(b) ``entry()`` on the card and on the CPU, same weights and seeded
    blob volumes, under phase 13's card-vs-CPU rule (float64: the backbone
    and the head, then the fp32 fit, grid and warp on the CPU)."""
    from keymorph_tpu_torch import entry
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D
    from keymorph_tpu_torch.ops.resample import align_img

    fn, (params, img, _) = entry.entry()
    cpu_fn = entry.entry(device="cpu")[0]
    shape = tuple(img.shape[2:])
    f, m = (v.cpu() for v in _make_pairs(torch, rng, "cpu", shape, 1)[0])
    with torch.no_grad():
        got = _timed(torch, out, "entry", lambda: fn(params, f.to(dev), m.to(dev)))
        ref = cpu_fn({k: v.cpu() for k, v in params.items()}, f, m)
        bb64 = TruncatedUNet3D(**entry.ENTRY_UNET, dtype=torch.float64).double()
        bb64.load_state_dict({k[len("backbone."):]: v.cpu().double() for k, v in params.items()
                              if k.startswith("backbone.")})
        kp64 = [_com64(torch, bb64(v.double()).movedim(1, -1)).float() for v in (f, m)]
        y = align_pair(*kp64, "affine", shape, compute_grid=True)
        yard_of = (align_img(y["grid"], m), y["matrix"], *kp64)
    ok, rows = True, []
    for name, a, b, c in zip(("warped", "matrix", "points_f", "points_m"), got, ref, yard_of):
        d, yard, own = _dist(a, b), _dist(b, c), _dist(a, c)
        tol = max(P16_ENTRY_ABS, CARD_CPU_FACTOR * yard)
        rows.append(f"{name} {d!r} (yardstick {yard!r}, tol {tol!r}; the card from the float64 "
                    f"call {own!r})")
        ok &= d <= tol and bool(torch.isfinite(a).all())
    print(f"phase16 (b) entry() at {shape}, card vs CPU ({out['ms']['entry']:.3f} ms, first call, "
          f"host clock): " + "; ".join(rows))
    _expect("phase 16 (b) entry", out["counts"]["entry"], ("warp_planes",))
    if not ok:
        raise AssertionError("phase 16 (b): entry() on the card disagrees with the CPU's")


def _p16_dryrun(torch, out):
    """(c) ``dryrun_multichip`` over gloo ranks on the one card: every rank
    runs every path and their launches are summed."""
    from keymorph_tpu_torch import entry

    t0 = time.perf_counter()
    ranks = entry.dryrun_multichip(P16_RANKS)
    out["ms"]["dryrun"] = (time.perf_counter() - t0) * 1e3
    counts = None
    for r, res in enumerate(ranks):
        c = {k: {"launches": res["launches"][k], "plain_calls": res["plain_calls"][k]}
             for k in res["launches"]}
        _expect(f"phase 16 (c) dryrun rank {r}", c, P16_DRYRUN_PATH)
        counts = _add_counts(counts, c)
    out["counts"]["dryrun"] = counts
    print(f"phase16 (c) dryrun_multichip({P16_RANKS}) on cuda:0 over gloo: "
          f"{out['ms']['dryrun'] / 1e3:.3f} s (host clock, the ranks' start included); losses by "
          f"rank {[res['loss'] for res in ranks]}; launches summed over the ranks "
          f"{json.dumps({k: c['launches'] for k, c in counts.items()})}")
    if not all(np.isfinite(res["loss"]) for res in ranks):
        raise AssertionError("phase 16 (c): a non-finite loss")


def _p16_example(torch, dev, out, reg_dir):
    """(d) the example's ``register_pair`` on phase 11's IXI-like pair at
    its default size (``main`` refuses without matplotlib, before any
    work); MSE and hard Dice against a float64 recomputation on the CPU
    from the example's own warped volumes."""
    import importlib.util

    import torch.nn.functional as F

    from keymorph_tpu_torch.data import Preprocessor
    from keymorph_tpu_torch.examples import register_pair as ex
    from keymorph_tpu_torch.ops.resample import align_img
    from keymorph_tpu_torch.utils import one_hot

    argv = ["--fixed", str(reg_dir / "fixed.nii.gz"), "--moving", str(reg_dir / "moving.nii.gz"),
            "--fixed_seg", str(reg_dir / "fixed_seg.nii.gz"), "--moving_seg",
            str(reg_dir / "moving_seg.nii.gz"), "--out", str(reg_dir / "example_out")]
    if importlib.util.find_spec("matplotlib") is None:
        try:
            ex.main(argv)
            raise AssertionError("phase 16 (d): the example ran without matplotlib")
        except ImportError as e:
            refused = f"refuses without matplotlib: {e}"
        if (reg_dir / "example_out").exists():
            raise AssertionError("phase 16 (d): the example wrote files before refusing")
    else:
        refused = "matplotlib present"
    pre = Preprocessor(size=(P16_EXAMPLE_SIZE,) * 3)
    fixed, moving = (pre.load(str(reg_dir / f"{s}.nii.gz"), seg_path=str(reg_dir / f"{s}_seg.nii.gz"))
                     for s in ("fixed", "moving"))
    km = ex.build_model(NUM_KEYPOINTS, dev, SEED)
    res = _timed(torch, out, "example", lambda: ex.register_pair(fixed, moving, km))
    n_cls = int(max(fixed["seg"].max(), moving["seg"].max())) + 1
    img_f64 = torch.tensor(fixed["img"][None], dtype=torch.float64)
    seg_f64 = one_hot(torch.tensor(fixed["seg"][None].astype(np.int64)), n_cls).double()
    seg_m = one_hot(torch.tensor(moving["seg"][None].astype(np.int64), device=dev), n_cls)
    ok, rows = True, []
    for name, r in res.items():
        with torch.no_grad():
            seg_a = align_img(r["grid"], seg_m).cpu()
        mse = float(((img_f64 - r["img_a"].cpu().double()) ** 2).mean())
        p = F.one_hot(seg_a.argmax(1), n_cls).movedim(-1, 1).double()[:, 1:].flatten(2)
        t = seg_f64[:, 1:].flatten(2)
        dice = 1.0 - float((1.0 - (2.0 * (p * t).sum(2) + 1.0)
                            / ((p * p).sum(2) + (t * t).sum(2) + 1.0)).mean())
        d_mse, d_dice = abs(r["mse"] / mse - 1.0), abs(r["harddice"] - dice)
        rows.append(f"{name} mse {r['mse']!r} rel {d_mse!r} (tol {MSE_REL}), harddice "
                    f"{r['harddice']!r} {d_dice!r} (tol {DICE_MEAN_ABS!r})")
        ok &= (d_mse <= MSE_REL and d_dice <= DICE_MEAN_ABS
               and r["grid"].shape == (1, *(P16_EXAMPLE_SIZE,) * 3, 3)
               and bool(torch.isfinite(r["grid"]).all()))
    print(f"phase16 (d) examples/register_pair ({refused}): register_pair of phase 11's pair at "
          f"{P16_EXAMPLE_SIZE}^3, fp32 net, {NUM_KEYPOINTS} keypoints, {list(res)}: "
          f"{out['ms']['example']:.3f} ms (first call, host clock); against float64: "
          + "; ".join(rows))
    _expect("phase 16 (d) example", out["counts"]["example"], P16_EXAMPLE_PATH)
    if not ok:
        raise AssertionError("phase 16 (d): the example's metrics disagree with float64")


def phase16(torch, dev, reg_dir):
    """The benchmark, the entry points and the pair example (module
    docstring, phase 16). Returns the launch counts of their device paths."""
    t0 = time.perf_counter()
    out = {"ms": {}, "counts": {}}
    _p16_bench(torch, dev, out)
    torch.cuda.empty_cache()
    _p16_entry(torch, dev, out, np.random.default_rng([SEED, 16]))
    _p16_dryrun(torch, out)
    _p16_example(torch, dev, out, reg_dir)
    counts = None
    for c in out["counts"].values():
        counts = _add_counts(counts, c)
    print(f"phase16 counters (summed over its device paths) "
          f"{json.dumps({k: c['launches'] for k, c in counts.items()})}; phase 16 "
          f"{time.perf_counter() - t0:.3f} s")
    return counts


# phase 17: the port's trained nets (runs/torch_weight_parity)
P17_RUN = ROOT / "runs" / "torch_weight_parity"
P17_NET = dict(num_keypoints=32, f_maps=8, num_levels=3)
# the net (a) trains again: the committed truncated net's first P17_STEPS
# steps at 96^3, held against the committed run's same steps. Its 600 steps
# (~58 s) and the UNet's (234.6 ms each, its record beside the weights) are
# past the phase's budget; the tool trains them.
P17_TRAIN = "truncatedunet"
P17_STEPS = 200
P17_TAIL = 50                 # steps of the final mean loss
P17_LOSS_REL = 0.2            # the final mean loss against the committed run's
P17_EVAL_SIZE = 128           # the truncated configs' held-out pair (--eval_size)
P17_KEYPOINT_ABS = 1e-5       # card vs CPU floors (phase 13's): normalized units
P17_GRID_ABS = 1e-5
P17_RW_TPS_ABS = 5e-3         # real-world TPS grids: the fp32 limit (tests/test_torch_weight_parity.py)
P17_DICE_ABS = 1e-5
P17_TRAIN_PATH = ("warp_planes", "warp_planes_grad")
P17_SERVE_PATH = ("tps_flow", "warp_planes")


def _p17_data():
    """(a)'s training record and the images ``weight_parity.main`` trained
    its net on."""
    from keymorph_tpu_torch.tools import weight_parity as wp

    rec = wp.read_record(P17_RUN, P17_TRAIN)
    return rec, wp.make_subjects(size=rec["size"], seed=rec["data_seed"])[0][2:]


def _p17_step(torch, dev, rng, rec, imgs):
    """(a)'s step check: the first step of ``train_port`` (its pair and
    augmentation, its initial weights) through the kernels and on the plain
    versions, and once more on the plain versions with the pair perturbed by
    PERTURB (the yardstick), under phase 6's rule. Returns whether it holds."""
    from keymorph_tpu_torch.models.keymorph import KeyMorph
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.tools import weight_parity as wp

    data = torch.from_numpy(imgs).to(dev)
    pair = wp.draw_pair(data, np.random.default_rng(rec["seed"]),
                        torch.Generator().manual_seed(rec["seed"]))

    def step(p, plain):
        net = wp.build_backbone(backbone=P17_TRAIN, seed=rec["seed"], **P17_NET)
        model = KeyMorph(net, P17_NET["num_keypoints"], device=dev).train()
        loss = wp.affine_mse(model, *p, plain=plain)
        loss.backward()
        grads = _grads(model.net)
        return (float(loss.detach()), float(sum((g ** 2).sum() for g in grads.values()) ** 0.5),
                grads)

    kernels.reset_counters()
    kern = step(pair, False)
    _expect("phase17 (a) step", kernels.counters(), P17_TRAIN_PATH)
    plain = step(pair, True)
    noisy = tuple(v * (1.0 + PERTURB * torch.tensor(
        rng.choice([-1.0, 1.0], size=tuple(v.shape)).astype(np.float32), device=dev))
        for v in pair)
    return _hold_readings("phase17 (a) step", kern, plain, step(noisy, True))


def _p17_train(torch, dev, rng, out):
    """(a) ``train_port`` on the card at the committed net's settings: the
    step check, then its first P17_STEPS steps, their loss every 100 steps
    beside the committed run's and their final mean loss against the
    committed run's over the same steps."""
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.tools import weight_parity as wp

    rec, imgs = _p17_data()
    if not _p17_step(torch, dev, rng, rec, imgs):
        raise AssertionError("phase 17 (a): the kernel step and the plain step disagree")
    torch.cuda.synchronize()
    kernels.reset_counters()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    _, losses = wp.train_port(imgs, P17_STEPS, rec["num_keypoints"], rec["f_maps"],
                              rec["num_levels"], rec["lr"], seed=rec["seed"], backbone=P17_TRAIN,
                              device=dev, log_every=0)
    b.record()
    torch.cuda.synchronize()
    out["counts"]["train"] = kernels.counters()
    _expect("phase 17 (a) train_port", out["counts"]["train"], P17_TRAIN_PATH)
    ms = a.elapsed_time(b) / P17_STEPS
    committed = rec["losses"][:P17_STEPS]
    rows = [f"{i}-{i + 99}: {np.mean(losses[i:i + 100]):.5f} ({np.mean(committed[i:i + 100]):.5f})"
            for i in range(0, P17_STEPS, 100)]
    tail, tail_c = float(np.mean(losses[-P17_TAIL:])), float(np.mean(committed[-P17_TAIL:]))
    rel = abs(tail / tail_c - 1.0)
    print(f"phase17 (a) train_port {P17_TRAIN} {P17_STEPS} of {rec['steps']} steps at {rec['size']}^3 on the "
          f"card: {ms:.3f} ms a step (CUDA events; the committed run {rec['ms_per_step_host_clock']:.3f}"
          f" host clock on {rec['card']}); mean MSE by 100 steps (committed): " + ", ".join(rows))
    print(f"phase17 (a) steps {P17_STEPS - P17_TAIL}-{P17_STEPS - 1} mean MSE {tail!r}, committed {tail_c!r}: rel {rel!r} "
          f"(tol {P17_LOSS_REL})")
    if not (np.all(np.isfinite(losses)) and rel <= P17_LOSS_REL):
        raise AssertionError("phase 17 (a): the card's training run strays from the committed one")


def _p17_dice(torch, grid, oh_f, oh_m):
    """Hard Dice (no background) of the one-hot moving segmentation warped
    bilinear by ``grid``, as keymorph_tpu's ``weight_parity._compare`` reads it."""
    from keymorph_tpu_torch.losses import hard_dice_loss
    from keymorph_tpu_torch.ops.resample import align_img

    return 1.0 - float(hard_dice_loss(align_img(grid, oh_m), oh_f, ign_first_ch=True))


def _p17_serve(torch, dev, out):
    """(b) the committed nets register each config's held-out pair, five
    aligns each, on the card and on the CPU; points, grids and hard Dice
    held under phase 13's card-vs-CPU rule (the yardstick: the CPU route
    against the float64 backbone and head, run on the card, then the fp32
    fit, grid and warp on the CPU)."""
    from keymorph_tpu_torch.models.keymorph import align_pair, parse_transform_type
    from keymorph_tpu_torch.tools import weight_parity as wp
    from keymorph_tpu_torch.utils import one_hot

    pairs = wp.eval_pairs(wp.read_record(P17_RUN, "unet")["size"], P17_EVAL_SIZE)
    ok = True
    for backbone in wp.CHECKPOINTS:
        path = P17_RUN / wp.CHECKPOINTS[backbone]
        card = wp.load_port(path, backbone=backbone, device=dev, **P17_NET)
        cpu = wp.load_port(path, backbone=backbone, device="cpu", **P17_NET)
        net64 = wp.build_backbone(backbone=backbone, dtype=torch.float64, **P17_NET)
        net64.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["state_dict"])
        net64.to(dev)
        kp64 = {}
        for config in (c for c in wp.CONFIGS if wp.config_backbone(c) == backbone):
            img_f, img_m, seg_f, seg_m, aff_f, aff_m = pairs[config]
            n_cls = int(max(seg_f.max(), seg_m.max())) + 1
            oh = [one_hot(torch.from_numpy(s.astype(np.int64)), n_cls).float() for s in (seg_f, seg_m)]
            rw = aff_f is not None

            def serve(model):
                res = wp.port_register(model, img_f, img_m, wp.ALIGNS, aff_f, aff_m)[0]
                f, m = (v.to(model.device) for v in oh)
                return res, {k: _p17_dice(torch, model._tensor(r["grid"]), f, m)
                             for k, r in res.items()}

            got = _timed(torch, out, config, lambda: serve(card))
            _expect(f"phase 17 (b) {config}", out["counts"][config], P17_SERVE_PATH)
            ref = serve(cpu)
            if not kp64:
                with torch.no_grad():
                    kp64 = [_com64(torch, net64(torch.from_numpy(x).to(dev).double()).movedim(1, -1))
                            .float().cpu() for x in (img_f, img_m)]
            yard = {}
            for k in wp.ALIGNS:
                align_type, lm = parse_transform_type(k)
                rwkw = {} if not rw else {"aff_f": torch.from_numpy(aff_f),
                                          "aff_m": torch.from_numpy(aff_m)}
                with torch.no_grad():
                    g = align_pair(*kp64, align_type, img_m.shape[2:], compute_grid=True,
                                   lmbda=None if lm is None else torch.full((1,), float(lm)),
                                   moving_shape=img_m.shape[2:], **rwkw)["grid"]
                yard[k] = (g, _p17_dice(torch, g, *oh))
            rows = []

            def hold(name, a, b, c, floor):
                nonlocal ok
                d, y = float(np.abs(a - b).max()), float(np.abs(b - c).max())
                tol = max(floor, CARD_CPU_FACTOR * y)
                rows.append(f"{name} {d:.3e} (yardstick {y:.3e}, tol {tol:.3e})")
                ok &= d <= tol and bool(np.all(np.isfinite(a)))

            first = wp.ALIGNS[0]
            for i, f in enumerate(("points_f", "points_m")):
                hold(f, got[0][first][f], ref[0][first][f], kp64[i].numpy(), P17_KEYPOINT_ABS)
            for k in wp.ALIGNS:
                floor = P17_RW_TPS_ABS if rw and k.startswith("tps") else P17_GRID_ABS
                hold(f"{k} grid", got[0][k]["grid"], ref[0][k]["grid"], yard[k][0].numpy(), floor)
                hold(f"{k} harddice", np.float64(got[1][k]), np.float64(ref[1][k]),
                     np.float64(yard[k][1]), P17_DICE_ABS)
            print(f"phase17 (b) {config} ({backbone}, {tuple(img_f.shape[2:])}, "
                  f"{out['ms'][config]:.3f} ms on the card, first call, host clock; hard Dice "
                  f"{json.dumps({k: round(v, 5) for k, v in got[1].items()})}), card vs CPU: "
                  + "; ".join(rows))
    if not ok:
        raise AssertionError("phase 17 (b): the card's registrations disagree with the CPU's")


def phase17(torch, dev):
    """The port's trained nets (module docstring, phase 17). Returns the
    launch counts of its device paths."""
    t0 = time.perf_counter()
    out = {"ms": {}, "counts": {}}
    _p17_train(torch, dev, np.random.default_rng([SEED, 17]), out)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _p17_serve(torch, dev, out)
    counts = None
    for c in out["counts"].values():
        counts = _add_counts(counts, c)
    t2 = time.perf_counter()
    print(f"phase17 counters (summed over its device paths) "
          f"{json.dumps({k: c['launches'] for k, c in counts.items()})}; (a) {t1 - t0:.3f} s, "
          f"(b) {t2 - t1:.3f} s, phase 17 {t2 - t0:.3f} s")
    return counts


RESUNET = dict(out_channels=256, f_maps=32, num_levels=4)  # the benchmark's resunetse-k256-full


def phase18(torch, dev):
    """The 256^3 bf16 ResidualUNetSE3D (f_maps 32, 4 levels, 'gcr', 256
    keypoints) served through ``KeyMorphNet.features`` under no_grad, the
    counters set to 0 just before: each residual kernel launches as often as
    the net has its layers (7 block-first convs, 7 block ends, 4 lifts, 3
    pools, 3 transposed convs, 7 gates, 1 final conv) and no plain version runs. Its
    heatmaps and keypoints against its plain route (``plain=True``) under
    phase 3's yardstick rule. Weights from the seed, biases and norm affines
    moved off their init. Returns the launch counts."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.layers import center_of_mass
    from keymorph_tpu_torch.models.unet import ResidualUNetSE3D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels

    gen = torch.Generator().manual_seed(SEED + 18)
    backbone = init_weights(ResidualUNetSE3D(dtype=torch.bfloat16, **RESUNET), gen)
    with torch.no_grad():
        for p in backbone.parameters():
            if p.dim() == 1:  # conv biases, norm scales and biases
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    net = KeyMorphNet(backbone, RESUNET["out_channels"]).to(dev).eval()
    img = _make_pairs(torch, np.random.default_rng([SEED, 18]), dev, n_pairs=1)[0][0]
    want = {"conv3x3_fused_flat": 7, "conv3x3_fused_flat_res": 7, "lift1x1_flat": 4,
            "maxpool2_flat": 3, "conv_transpose3x3s2_flat": 3, "scse_gate_flat": 7,
            "final_conv1x1": 1}
    with torch.no_grad():
        net.features(img)  # first call: the kernels' shapes warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()
        k_feat = net.features(img)
        counts = kernels.counters()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _expect("phase 18 ResidualUNetSE3D", counts, tuple(want))
        got = {name: counts[name]["launches"] for name in want}
        if got != want or any(c["launches"] for n, c in counts.items() if n not in want):
            raise AssertionError(f"phase 18: launches {counts}, want {want} and no other")
        p_feat = net.features(img, plain=True)
        d = (k_feat.float() - p_feat.float()).abs().max().item()
        d_kp = (center_of_mass(k_feat) - center_of_mass(p_feat)).abs().max().item()
        del k_feat
        n_feat = net.features(img * (1 + PERTURB), plain=True)
        top = p_feat.float().abs().max().item()
        y = (n_feat.float() - p_feat.float()).abs().max().item() / top
        y_kp = (center_of_mass(n_feat) - center_of_mass(p_feat)).abs().max().item()
        d /= top
        del n_feat, p_feat
        k_ms = _cuda_ms(lambda: net.features(img), 3)
        p_ms = _cuda_ms(lambda: net.features(img, plain=True), 1)
    tol, tol_kp = max(HEATMAP_REL, NOISE_FACTOR * y), max(KEYPOINT_ABS, NOISE_FACTOR * y_kp)
    print(f"phase18 ResidualUNetSE3D at {SPATIAL}: heatmaps {k_ms:.3f} ms through the kernels "
          f"(peak device memory {peak:.3f} GiB), {p_ms:.3f} ms plain; kernels vs plain {d!r} x "
          f"max (yardstick {y!r}, tol {tol!r}); keypoints {d_kp!r} (yardstick {y_kp!r}, tol "
          f"{tol_kp!r}); launches {json.dumps(got)}")
    if d > tol or d_kp > tol_kp:
        raise AssertionError("phase 18: the residual net's heatmaps through the kernels disagree "
                             "with its plain route")
    return counts


# --plant-fault: each fault wraps one kernel's wrapper, so only the kernel
# route sees it (the plain steps call the plain versions by their own names)
FAULTS = ("warp_grad_plane", "input_grad_half", "weight_grad_half")


def _plant(kind):
    from keymorph_tpu_torch.ops.cuda import conv3d, resample3d

    module, name = {"warp_grad_plane": (resample3d, "warp_planes_grad"),
                    "input_grad_half": (conv3d, "conv3x3_input_grad"),
                    "weight_grad_half": (conv3d, "conv3x3_weight_grad")}[kind]
    real = getattr(module, name)

    def faulty(*args):
        out = real(*args)
        faulty.launches += 1
        if kind == "warp_grad_plane":
            out[:, 0] = 0.0
            return out
        if kind == "weight_grad_half":
            return out * 0.5
        return tuple(None if o is None else o * 0.5 for o in out)

    faulty.launches = 0
    setattr(module, name, faulty)


def fault_control(torch, dev, kind):
    """Phases 5, 6 and 10, phase 12's kernel steps and phase 17 (a)'s step
    check with ``kind`` planted
    in the kernel route: each step comparison whose path holds the faulty
    kernel must fail under the rule it is held to. Phase 5's volumes and
    subset are drawn afresh from the seed, so they differ from those of the
    full run at the same seed."""
    _plant(kind)
    rng = np.random.default_rng(SEED)
    first, _, _ = phase5(torch, rng, dev)
    held = {"phase6": hold_step(torch, rng, dev, first, "phase6")}
    torch.cuda.empty_cache()
    held.update(phase10(torch, rng, dev, first)[1])
    torch.cuda.empty_cache()
    # phase 12's kernel steps whose path holds the faulty kernel
    img = _make_pairs(torch, rng, dev, RUN_SIZE, 1, noise_amp=0.0)[0][0]
    step_held = _phase12_steps(torch, rng, dev, img)[1]
    held.update({k: v for k, v in step_held.items()
                 if kind != "warp_grad_plane" or "same-resolution" in k})
    if kind == "warp_grad_plane":  # phase 17's fp32 nets reach no conv kernel
        held["phase17 (a) step"] = _p17_step(torch, dev, np.random.default_rng([SEED, 17]),
                                             *_p17_data())
    caught = {label: not ok for label, ok in held.items()}
    print(json.dumps({"planted_fault": kind, "seed": SEED, "caught": caught}))
    if not all(caught.values()):
        raise AssertionError(f"the planted fault {kind} passed: "
                             f"{[k for k, c in caught.items() if not c]}")


def main():
    import argparse

    import torch

    global SEED
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--plant-fault", choices=FAULTS, default=None)
    ap.add_argument("--phase14-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phase14-dir", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    SEED = args.seed
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; the port has no CPU smoke")
    if args.phase14_rank is not None:  # one rank of phase 14 (b)'s world
        _p14_worker(torch, args.phase14_rank, args.phase14_dir)
        return
    km = _import_port()
    from keymorph_tpu_torch import _build

    km.disable_tf32()
    dev = torch.device("cuda", 0)
    from keymorph_tpu_torch.tools import card

    smi = card()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase0 {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"kernel build {build_s:.3f} s")
    if args.plant_fault:
        fault_control(torch, dev, args.plant_fault)
        return

    from keymorph_tpu_torch.ops import cuda as kernels

    rng = np.random.default_rng(SEED)
    kernels.reset_counters()
    with torch.no_grad():
        k1 = phase1(torch, rng, dev)
    phase1_counts = kernels.counters()
    torch.cuda.empty_cache()

    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights

    gen = torch.Generator().manual_seed(SEED)
    net = KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **UNET), gen),
                      NUM_KEYPOINTS).to(dev).eval()
    pairs = _make_pairs(torch, rng, dev)
    with torch.no_grad():  # serving keeps nothing for a backward
        outs, serve_counts, serve_times = phase2(torch, net, pairs)
        phase3(torch, net, pairs, outs)
        phase4(torch, net, pairs)
    del outs
    torch.cuda.empty_cache()

    first, train, train_counts = phase5(torch, rng, dev)
    phase6(torch, rng, dev, first)
    torch.cuda.empty_cache()
    phase8(torch, train)
    del train
    torch.cuda.empty_cache()
    phase7(torch, net, pairs)
    torch.cuda.empty_cache()
    with torch.no_grad():
        api_counts = phase9(torch, rng, dev, net, pairs)
    del pairs
    torch.cuda.empty_cache()
    api_train_counts, held = phase10(torch, rng, dev, first)
    del first
    if not all(held.values()):
        raise AssertionError(f"phase 10: kernel and plain training steps disagree: "
                             f"{[k for k, ok in held.items() if not ok]}")
    del net
    torch.cuda.empty_cache()
    register_counts, reg_dir = phase11(torch, dev)
    torch.cuda.empty_cache()
    run_counts = phase12(torch, np.random.default_rng([SEED, 12]), dev)
    torch.cuda.empty_cache()
    parts_counts = phase13(torch, dev)
    torch.cuda.empty_cache()
    parallel_counts = phase14(torch, dev)
    torch.cuda.empty_cache()
    # a volume's steady extraction: phase 2's pairs 1 and 2 extract two volumes each
    extract_s = float(np.mean([t[0] for t in serve_times[1:]])) / 2
    try:
        tools_counts = phase15(torch, dev, reg_dir, extract_s)
        torch.cuda.empty_cache()
        entry_counts = phase16(torch, dev, reg_dir)
    finally:
        import shutil

        shutil.rmtree(reg_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    trained_counts = phase17(torch, dev)
    torch.cuda.empty_cache()
    resunet_counts = phase18(torch, dev)

    def entry(name, key, source):
        # launches: over every main path, each counted from 0 just before it
        # and read just after (phase 2's 3 pairs, phase 5's 3 steps, phase
        # 9's registration API, phase 10's three steps, phase 11's register
        # CLI, phase 12's CLI runs, kernel steps, 'cr' heatmaps and other
        # backbones' steps, phase 13's extraction at an IXI scan's native
        # grid, where the parts form runs; phase 14's parallel paths, over its
        # world of 1 and both ranks of its world of 2; phase 15's tools and
        # panels; phase 16's bench, entry, dry-run ranks and example; phase
        # 17's training run and its served pairs; phase 18's residual net).
        # Phase 1's launches are kept apart.
        paths = {"launches_served_3_pairs": serve_counts, "launches_3_train_steps": train_counts,
                 "launches_phase9_api": api_counts, "launches_phase10_steps": api_train_counts,
                 "launches_phase11_register": register_counts,
                 "launches_phase12_run": run_counts, "launches_phase13_parts": parts_counts,
                 "launches_phase14": parallel_counts, "launches_phase15_tools": tools_counts,
                 "launches_phase16": entry_counts, "launches_phase17": trained_counts,
                 "launches_phase18_resunet": resunet_counts}
        per_path = {k: c[name]["launches"] for k, c in paths.items()}
        return {"name": name, "route": "cuda", "source": f"keymorph_tpu_torch/csrc/{source}",
                "replaces": REPLACES[key], "launches": sum(per_path.values()), **per_path,
                "launches_phase1": phase1_counts[name]["launches"], **k1[name]}

    print(smi)
    print(json.dumps({"kernels": [
        entry("conv3x3_fused_flat", "conv", "conv3d.cu"),
        entry("conv3x3_fused_flat_upconv", "conv", "conv3d.cu"),
        entry("conv3x3_fused_flat_parts", "conv", "conv3d.cu"),
        entry("conv3x3_input_grad", "conv_grad", "conv3d.cu"),
        entry("conv3x3_weight_grad", "conv_wgrad", "conv3d.cu"),
        entry("tps_planes", "tps", "tpsflow.cu"),
        entry("tps_flow", "tps", "tpsflow.cu"),
        entry("tps_planes_bwd", "tps_bwd", "tpsflow.cu"),
        entry("warp_planes", "warp", "resample3d.cu"),
        entry("warp_planes_grad", "warp_grad", "resample3d.cu"),
        entry("conv3x3_fused_flat_res", "resblock", "conv3d.cu"),
        entry("conv_transpose3x3s2_flat", "tconv", "conv3d.cu"),
        entry("lift1x1_flat", "resblock", "resblock.cu"),
        entry("scse_gate_flat", "scse", "resblock.cu"),
        entry("maxpool2_flat", "pool", "resblock.cu"),
        entry("heatmap_com", "head", "heatmap.cu"),
        entry("final_conv1x1", "final", "heatmap.cu"),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
