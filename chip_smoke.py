#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dgtd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card (``nvidia-smi`` name and power limit); build every CUDA
     kernel of the served and trained paths from ``dgtd_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together);
  2. hold the diffusion-stencil forward kernels against their plain PyTorch
     version (k in {1, 3, 7}; 12x12 and 13x20, which take the fused kernel,
     all 4 steps in one launch; 64x64 and 23x23, above the fused limit,
     which take the cluster kernel, all 4 steps in one launch of a thread
     block cluster a plane; 96x96, beyond the cluster's reach, which takes
     the tiled kernel, all 4 steps in one launch over tiles of the plane
     with a recomputed halo; P = 192 planes, 48 at 96x96; fp32 and bf16),
     then the tiled kernel's own planes (TILED_CHECKS: (192,96,96),
     serving_check's (24,512,512) in bf16, the kernel9 and kernel11
     ablations' (192,12,12) and (240,12,12), a 1-row plane wider than a
     tile, planes that are not multiples of their tiles, 6 steps), each
     case's launches read from the kernel's own counter;
  3. serve full-width ``cod`` (PVTv2-b2 + ConvNeXt-B, seeded random weights)
     at 384², batch 8, through ``dgtd_tpu_torch.predict.main`` with a saved
     ``.pth``: once in bf16, once with ``--fp32``. The kernels' launch counts
     are reset just before each run and read just after (one fused forward a
     batch; one LayerNorm kernel launch for each of the 93 LayerNorm calls
     of a batch, counted by a forward hook); masks are checked, bf16 is held to fp32, and the fp32 model on
     the card to the same model on the CPU on a small input;
  4. re-check the fused kernel against the plain version on the exact
     ``MessagePassing`` inputs captured during phase 3;
  5. time the fused kernel per call (CUDA events; through the autograd
     Function and the launch wrapper alone beside it), the per-step kernels
     on the same tensors, the plain version, and served batches;
  6. hold the stencil's backward kernels (fused, cluster, tiled) against
     the plain backward (the same cases at P = 240, 48 at 96x96, fp32 and
     bf16; the tiled kernel's planes at 1 step and at their step count) and
     the autograd Function's 4-step backward (one fused launch each way)
     against autograd through the plain forward;
  7. tiny ``cod``: loss and every parameter gradient, fp32 on the card (TF32
     off) against the CPU, same weights and inputs, drop-path rates 0, at
     grid 8 (fused kernels), grid 64 (cluster kernels) and grid 96 (tiled
     kernels), one launch each way, read from their counters;
  8. train full-width ``cod`` through ``dgtd_tpu_torch.train.cli.main`` with
     ``configs/cod.yml`` (384², batch 10, bf16 autocast) on 30 synthetic
     images for 2 epochs (6 steps), validating after epoch 2 on 8 synthetic
     images at batch 1: finite losses, one val record with finite E, F, S
     and MAE, the launch counts (one fused forward and one fused backward a
     step launched from the host: the eager warm-up and the CUDA graphs'
     capture, the other 4 steps replays; 8 fused forwards and no backward
     around the val pass alone), two
     epoch checkpoints, the second served through ``predict.main``; one fp32
     first step held to the bf16 one; the backward kernel re-checked on the
     stencil inputs and upstream gradient captured in a train step; both
     loaders decode on the recipe's 8 threads and prefetch;
 8b. a train CLI subprocess (tiny ``cod`` at grid 12, bf16) with
     ``ProfilerHook`` on steps [2, 4) gets SIGTERM once its log shows step
     3: it saves ``preempt_step_N`` and exits 0, its trace names the fused
     stencil kernels, and ``--resume`` of the checkpoint finishes the epoch;
  9. time train steps back to back (bf16 and fp32), the CLI loop, peak
     memory, and the fused backward kernel (CUDA events and device time)
     against its bound, the per-step kernels and its plain version;
 10. hold the three multi-scale deformable attention kernels (forward,
     dValue, dLocation/dWeight) against their plain versions: channels
     {30, 32, 64, 71, 1025, 2048, 3096} on two small levels and the 4-level
     layout, then the other routes of their plans (some levels staged in
     shared memory, none staged, an Lq that the query chunks do not divide,
     and value and gradient one element off a 16-byte boundary, which takes
     the scalar route; dValue on its own plan of fp32 accumulator rows),
     fp32 and bf16 value, locations off the levels and on integer pixel
     coordinates;
 11. train the ``MSDeformAttn`` layer at Deformable DETR's encoder width
     (d_model 256, 8 heads, 4 levels of 64²/32²/16²/8², 4 points; N = 2,
     Lq = S = 5440; seeded weights): 4 forward+backward iterations on
     distinct seeded reference points with each kernel's launch count read
     around them; the first iteration's output and every gradient held to
     the same layer on the CPU; a bf16-autocast iteration; the op, each
     kernel and its plain version timed at the captured tensors; the
     three kernels held to their plain versions and timed on two location
     sets, the captured random reference points
     and Deformable DETR's encoder grid (each level's pixel centres, a
     query's own point on every level, the layer's own offsets), in fp32
     and bf16; the reference's per-level ``F.grid_sample`` composition
     timed as a yardstick;
 12. the NHWC stencil on tap-major weights: its forward kernels against
     the plain version (the phase-2 grids, B = 8, C = 24, fp32 and bf16:
     the plane kernel where a block holds the plane and its w, the grid
     kernel elsewhere, both all the steps of a call in one launch; k = 13
     on the per-step kernel, one launch a step), each case's launches read
     from the kernels' own counters; its gradient (one plane-kernel
     launch, one fused plane backward launch) against autograd through the
     plain version; its time at the served stencil's work (8,12,12,24;
     the plane kernel), at the grid-96 stencil's (8,96,96,24) and at
     serving_check's (1,512,512,24) (the grid kernel), beside the per-step
     kernel called directly on the same tensors, and the per-step kernel
     on its own route (k = 13);
 13. the LayerNorm kernel against its plain version on each of its routes
     (``ops/layernorm.py::ln_route``, also asked of the built kernel): C in
     {8, 24, 64, 128, 256, 512, 1024} on the lane-group route (16-byte
     accesses, a row on 1 to 32 lanes), C = 130 and every C one element off
     a 16-byte boundary (``x[1:]`` of a flat buffer) on the scalar route,
     C = 2048 on the block route; fp32 and bf16, mean-0 and mean-100 rows;
     the models' ``LayerNorm`` (and ``LayerNorm2d``) under
     ``inference_mode`` at the served cells' shapes, bf16: PVTv2-b2 stage 1
     at batch 128, ConvNeXt-B stage 1 at batch 64 on the permuted NCHW map,
     ViT-L at batch 32, one launch a call, held to the plain version; then
     forward and backward at a PVTv2-b2 stage-1 and a ConvNeXt-B
     stage-1 shape of a served batch (bf16), timed L2-warm (one input back
     to back) and L2-cold (8 input/output pairs in turn, more bytes than the
     L2), ``F.layer_norm`` timed both ways beside it (device times in phase
     18);
 14. planes above the fused limit: the op forward and backward on
     (192, 64, 64) planes (the paper's grid-64 ablation), one cluster launch
     each way read from the counters, checked against the plain versions,
     timed in bf16 and fp32 beside the per-step kernels called directly on
     the same tensors; the cluster occupancy at 8 blocks and at a
     non-portable 16; then the tiled kernels on (192, 96, 96) planes beyond
     the cluster's reach (bf16 and fp32) and on serving_check's
     (24, 512, 512) (bf16), one launch each way, checked and timed the same
     way beside the per-step kernels on the same tensors, in bf16 at 4 steps
     and at 1 (one tiled launch beside one per-step launch each way);
 15. ``cod`` at ``grid=64``: served through ``dgtd_tpu_torch.predict.main``
     with ``-o grid=64`` (bf16, batch 8; one cluster forward a batch) and
     trained through ``dgtd_tpu_torch.train.cli.main`` with
     ``-o model.grid=64`` (2 steps at batch 10, bf16; one cluster forward and
     one cluster backward a step), the launch counts read around each run;
     the cluster forward re-checked on the served stencil inputs; fp32 on the
     card held to the CPU on a small input; served ms per batch and train ms
     per step at grid 64 and grid 12 in turns; then ``cod`` at ``grid=96``
     the same way (one tiled forward a served batch, one tiled forward and
     one tiled backward a train step), the tiled kernels re-checked on the
     served and trained stencil tensors;
 16. the val pass: full-width ``cod -m val`` through
     ``dgtd_tpu_torch.test.main`` (``configs/cod.yml``, bf16, ``val_ckpt`` =
     phase 8's ``epoch_2.pth``) on a SOD_TEST PNG tree of 16 images of mixed
     sizes at 384², batch 1: the device-stats route against
     ``device_metrics=false`` (every metric within rtol 1e-4 / atol 1e-6),
     ``batch_statistics`` on the card against the host algorithms on a
     captured batch (histograms and counts equal), ``save_visualizations``
     on 4 images (five PNGs each, named from the files), one fused forward a
     val batch and nothing else from the stencil, one 704² image through
     COD_TEST; the serial loader (``num_workers: 0``, ``prefetch: 0``)
     giving the same per-image statistics as the recipe's 8 decode threads
     with prefetch, and ``pipeline: native`` (the fused C++ pixel pipeline:
     its input equal to the library's on the host); images/s and ms an
     image by part for each run;
 17. model variants: the model family at full width (PVTv2-b2, the
     ConvNeXt-B tower where there is one), 384², bf16: ``baseline``,
     ``DQnet``, ``cod -o model.use_prompts=false``, ``cod -o
     model.diffusion_kernel=11`` (the tiled kernels at the recipe's 12x12
     grid, one tile a plane, 1 + 1 launches a step), ``cod -o
     model.diffusion_kernel=13`` (beyond the tiled kernels' templates: the
     per-step kernels, 4 + 4 launches a step), ``cod -o model.diffusion_kernel=3 -o
     model.diffusion_steps=6`` (the fused kernels at k = 3) and ``cod -o
     model.fft_at_grid=true -o model.use_ssim=false``, each trained 2 steps at
     batch 10 through the Runner and served 1 batch of 8 through
     ``dgtd_tpu_torch.predict.main --model``, the stencil launches of each
     run read from the counters (none for baseline, DQnet and
     use_prompts=false), with its parameter count, ms per served batch and
     train step, and peak memory; baseline's frozen prompt modules bit-equal
     after its steps; the tiled kernels at k = 9 and 11, the fused kernel at
     k = 3, 6 steps and the per-step kernels at k = 13 against their plain
     versions on (240, 12, 12) planes, fp32 and bf16; the tiled kernels on
     the kernel11 run's own tensors, timed beside the per-step kernels, and
     the per-step kernels on the kernel13 run's own tensors, timed;
     ``remat`` against no remat (same weights, batch and DropPath
     generator: loss and every gradient, peak memory of both); tiny
     baseline and DQnet, fp32 on the card against the CPU;
 18. the device time per call of every stencil kernel timed in phases 5, 9,
     12, 14 and 17, of every MSDA kernel timed in phase 11 and of the
     LayerNorm kernel timed in phase 13, from ``torch.profiler`` (after
     the in-process phases, so that its tracing cannot slow their
     host-bound timings);
 19. data parallelism, in processes of their own: full-width ``cod`` at the
     recipe (384², global batch 10, ``configs/cod.yml``'s optimizer), fp32
     with TF32 off, 2 train steps in one process and on 2 gloo ranks of the
     card (5 rows each; NCCL refuses two ranks on one GPU) from the same
     seed and synthetic batches: each step's loss, the parameters and the
     BatchNorm statistics after step 2 held to the one-process run, the
     ranks bit-equal, one fused stencil forward and one backward a step on
     each rank; then 2 bf16 steps on the ranks, ms a step and the seconds
     of the gradient all-reduce;
 20. the train CLI under ``torchrun --standalone --nproc_per_node=1`` (one
     NCCL rank, ``configs/cod.yml``, 2 steps at batch 10 on synthetic
     data): its ``log.jsonl`` (the ``dist`` record, finite losses), its
     ``epoch_1.pth`` loaded into the model;
 21. ``parallel/spatial.py::spatial_diffusion`` on 2 gloo ranks of the card
     (k = 7, 4 steps, fp32 and bf16) against the unsharded
     ``diffusion_planes`` on the same tensors: x (1,512,512,24), whose
     halo'd shards take the tiled kernel, (8,64,64,24) the cluster kernel
     and (8,12,12,24) the fused kernel, one launch a step a shard; the halo
     exchange's and one stencil step's ms apart;
 22. the offline depther at full width: DINOv2 ViT-L/14 + the DPT head's
     classify head (256 bins), seeded weights written as the release's two
     ``.pth`` files (the backbone's official keys with ``mask_token``, the
     head under ``state_dict`` with ``decode_head.`` keys) and loaded back
     strictly; fp32 on the card (TF32 off) against the CPU on a 100x130
     input (centre padding, pos-embed interpolation) within 1e-3 of the
     depth's range; bf16 against fp32 at 518² within 5% (largest) and 1%
     (mean) of the fp32 depth's range; ``python -m
     dgtd_tpu_torch.tools.depth_gen --estimator dinov2 --arch vitl14
     --long-side 518 --render gray`` (``main()``, bf16, on the card) twice
     over 8 written PNGs of mixed sizes: 8 maps of their sources' sizes,
     images/s, ms an image by part (decode, backbone, head, write) and peak
     memory of the second run;
 23. ``dgtd_tpu_torch/tools/serving_check.py`` with its defaults: full-width
     ``cod`` at 704² and 1024² (bf16, batch 1; the fused kernel) and the
     512² diffusion block's plain, NHWC-wrapper and planes legs (the tiled
     kernel), each kernel leg within the stencil's bf16 bar of the plain
     one; the launch counters reset just before and read just after;
 24. ``tools/export_serving.py``: bundles of full-width ``cod`` at 384²
     (bf16, then fp32) exported with ``torch.export`` (the stencil a
     ``dgtd_torch::`` custom op), loaded by ``ServingModel`` and served at
     384² and at 352x480 (resized to the bucket and back): each within
     BF16_ATOL (fp32: FP32_TOL, TF32 off) of eager ``predict`` on the same
     inputs, one fused forward a call; eager predict and the bundle's
     program timed at batch 1; export seconds and bytes on disk;
 25. a ``DQnet`` bundle (PVT b1, b2's widths at a cut depth) within
     BF16_ATOL of eager; the ``MSDeformAttn`` layer at the encoder width
     exported, saved, loaded and run: one MSDA forward launch, equal to the
     eager layer;
 26. full-width ``cod`` under ``core.flags.diffusion_plane_layout=False``
     (the NHWC plane kernel forward, the fused plane backward) against True:
     a served batch of 8 within twice the planes' own bf16-vs-fp32 gap (at
     the largest, at least BF16_ATOL, and on average), a train step's loss
     within FIRST_LOSS_RTOL, each layout's launches counted; both timed in
     turns;
 27. full-width ``cod`` served under the data×space layout
     (``parallel/space.py``: every activation H-banded over the space
     ranks) by gloo ranks of the card against one process on the same
     weights and inputs: 384², batch 8, at (data, space) = (1, 2) and
     (2, 2), and 1024², batch 1, at (1, 2), each in fp32 (TF32 off; within
     SPACE_FP32_ATOL) and bf16 (within twice one process's own
     bf16-vs-fp32 gap, at least BF16_ATOL): ms a batch a rank, peak memory
     a rank beside one process's, the layout's counts and bytes, the
     stencil launches a rank (one fused forward a step on the halo'd
     band), and the fused kernel held to its plain version on a captured
     halo'd band; then its train leg in the same rank processes: 2 AdamW
     steps of full-width ``cod`` (seed 0's weights, ``configs/cod.yml``'s
     optimizer, 384², batch 10) under (1, 2) and (2, 2), fp32 (TF32 off)
     and bf16, against one process on the same weights and batches: fp32
     losses within SPACE_TRAIN_LOSS_RTOL; every step-1 gradient, with
     cuDNN on both sides (and at (2, 2) also with ATen's native
     convolutions on both), within twice one process's own cuDNN-vs-native spread of its scale
     (at least SPACE_TRAIN_GRAD_RTOL); bf16 losses within twice one
     process's own bf16-vs-fp32 gap (at least BF16_ATOL); parameters and
     BatchNorm statistics bit-equal across the ranks; 4 fused stencil
     forwards and 4 fused backwards a step a rank (a step each way on the
     halo'd band); the fused backward held to its plain version on a
     captured halo'd band; ms a step a rank, peak memory a rank, the
     counts and bytes of the forward's and the backward's exchanges; then
     its DQnet leg in the (1, 2) rank processes: full-width ``DQnet``
     (PVTv2-b2, channel 32, cross_size 44, seed 0) against one process on
     the same weights and inputs, served at 384², batch 8, in fp32 (within
     SPACE_FP32_ATOL) and bf16 (within twice one process's own
     bf16-vs-fp32 gap, at least BF16_ATOL), and trained SPACE_TRAIN_STEPS
     fp32 AdamW steps at batch 10 (``configs/cod.yml``'s optimizer with the
     lr key on DQnet's ``backbone``): the losses within
     SPACE_TRAIN_LOSS_RTOL, then one fp32 step with cuDNN off: the step-1
     gradients, with cuDNN on both sides and with ATen's native
     convolutions on both, within twice DQnet's own one-process
     cuDNN-vs-native spread of their scale (at least
     SPACE_TRAIN_GRAD_RTOL), the ranks bit-equal, no stencil, NHWC or MSDA
     launch; ms a batch and a step a rank, peak memory, counts and bytes.

Prints a ``kernels`` JSON line (the counterparts of the JAX package's seven
Pallas kernels, the plane stencil's forward and backward as the fused, the
cluster, the tiled and the per-step kernels; the tiled kernels' launches
are those of cod at grid 96 and of the kernel11 variant, the per-step
kernels' those of the kernel13 variant; the three MSDA rows carry their
plan, bf16 and encoder-grid times; the NHWC rows are the plane kernel
and the grid kernel, each with its device ms and the per-step kernel's ms
on the same tensors, and the per-step kernel on its own route), a
served-throughput line, a ``trained``, a ``grid64``,
a ``val``, a ``variants``, an ``msda``, a ``data_parallel``, a
``spatial``, a ``depther``, a ``serving_check``, a ``bundle``, a
``dqnet_bundle``, a ``layout`` and a ``space`` JSON line, each with the
card's name and power limit (the fused rows of ``kernels`` also carry
phase 19's launches, the fused, cluster and tiled forward rows phase 21's,
the fused and tiled forward rows phase 23's, the fused forward row phase
24's and 27's, the MSDA forward row phase 25's, the NHWC plane row and the
fused backward row phase 26's);
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""

import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNEL, STEPS, P_MAIN = 7, 4, 8 * 24  # served stencil: k=7, 4 steps, B·C planes
P_TRAIN = 10 * 24  # train stencil: batch 10 x 24 latent channels
# 12x12 (the recipe's grid) and 13x20 take the fused kernels; 64x64 (the
# paper's grid-64 ablation, where the JAX package turns to Pallas) and 23x23
# (529 pixels, just above the fused limit) the cluster ones; 96x96 (beyond a
# cluster of 8 blocks of 512 pixels) the tiled ones
SHAPES = [(k, hw) for k in (1, 3, 7) for hw in ((12, 12), (13, 20), (64, 64), (23, 23), (96, 96))]
# the NHWC stencil's per-step route (k = 13, beyond the plane and grid kernels' k),
# driven beside SHAPES in phase 12
NHWC_PER_STEP_SHAPES = [(13, (12, 12)), (13, (23, 23))]
# the NHWC kernel's timed shapes (B, H, W, C): the served stencil's work
# (B = 8, C = 24 on the recipe's 12x12), the grid-96 stencil's, and
# dgtd_tpu/tools/serving_check.py's diffusion block (w 617 MB in bf16)
NHWC_SHAPES = {"served": (8, 12, 12, 24), "grid96": (8, 96, 96, 24), "serving_check": (1, 512, 512, 24)}
GRID64 = (64, 64)  # the cluster kernels' main path (phases 14, 15)
LARGE = (96, 96)  # the tiled kernels' main path (phases 14, 15)
P_LARGE = 48  # planes of the 96x96 checks in phases 2 and 6, to keep their time
# dgtd_tpu/tools/serving_check.py's diffusion block: C = 24 planes of a 512²
# grid, k = 7, 4 steps (w 617 MB in bf16)
SERVING_P, SERVING_GRID = 24, (512, 512)
# the tiled kernels' checks in phases 2 and 6: (P, (H, W), k, steps, bf16
# only); P None takes the phase's own P (192 forward, 240 backward).
# Beyond a cluster's reach, serving_check's plane, the kernel9 and kernel11
# ablations' planes, a 1-row plane whose row is wider than a tile, planes
# that are not multiples of their tiles, and 6 steps
TILED_CHECKS = [
    (None, LARGE, 7, STEPS, False), (SERVING_P, SERVING_GRID, 7, STEPS, True),
    (P_MAIN, (12, 12), 9, STEPS, False), (P_MAIN, (12, 12), 11, STEPS, False),
    (P_TRAIN, (12, 12), 9, STEPS, False), (P_TRAIN, (12, 12), 11, STEPS, False),
    (None, (1, 4096), 7, STEPS, False), (None, (100, 75), 7, STEPS, False), (None, (17, 241), 5, STEPS, False),
    (None, LARGE, 7, 6, False), (None, (4097, 1), 11, 6, False),
]
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
# per-step bf16 rounding of O(1) convex combinations: each rounding under
# 2^-9, so s steps drift up to s·2^-9 (tests/test_torch_kernels.py::bf16_atol)
BF16_ATOL = 1e-2
MEAN_ATOL = 2e-3  # bf16 vs fp32 mean probability (tests/test_golden_forward.py)
CPU_PROB_ATOL = 1e-3  # fp32 card vs fp32 CPU, TF32 off, full-width model
N_IMAGES, BATCH, SIZE = 20, 8, 384  # 3 batches, the last padded from 4
# backward, fp32: dx is a 49-term sum in another order than F.fold's, dw an
# exact product (one step) or a 4-term sum
BWD_FP32_TOL = dict(rtol=1e-5, atol=1e-6)
# backward, bf16: both sides sum in fp32 and round to bf16, so a rounding
# can flip one ulp (2^-7 relative); the chains also round dx after each step
BWD_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
# autograd through the plain bf16 forward rounds dw after every step (4
# roundings of the partial sums) where the kernel rounds once
AUTOGRAD_BF16_TOL = dict(rtol=3.2e-2, atol=1e-2)
# tiny cod, fp32 card (TF32 off) vs CPU: the loss to 1e-5, each gradient to
# 1e-3 of its largest entry (cuDNN and MKL sum in other orders; the CPU port
# agrees with the JAX package to ~1e-5 of each gradient's scale)
TINY_LOSS_RTOL, TINY_GRAD_RTOL = 1e-5, 1e-3
TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2, drop_path_rate=0.0, convnext_drop_path_rate=0.0)
# full-width training run: 30 images, the recipe's batch 10, 2 epochs
TRAIN_N, TRAIN_BATCH, TRAIN_EPOCHS = 30, 10, 2
TRAIN_STEPS = TRAIN_EPOCHS * (TRAIN_N // TRAIN_BATCH)
# phase 15: cod at grids 64 and 96 trained one epoch of GRID_TRAIN_N images
GRID_TRAIN_N = 2 * TRAIN_BATCH
TRAIN_VAL_N = 8  # val after epoch 2: 8 synthetic images at batch 1
TRAIN_WORKERS = 8  # configs/cod.yml's train_dataloader.num_workers, in force in phase 8
# phase 8b: tiny cod at the recipe's grid 12 through a train CLI subprocess,
# one epoch of PREEMPT_N // PREEMPT_BATCH steps, SIGTERM after step 3
PREEMPT_N, PREEMPT_BATCH, PREEMPT_SIZE, PREEMPT_TIMEOUT_S = 12, 2, 96, 300
PREEMPT_MODEL = {"variant": "tiny", "convnext_dims": "[8,16,32,64]", "convnext_depths": "[1,1,1,1]",
                 "channel": 8, "latent_dim": 8, "grid": 12}
VAL_METRICS = ("Emeasure", "Fmeasure", "Smeasure", "MAE")
# the val phase: a SOD_TEST tree of 16 images, sizes cycling through these
VAL_N = 16
VAL_WORKERS = 8  # configs/cod.yml's val_dataloader.num_workers
VAL_SIZES = [(384, 384), (480, 640), (300, 420), (512, 512), (720, 540), (333, 500)]
# device-stats route vs host route (tests/test_metrics.py:221); the card's
# S-measure vs the host's float64 (tests/test_metrics.py:194)
VAL_ROUTE_TOL = dict(rtol=1e-4, atol=1e-6)
VAL_SM_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 autocast vs fp32 first-step loss (same weights, batch, drop-path
# masks): the served bf16 mean probability moved 5e-5 from fp32, the loss
# sums ~6 such terms; 1e-2 relative leaves room for the logits' bf16 error
FIRST_LOSS_RTOL = 1e-2
# the model-variants phase (17): the registered models and ablation axes
# at full width, each trained VARIANT_STEPS steps at TRAIN_BATCH through the
# Runner and served VARIANT_SERVE images at BATCH through predict.main
K11 = 11  # the kernel11 ablation: the tiled kernels at the recipe's 12x12 grid, one tile a plane
K13 = 13  # beyond the tiled kernels' templates: the per-step kernels' own path
VARIANTS = [  # (label, model.type, the model's -o overrides)
    ("baseline", "baseline", {}),
    ("DQnet", "DQnet", {}),
    ("pure_hitnet", "cod", {"use_prompts": False}),
    ("kernel11", "cod", {"diffusion_kernel": K11}),
    ("kernel13", "cod", {"diffusion_kernel": K13}),
    ("kernel3_steps6", "cod", {"diffusion_kernel": 3, "diffusion_steps": 6}),
    ("fft2", "cod", {"fft_at_grid": True, "use_ssim": False}),
]
VARIANT_STEPS, VARIANT_SERVE = 2, 8
VARIANT_HOOKS = {"cod": "our_init", "baseline": "baseline_init", "DQnet": "PretrainInitHook"}
# configs/cod.yml's lr keys name the prompt tower; a model without one takes
# the backbone's multiplier alone (an unmatched key raises, as in dgtd_tpu)
VARIANT_LR_KEYS = {"DQnet": "{'backbone': {'lr_mult': 0.2}}", "pure_hitnet": "{'hitnet.backbone': {'lr_mult': 0.2}}"}
# remat vs no remat, bf16 autocast on the card, same weights, batch and
# masks: the loss within FIRST_LOSS_RTOL; the gradients within this factor
# of the spread between two runs without remat. That spread is the card's
# own: atomic reductions in the backward (PyTorch documents the CUDA
# backward of bilinear interpolation and of index_select as
# nondeterministic) sum in another order each run, so two runs without
# remat differ too (the ``variants`` line prints both spreads)
REMAT_NOISE_FACTOR = 1.5
# phase 19: data parallelism at full width, DP_RANKS gloo ranks on the one
# card (NCCL refuses two ranks on one GPU) against one process, DP_STEPS
# steps at the recipe's global batch, fp32 with TF32 off
# (tests/test_torch_train.py's bars for AdamW steps): the loss to 1e-4
# relative, the BatchNorm statistics and the parameters to rtol 1e-4 / atol
# 1e-5, except a share of at most DP_FAR_SHARE of the parameters' entries that
# Adam's first steps move by up to lr a step the other way on a near-zero
# gradient (within DP_STEPS·2·lr); then DP_STEPS bf16 steps on the ranks, timed
DP_RANKS, DP_STEPS = 2, 2
DP_LOSS_RTOL, DP_TOL, DP_FAR_SHARE = 1e-4, dict(rtol=1e-4, atol=1e-5), 1e-3
DP_BN_KEYS = ("running_mean", "running_var", "num_batches_tracked")
# phase 20: the train CLI under torchrun, one rank on NCCL, 2 steps
TORCHRUN_N, TORCHRUN_TIMEOUT_S = 2 * TRAIN_BATCH, 600
# phase 21: spatial_diffusion on SPATIAL_RANKS gloo ranks of the card against
# the unsharded op: docs/SERVING.md's diffusion block (the halo'd 262x512
# shard takes the tiled kernel at one step), a grid-64 batch (38x64: the
# cluster kernel) and the recipe's grid-12 batch (12x12: the fused kernel);
# k = 7, 4 steps, C = 24, fp32 and bf16 at PERF.md §2's stencil bars
SPATIAL_RANKS = 2
SPATIAL_CASES = (((1, 512, 512, 24), "tiled"), ((8, 64, 64, 24), "cluster"), ((8, 12, 12, 24), "fused"))
# H100 SXM peaks: HBM bytes/s; fp32 non-tensor FLOP/s
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12
SOURCES = ["diffusion_stencil", "diffusion_stencil_bwd", "msda_fwd", "msda_bwd", "layernorm"]
# MSDA kernel checks: tests/test_msda.py's channel widths on its two small
# levels, and the 4-level layout of its backward test
MSDA_CHANNELS = (30, 32, 64, 71, 1025, 2048, 3096)
MSDA_SMALL = ((6, 4), (3, 2))
MSDA_FOUR = ((8, 8), (4, 4), (2, 2), (1, 1))
# the stage's routes beyond those: some levels staged (the 32x32 level too
# large at 128 channels), none staged (3096 fp32 channels on two levels that
# each pass a block's shared memory), an Lq that the chunks do not divide
MSDA_STAGING = ((128, ((32, 32), (8, 8), (4, 4)), dict(lq=70, m=4, p=4)),
                (3096, ((6, 4), (5, 4)), dict(lq=40)),
                (32, MSDA_FOUR, dict(lq=157, m=8, p=4)))
# tests/test_msda.py's tolerances (forward and dValue atol 1e-6, dLocation
# 1e-5, dWeight 1e-6, rtol 1e-4); a bf16 output one bf16 ulp (kernel and
# plain both sum in fp32 and round once)
MSDA_TOL = {"out": dict(rtol=1e-4, atol=1e-6), "dvalue": dict(rtol=1e-4, atol=1e-6),
            "dloc": dict(rtol=1e-4, atol=1e-5), "daw": dict(rtol=1e-4, atol=1e-6)}
MSDA_BF16_OUT_TOL = dict(rtol=2 ** -7, atol=1e-6)
# at the encoder layer's own tensors value is O(1) (value_proj of N(0, 1)
# inputs), not [0, 0.01): the channel sums that cancel (dLocation, dWeight)
# keep fp32 rounding of ~1e-7 of the sum of their |terms|, and dLocation
# carries a factor W_l = 64; there each output is held to 1e-6 of its
# largest entry where that exceeds the atol above
MSDA_SCALE_ATOL = 1e-6
# the encoder layer: tools/revalidate_onchip.py's MSDA configuration
ENC_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
ENC_N, ENC_D_MODEL, ENC_HEADS, ENC_POINTS, ENC_ITERS = 2, 256, 8, 4, 4
ENC_S = sum(h * w for h, w in ENC_SHAPES)  # = Lq = 5440
LAYER_RTOL = 1e-4  # card vs CPU, each tensor to 1e-4 of its largest entry
# the card's and the CPU's sampling locations (normalised): cuBLAS and MKL
# may round the offsets' linear differently, a few fp32 ulps of O(1)
# values (1.2e-7 each); 1e-6 is 6.4e-5 of a pixel at the 64-wide level, so
# the pin of the CPU run to the card's locations absorbs rounding only
LOC_PIN_ATOL = 1e-6
# LayerNorm: the same fp32 two-pass arithmetic in another order, at
# tests/test_layernorm_pallas.py's rtol 1e-4 / atol 1e-5; on mean-100 rows
# the means differ by a few ulps of 100 (7.6e-6 each) times rstd·|scale|, so
# atol 1e-4; bf16 one ulp
LN_FP32_TOL = {0.0: dict(rtol=1e-4, atol=1e-5), 100.0: dict(rtol=1e-4, atol=1e-4)}
LN_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
LN_SHAPES = {"pvt_b2_stage1": (8 * 96 * 96, 64), "convnext_b_stage1": (8 * 96 * 96, 128)}
# the models' LayerNorm module at the served cells' shapes, as the models
# hold x (whether the module sees it permuted): PVTv2-b2 stage 1 at
# dqnet.serve.b128, ConvNeXt-B stage 1 at cod.serve.b64 (its blocks' NCHW
# dwconv output read channels-last, and LayerNorm2d), ViT-L at
# depther.vitl14.518
LN_MODULE_SHAPES = {"pvt_b2_stage1_b128": ((128, 96 * 96, 64), False),
                    "convnext_b_stage1_b64": ((64, 128, 96, 96), True),
                    "vit_l_b32": ((32, 1037, 1024), False)}
# LayerNorm calls in a served cod batch: PVTv2-b2 53, ConvNeXt-B 40
LN_SERVED_CALLS = 93
# phase 13's widths: the lane-group route at 1 to 32 lanes a row and 1 to 8
# 16-byte vectors a lane, C = 130 (a row not a multiple of 16 bytes: the
# scalar route) and 2048 (the block route); each also one element off a
# 16-byte boundary (the scalar route below 1025), on a row count that no
# block divides
LN_ROUTE_CS = (8, 24, 64, 128, 256, 512, 1024, 130, 2048)
LN_CHECK_ROWS = 1001
# L2-cold timing: input/output pairs in turn, 151 MB at (73728, 64) bf16
LN_ROTATION = 8
L2_BYTES = 50e6
# F.layer_norm's CUDA kernels (vectorized_layer_norm_kernel, or
# RowwiseMomentsCUDAKernel and LayerNormForwardCUDAKernel)
TORCH_LN_KERNELS = ("layer_norm", "LayerNorm", "RowwiseMoments")
# phase 22: the offline depther at full width (DINOv2 ViT-L/14 + the DPT
# head's classify head, 256 bins), seeded weights, through depth_gen at
# --long-side 518 over DEPTHER_SIZES (mixed sizes and aspects)
DEPTHER_ARCH, DEPTHER_BINS, DEPTHER_SIDE = "vitl14", 256, 518
DEPTHER_SIZES = [(480, 640), (640, 480), (518, 518), (375, 500), (720, 1280), (300, 300), (600, 800), (427, 640)]
# fp32 on the card (TF32 off) against fp32 on the CPU on a small input that
# takes centre padding (100x130 -> 112x140) and pos-embed interpolation
# (8x10 patches on the 37x37 grid): within this share of the depth's range
DEPTHER_CPU_HW, DEPTHER_CPU_REL = (100, 130), 1e-3
# bf16 autocast against fp32 at 518x518 (PERF.md §2): the largest
# difference within 5% of the fp32 depth's range and the mean within 1%
DEPTHER_BF16_MAX_REL, DEPTHER_BF16_MEAN_REL = 5e-2, 1e-2
# phase 23: dgtd_tpu_torch/tools/serving_check.py with its defaults
SERVING_SIZES, SERVING_CHECK_GRID = (704, 1024), 512
# phase 24: a serving bundle of full-width cod at the recipe's 384² (bf16,
# then fp32), served at the bucket and at a size that is not one (resized
# to the bucket and back, as jax.image.resize does)
BUNDLE_ODD_HW = (352, 480)
BUNDLE_ITERS = 10  # timed calls of eager predict and of the bundle's program
# phase 25: DQnet's bundle at a cut depth (PVT b1: b2's widths, depths
# (2, 2, 2, 2)); the MSDeformAttn layer exported at the encoder width, N=1
DQNET_BUNDLE_VARIANT = "b1"
# phase 26: full-width cod under core.flags.diffusion_plane_layout=False
# (the NHWC stencil) against True (the plane stencil): a served batch and a
# train step, each timed in turns (True, False, False, True)
LAYOUT_ITERS = 3
# phase 27: full-width cod served under the data×space layout
# (parallel/space.py) by gloo ranks of the card against one process on the
# same weights and inputs: (size, global batch, (data, space)); the recipe's
# 384² at 2 and 4 ranks, and docs/SERVING.md's 1024² configuration at one
# image on 2 ranks
SPACE_CASES = ((384, 8, (1, 2)), (384, 8, (2, 2)), (1024, 1, (1, 2)))
# fp32 (TF32 off) against one process: the bands compute each pixel as the
# whole level does but for the spatial means' order
SPACE_FP32_ATOL = 1e-4
SPACE_ITERS = 1  # timed batches a case and dtype
# phase 27's train leg: full-width cod, seed 0's weights, configs/cod.yml's
# optimizer at its 384² and batch of 10, SPACE_TRAIN_STEPS steps a dtype under
# each layout against one process on the same weights and batches
SPACE_TRAIN_LAYOUTS = ((1, 2), (2, 2))
SPACE_TRAIN_STEPS = 2
# fp32 (TF32 off): the loss as phase 19 holds 2 ranks to one process. Each
# step-1 gradient, with cuDNN on both sides and with ATen's native
# convolutions on both, within twice one process's own spread between the
# two of its scale, at least 1e-3 (PERF.md §2's gradient bar): a band is
# another shape than the whole level, both algorithms pick their fp32
# reductions by shape, and the layout's gap is of the size of that spread
# under either (PERF.md §6)
SPACE_TRAIN_LOSS_RTOL, SPACE_TRAIN_GRAD_RTOL = 1e-4, 1e-3
CONV_NAMES = {"cudnn": "cuDNN's", "native": "ATen's native"}
# the farthest parameters a gradient comparison lists
GRAD_GAP_TOP = 3
# the layout whose ranks also take a native fp32 step (both axes split)
SPACE_NATIVE_LAYOUT = (2, 2)
# phase 27's DQnet leg: full-width DQnet (b2, channel 32, cross_size 44,
# seed 0) served at SIZE², batch BATCH, and trained SPACE_TRAIN_STEPS fp32
# steps at TRAIN_BATCH under this layout; configs/cod.yml's lr keys name
# cod's towers, so DQnet takes phase 17's backbone key
DQNET_SPACE_LAYOUT = (1, 2)
DQNET_RECIPE_OVERRIDES = ["model.type=DQnet",
                          f"optim_wrapper.paramwise_cfg.custom_keys={VARIANT_LR_KEYS['DQnet']}"]


_START = time.perf_counter()


def say(*parts):
    """Print a line; a phase's first line carries the seconds since the
    script started."""
    if parts and str(parts[0]).startswith("phase "):
        parts = (f"[{time.perf_counter() - _START:.1f} s]",) + parts
    print(*parts, flush=True)


def check(ok, what):
    """A failed check ends the run with a non-zero exit (not ``assert``,
    which ``python -O`` would drop)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_time_ms(fn, iters, warmup=10):
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, match, per_launch=False):
    """Device time per call (ms) of the kernels whose name holds ``match`` (or
    any of a tuple of names),
    summed from ``torch.profiler``'s ``key_averages()`` over ``iters`` calls;
    None if the profiler recorded no such kernel. ``per_launch``: the mean
    over the launches it recorded instead, for a kernel launched once a
    call (the profiler may drop some of a run's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # the kernels, not the aten ops above them (whose device time is theirs)
    matches = (match,) if isinstance(match, str) else match
    found = [e for e in prof.key_averages() if not e.key.startswith("aten::") and any(m in e.key for m in matches)]
    us = sum(getattr(e, "device_time_total", 0.0) for e in found)
    if per_launch:
        iters = sum(e.count for e in found)
    return us / 1e3 / iters if us > 0 else None


#: the order of plane_launches' counters
LAUNCH_NAMES = "fused fwd, fused bwd, cluster fwd, cluster bwd, step fwd, step bwd, tiled fwd, tiled bwd"
NO_LAUNCHES = (0,) * 8


def plane_launches(D):
    """The plane stencil's launch counters: fused forward, fused backward,
    cluster forward, cluster backward, per-step forward, per-step backward,
    tiled forward, tiled backward."""
    return (D.FUSED_LAUNCHES, D.FUSED_BWD_LAUNCHES, D.CLUSTER_LAUNCHES, D.CLUSTER_BWD_LAUNCHES,
            D.LAUNCHES, D.BWD_LAUNCHES, D.TILED_LAUNCHES, D.TILED_BWD_LAUNCHES)


def reset_plane_launches(D):
    D.FUSED_LAUNCHES = D.FUSED_BWD_LAUNCHES = D.CLUSTER_LAUNCHES = D.CLUSTER_BWD_LAUNCHES = 0
    D.LAUNCHES = D.BWD_LAUNCHES = D.TILED_LAUNCHES = D.TILED_BWD_LAUNCHES = 0


def launch_tuple(route, n_fwd=0, n_bwd=0):
    """plane_launches' increments for n_fwd forward and n_bwd backward
    launches of one route's kernels."""
    add = [0] * 8
    slot = {"fused": 0, "cluster": 2, "per_step": 4, "tiled": 6}[route]
    add[slot], add[slot + 1] = n_fwd, n_bwd
    return tuple(add)


def expected_launches(D, shape, kernel, dtype, steps, bwd):
    """The counters' increments for one call of ``steps`` steps on planes
    of this (H, W): one fused, cluster or tiled launch, or one per-step
    launch a step."""
    route = D.plane_route(*shape, kernel, dtype, steps)
    n = steps if route == "per_step" else 1
    return launch_tuple(route, 0, n) if bwd else launch_tuple(route, n, 0)


def planes_for(hw, p):
    """P planes, or P_LARGE for the 96x96 planes."""
    return P_LARGE if hw == LARGE else p


def stencil_bound(x, w, kernel, steps):
    """Least time (ms) for ``steps`` stencil steps on these inputs: x and w
    read once, the output written once, over HBM; 2 flops per weight per step
    over the fp32 rate (the kernel accumulates in fp32 on the CUDA cores)."""
    nbytes = (2 * x.numel() + w.numel()) * x.element_size()
    flops = 2.0 * w.numel() * steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(D, x, w, kernel, steps, label):
    """Kernel vs plain on the same inputs, and the kernel the shape names
    launched as often as it should; returns the max abs error."""
    import torch

    before = plane_launches(D)
    out = D.diffusion_planes(x, w, kernel, steps)
    torch.cuda.synchronize()
    added = tuple(a - b for a, b in zip(plane_launches(D), before))
    want = expected_launches(D, x.shape[1:], kernel, x.dtype, steps, bwd=False)
    check(added == want, f"{label}: launches ({LAUNCH_NAMES}) {added}, expected {want}")
    label = f"{label} [{D.plane_route(*x.shape[1:], kernel, x.dtype, steps)}]"
    if x.dtype == torch.float32:
        ref = D.diffusion_planes_plain(x, w, kernel, steps)
        torch.testing.assert_close(out, ref, **FP32_TOL, msg=lambda m: f"{label}: {m}")
    else:
        ref = D.diffusion_planes_plain(x.float(), w.float(), kernel, steps)
        out = out.float()
        torch.testing.assert_close(out, ref, rtol=0, atol=max(BF16_ATOL, steps * 2 ** -9),
                                   msg=lambda m: f"{label}: {m}")
    err = float((out - ref).abs().max())
    say(f"  {label}: max_abs_err={err:.3e}")
    return err


def stencil_bwd_bound(g, xs, w, kernel):
    """Least time (ms) for the backward of ``len(xs)`` steps on these inputs:
    g, the step inputs and w read once, dx and dw written once, over HBM;
    against the flops: 2 per in-plane tap for dx, 1 per in-plane tap for
    dw's product, and the k²·H·W adds per plane of each cross-step sum, over
    the fp32 rate (the kernel computes in fp32 on the CUDA cores)."""
    p, h, wd = g.shape
    r, steps = kernel // 2, len(xs)
    taps = sum(max(h - abs(d - r), 0) for d in range(kernel)) * sum(max(wd - abs(d - r), 0) for d in range(kernel))
    nbytes = ((2 + steps) * g.numel() + 2 * w.numel()) * g.element_size()
    flops = p * (3.0 * taps * steps + (steps - 1) * kernel * kernel * h * wd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def step_inputs(D, x, w, kernel, steps):
    """The inputs of ``steps`` stencil steps from x (plain forward)."""
    xs = [x]
    for _ in range(steps - 1):
        xs.append(D.diffusion_step_plain(xs[-1], w, kernel))
    return xs


def check_bwd(D, g, xs, w, kernel, label):
    """Backward kernel vs plain backward on the same inputs; returns the max
    abs error over dx and dw."""
    import torch

    before = plane_launches(D)
    dx, dw = D.diffusion_planes_bwd(g, xs, w, kernel)
    torch.cuda.synchronize()
    added = tuple(a - b for a, b in zip(plane_launches(D), before))
    want = expected_launches(D, g.shape[1:], kernel, g.dtype, len(xs), bwd=True)
    check(added == want, f"{label}: launches ({LAUNCH_NAMES}) {added}, expected {want}")
    label = f"{label} [{D.plane_route(*g.shape[1:], kernel, g.dtype, len(xs))}]"
    rdx, rdw = D.diffusion_planes_bwd_plain(g, xs, w, kernel)
    check(dx.dtype == g.dtype and dw.dtype == w.dtype, f"{label}: dtypes {dx.dtype} {dw.dtype}")
    tol = BWD_FP32_TOL if g.dtype == torch.float32 else BWD_BF16_TOL
    err = 0.0
    for name, got, ref in (("dx", dx, rdx), ("dw", dw, rdw)):
        torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"{label} {name}: {m}")
        err = max(err, float((got.float() - ref.float()).abs().max()))
    say(f"  {label}: max_abs_err={err:.3e}")
    return err


def msda_inputs(channels, seed, shapes, lq, n=2, m=2, p=3, dev="cuda"):
    """value in [0, 0.01) as tests/test_msda.py makes it (dLocation is a
    difference of corner sums over the channels, whose fp32 rounding at 3096
    channels of O(1) values alone would pass atol 1e-5), g in [0, 1); loc in
    [-0.2, 1.2) with a third of the samples on integer pixel coordinates
    (corners off every side); aw normalized over levels x points. fp32
    tensors on ``dev``."""
    import torch

    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.rand(n, s, m, channels).astype(np.float32) * 0.01
    loc = (rng.rand(n, lq, m, len(shapes), p, 2) * 1.4 - 0.2).astype(np.float32)
    third = lq // 3
    for lid, (h, w) in enumerate(shapes):
        loc[:, :third, :, lid, :, 0] = (rng.randint(-1, w + 1, size=(n, third, m, p)) + 0.5) / w
        loc[:, :third, :, lid, :, 1] = (rng.randint(-1, h + 1, size=(n, third, m, p)) + 0.5) / h
    aw = rng.rand(n, lq, m, len(shapes), p).astype(np.float32) + 1e-5
    aw /= aw.sum(axis=(-1, -2), keepdims=True)
    g = rng.rand(n, lq, m * channels).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (value, loc, aw, g)]


def check_msda(A, value, loc, aw, g, shapes, label, scale_atol=0.0):
    """The three MSDA kernels vs their plain versions on the same inputs;
    returns the max abs error of each output. ``scale_atol`` raises each
    atol to that fraction of the output's largest entry."""
    import torch

    out = A.ms_deform_attn_fwd(value, shapes, loc, aw)
    dv = A.ms_deform_attn_dvalue(g, value, shapes, loc, aw)
    dloc, daw = A.ms_deform_attn_dlocw(g, value, shapes, loc, aw)
    torch.cuda.synchronize()
    check(out.dtype == value.dtype and dv.dtype == dloc.dtype == daw.dtype == torch.float32,
          f"{label}: dtypes {out.dtype} {dv.dtype} {dloc.dtype} {daw.dtype}")
    rdl, rda = A.ms_deform_attn_dlocw_plain(g, value, shapes, loc, aw)
    refs = {"out": A.ms_deform_attn_plain(value, shapes, loc, aw),
            "dvalue": A.ms_deform_attn_dvalue_plain(g, value, shapes, loc, aw), "dloc": rdl, "daw": rda}
    errs = {}
    for name, got in (("out", out), ("dvalue", dv), ("dloc", dloc), ("daw", daw)):
        tol = dict(MSDA_BF16_OUT_TOL if name == "out" and value.dtype != torch.float32 else MSDA_TOL[name])
        got, ref = got.float(), refs[name].float()
        tol["atol"] = max(tol["atol"], scale_atol * float(ref.abs().max()))
        torch.testing.assert_close(got, ref, **tol, msg=lambda msg: f"{label} {name}: {msg}")
        errs[name] = float((got - ref).abs().max())
    return errs


def off_16_bytes(t):
    """A contiguous copy of t one element past a 16-byte boundary (a slice
    of a larger buffer), which the MSDA kernels load one element at a time."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    check(out.is_contiguous() and out.data_ptr() % 16 != 0, "a misaligned copy")
    return out


def msda_plan_row(A, v, loc, g, accumulate=False):
    """The forward and dLocation/dWeight kernels' plan for these tensors, or
    with ``accumulate`` dValue's (its fp32 accumulators; a fresh gradient
    buffer is aligned)."""
    plan = A._call_plan(v, ENC_SHAPES, loc, g, accumulate=accumulate)
    return {"staged_levels": list(plan.staged), "vector_width": plan.vec, "wide": plan.wide,
            "chunks_per_head": plan.chunks, "smem_bytes": plan.smem_bytes}


def msda_timings(A, v, loc, aw, g, label, card):
    """The three MSDA kernels on these encoder-shape tensors: CUDA-event ms,
    the bound, the plan; and the calls whose device time phase 18 reads
    into the same rows."""
    fns = {"msda_fwd": lambda: A.ms_deform_attn_fwd(v, ENC_SHAPES, loc, aw),
           "msda_dvalue": lambda: A.ms_deform_attn_dvalue(g, v, ENC_SHAPES, loc, aw),
           "msda_dlocw": lambda: A.ms_deform_attn_dlocw(g, v, ENC_SHAPES, loc, aw)}
    bounds = msda_bounds(v, loc, aw, ENC_SHAPES)
    rows, calls = {}, []
    for name, fn in fns.items():
        rows[name] = {"ms": cuda_time_ms(fn, 100), "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                      "plan": msda_plan_row(A, v, loc, g, accumulate=name == "msda_dvalue")}
        calls.append((f"{name} {label}", rows[name], "device_ms", fn, f"{name}_kernel", 100, "per launch"))
        say(f"  {name} {label}: kernel {rows[name]['ms']:.5f} ms, bound {bounds[name][0]:.6f} ms, plan "
            f"{rows[name]['plan']} [{card}]")
    return rows, calls


def msda_corners(loc, shapes):
    """In-range bilinear corners of these locations (the kernels skip the
    others), and the samples with at least one: the data-dependent part of
    the MSDA work."""
    import torch

    corners, live = 0, 0
    for lid, (h, w) in enumerate(shapes):
        x = torch.floor(loc[:, :, :, lid, :, 0] * w - 0.5)
        y = torch.floor(loc[:, :, :, lid, :, 1] * h - 0.5)
        any_in = torch.zeros_like(x, dtype=torch.bool)
        for dy in (0, 1):
            for dx in (0, 1):
                inside = ((x + dx) >= 0) & ((x + dx) < w) & ((y + dy) >= 0) & ((y + dy) < h)
                corners += int(inside.sum())
                any_in |= inside
        live += int(any_in.sum())
    return corners, live


def msda_bounds(value, loc, aw, shapes):
    """Least time (ms) of each MSDA kernel on these inputs, and what bounds
    it. Bytes: each input read once, each output written once (forward: value,
    loc, aw -> out; dValue: g, loc, aw -> an fp32 value-sized gradient;
    dLocation/dWeight: g, value, loc, aw -> dloc, daw in fp32). Operations on
    the fp32 rate: per in-range corner and channel, 2 (forward FMA), 2
    (dValue's product and add); per channel of a sample with an in-range
    corner, 18 for dLocation/dWeight: s, ds/dx and ds/dy from shared lerps
    (t0 = v00 + fx(v01 - v00), t1 = v10 + fx(v11 - v10), ds/dy = t1 - t0,
    s = t0 + fy ds/dy, ds/dx = d0 + fy(d1 - d0): 12) and their three
    products with g summed (6)."""
    n, s, m, d = value.shape
    es = value.element_size()
    g_bytes = loc.shape[1] * n * m * d * es
    lb, ab = loc.numel() * 4, aw.numel() * 4
    corners, live = msda_corners(loc, shapes)
    work = {
        "msda_fwd": (value.numel() * es + lb + ab + g_bytes, 2.0 * corners * d),
        "msda_dvalue": (g_bytes + lb + ab + value.numel() * 4, 2.0 * corners * d),
        "msda_dlocw": (g_bytes + value.numel() * es + 2 * (lb + ab), 18.0 * live * d),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def in_turn(fn):
    """A call of ``fn(i)`` with i = 0, 1, ..., LN_ROTATION - 1, 0, ... in
    turn: one input/output pair a call."""
    turn = itertools.cycle(range(LN_ROTATION))
    return lambda: fn(next(turn))


def layer_norm_bound(x):
    """Least time (ms) of one LayerNorm on x: x read and the output written
    once, scale and bias (fp32) read once; ~8 flops per value on the fp32
    rate."""
    c = x.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 8.0 * x.numel() / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_rel_to_scale(got, ref):
    """max |got - ref| over the largest |ref|."""
    return float((got.float().cpu() - ref.float()).abs().max()) / max(float(ref.abs().max()), 1e-30)


def write_inputs(root, n=N_IMAGES):
    from PIL import Image

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "dep"))
    for i in range(n):
        # smooth random scenes: coarse noise upsampled, plus fine noise
        coarse = (rng.rand(6, 6, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((SIZE, SIZE), Image.BICUBIC), np.float32)
        img = np.clip(img + rng.randn(SIZE, SIZE, 3) * 12, 0, 255).astype(np.uint8)
        dep = np.asarray(Image.fromarray(coarse[..., 0]).resize((SIZE, SIZE), Image.BILINEAR))
        Image.fromarray(img).save(os.path.join(root, "img", f"scene{i:02d}.png"))
        Image.fromarray(dep).save(os.path.join(root, "dep", f"scene{i:02d}_depth.png"))


def write_sod_tree(root, sizes, image_subdir, seed):
    """A folder dataset on disk: ``image_subdir``/, GT/ and Depth/ PNGs of
    the given (height, width) sizes, named scene00.png, ...; each a smooth
    random scene with a disc object (the GT) that the depth map lifts."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for sub in (image_subdir, "GT", "Depth"):
        os.makedirs(os.path.join(root, sub))
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx, r = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w, rng.uniform(0.12, 0.3) * min(h, w)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        coarse = (rng.rand(6, 6, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.float32)
        img = np.clip(img * 0.7 + 60 * mask[..., None] + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)
        dep = np.clip(70 + 120 * mask + rng.randn(h, w) * 8, 0, 255).astype(np.uint8)
        name = f"scene{i:02d}.png"
        Image.fromarray(img).save(os.path.join(root, image_subdir, name))
        Image.fromarray((mask * 255).astype(np.uint8)).save(os.path.join(root, "GT", name))
        Image.fromarray(dep).save(os.path.join(root, "Depth", name))


def val_phase(D, val_ckpt, card):
    """Phase 16: full-width ``cod`` through ``dgtd_tpu_torch.test.main``
    (``configs/cod.yml -m val``, bf16, ``our_init.val_ckpt`` = phase 8's
    epoch_2.pth) on a SOD_TEST tree of VAL_N PNGs of mixed sizes at 384²,
    batch 1: (a) the device-stats route, (b) ``device_metrics=false`` on the
    same checkpoint, every metric of (a) within VAL_ROUTE_TOL of (b); (c)
    ``batch_statistics`` on a batch captured in (a) against the host
    ``prepare`` and ``threshold_histograms``: histograms and counts equal,
    ``sm`` within VAL_SM_TOL; (d) ``save_visualizations`` on 4 images: five
    PNGs an image named from its file; (e) one fused stencil forward a val
    batch and nothing else from the stencil, read from the counters around
    each run; (f) one 704² batch through COD_TEST on the device-stats
    route; (g) the serial loader (``num_workers: 0``, ``prefetch: 0``): the
    same per-image statistics as (a), which decodes on the recipe's 8
    threads and prefetches 2 batches; (h) ``pipeline: native``: its first
    input equal to the pixel library's on the host, its statistics finite;
    then where a device-route image's time goes: each run's loader alone,
    the forward alone, the statistics alone and the host metrics alone.
    Returns the ``val`` line's fields."""
    import torch
    from PIL import Image

    from dgtd_tpu_torch import test as T
    from dgtd_tpu_torch.core.registry import METRICS
    from dgtd_tpu_torch.metrics import sod_metrics as S
    from dgtd_tpu_torch.metrics.device import batch_statistics, statistics_to_host
    from dgtd_tpu_torch.train import loop as TL

    say(f"phase 16: the val pass: full-width cod -m val through dgtd_tpu_torch.test.main (configs/cod.yml, bf16, "
        f"val_ckpt = phase 8's epoch_2.pth) on a SOD_TEST tree of {VAL_N} PNGs of mixed sizes at {SIZE}², batch 1")
    t_phase = time.perf_counter()
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    stats_unspied, to_host_unspied, val_unspied = TL.batch_statistics, TL.statistics_to_host, TL.Runner.val
    predict_unspied, grabbed = TL.Runner._predict, {}

    def spy_stats(prob, label):
        grabbed.setdefault("batch", (prob.clone(), label.clone()))
        return stats_unspied(prob, label)

    def run_val(tmp, tag, dataset, extra=()):
        """One ``-m val`` run; its Runner, each batch's per-image statistics
        and its first input batch land in grabbed[tag]."""
        ovs = [f"work_dir={os.path.join(tmp, tag)}", f"val_dataloader.dataset={dataset}", "val_dataloader.batch_size=1",
               f"custom_hooks.0.val_ckpt={val_ckpt}", *extra]
        got = grabbed[tag] = {"stats": []}

        def spy_val(self, *args, **kwargs):
            got["runner"] = self
            return val_unspied(self, *args, **kwargs)

        def spy_to_host(stats):
            got["stats"].append(to_host_unspied(stats))
            return got["stats"][-1]

        def spy_predict(self, image, depth):
            got.setdefault("input", image.clone())
            return predict_unspied(self, image, depth)

        TL.Runner.val, TL.statistics_to_host, TL.Runner._predict = spy_val, spy_to_host, spy_predict
        try:
            reset_plane_launches(D)
            out = T.main([recipe] + [a for o in ovs for a in ("-o", o)])
            torch.cuda.synchronize()
        finally:
            TL.Runner.val, TL.statistics_to_host, TL.Runner._predict = val_unspied, to_host_unspied, predict_unspied
        return out, plane_launches(D)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_val_") as tmp:
        tree = os.path.join(tmp, "sod")
        write_sod_tree(tree, [VAL_SIZES[i % len(VAL_SIZES)] for i in range(VAL_N)], "RGB", seed=7)
        sod = f"{{'type': 'SOD_TEST', 'data_dir': '{tree}', 'depth_dir': 'Depth', 'split': 'val'}}"
        TL.batch_statistics = spy_stats
        try:
            dev, dev_launches = run_val(tmp, "a", sod)
        finally:
            TL.batch_statistics = stats_unspied
        host, host_launches = run_val(tmp, "b", sod, ["device_metrics=false"])
        # the serial loader (no decode pool, no prefetch thread), then the
        # fused C++ pixel pipeline, both on the device-stats route
        serial, serial_launches = run_val(tmp, "s", sod, ["val_dataloader.num_workers=0", "val_dataloader.prefetch=0"])
        sod_native = sod[:-1] + ", 'pipeline': 'native'}"
        native, native_launches = run_val(tmp, "n", sod_native)
        for name, launches in (("device stats", dev_launches), ("host", host_launches), ("serial", serial_launches),
                               ("native", native_launches)):
            check(launches == launch_tuple("fused", VAL_N),
                  f"val {name} run: launches ({LAUNCH_NAMES}) {launches}, expected one fused forward a batch")
        loaders = {tag: grabbed[tag]["runner"].val_loader for tag in ("a", "s", "n")}
        check(loaders["a"]._pool is not None and loaders["a"]._pool._max_workers == VAL_WORKERS
              and loaders["a"].prefetch == 2, "the recipe's val loader: num_workers and prefetch not in force")
        check(loaders["s"]._pool is None and loaders["s"].prefetch == 0, "the serial val loader has a pool or prefetch")
        # the pool with prefetch gives the serial loader's per-image statistics
        pool_stats, serial_stats = grabbed["a"]["stats"], grabbed["s"]["stats"]
        check(len(pool_stats) == len(serial_stats) == VAL_N, (len(pool_stats), len(serial_stats)))
        for i, (ps, ss) in enumerate(zip(pool_stats, serial_stats)):
            check(sorted(ps) == sorted(ss) and all(np.array_equal(ps[k], ss[k]) for k in ps),
                  f"val image {i}: per-image statistics of the pool with prefetch differ from the serial loader's")
        check(all(serial[k] == dev[k] for k in dev if k.startswith("COD/")), "serial vs pool metrics")
        # the native run's pixels are the library's on the host
        from dgtd_tpu_torch.data.device_norm import IMAGENET_MEAN, IMAGENET_STD
        from dgtd_tpu_torch.native import pixelops

        with Image.open(os.path.join(tree, "RGB", "scene00.png")) as im:
            want = pixelops.resize_normalize(np.asarray(im.convert("RGB")), (SIZE, SIZE), IMAGENET_MEAN, IMAGENET_STD)
        got_native = grabbed["n"]["input"]
        check(got_native.is_cuda and np.array_equal(got_native[0].cpu().numpy(), want),
              "the native run's first input differs from pixelops on the host")
        check(all(np.isfinite(native[f"COD/{m}"]) for m in VAL_METRICS), native)
        check(all(np.isfinite(st["sm"]).all() for st in grabbed["n"]["stats"]), "native per-image statistics")
        native_vs_pil = max(abs(native[f"COD/{m}"] - dev[f"COD/{m}"]) for m in VAL_METRICS)
        worst = (0.0, "")
        for k in dev:
            if k.startswith("COD/"):
                check(bool(np.isfinite(dev[k])), f"{k} = {dev[k]}")
                np.testing.assert_allclose(dev[k], host[k], **VAL_ROUTE_TOL, err_msg=f"val {k}: device vs host")
                worst = max(worst, (abs(dev[k] - host[k]), k))
        say("  (a) device stats: " + ", ".join(f"{m} {dev[f'COD/{m}']:.6f}" for m in VAL_METRICS)
            + f"; {dev['val_imgs_per_sec']:.3f} images/s [{card}]")
        say("  (b) host: " + ", ".join(f"{m} {host[f'COD/{m}']:.6f}" for m in VAL_METRICS)
            + f"; {host['val_imgs_per_sec']:.3f} images/s [{card}]")
        say(f"  (g) serial loader (num_workers 0, prefetch 0): {serial['val_imgs_per_sec']:.3f} images/s, per-image "
            f"statistics equal to (a)'s (num_workers {VAL_WORKERS}, prefetch 2) in all {VAL_N} images [{card}]")
        say("  (h) pipeline: native: " + ", ".join(f"{m} {native[f'COD/{m}']:.6f}" for m in VAL_METRICS)
            + f"; {native['val_imgs_per_sec']:.3f} images/s; first input equal to pixelops on the host; largest "
              f"|metric - (a)'s| {native_vs_pil:.3e} (PIL's resample vs the half-pixel bilinear) [{card}]")
        say(f"  (a) vs (b): largest |diff| {worst[0]:.3e} ({worst[1]}), within rtol {VAL_ROUTE_TOL['rtol']} / atol "
            f"{VAL_ROUTE_TOL['atol']}; (e) launches ({LAUNCH_NAMES}) {dev_launches} and {host_launches} in "
            f"{VAL_N} batches each")

        # (c) the card's statistics against the host algorithms, one batch
        prob, label = grabbed["batch"]
        check(prob.is_cuda and tuple(prob.shape) == (1, SIZE, SIZE, 1), (prob.device, prob.shape))
        stats = statistics_to_host(batch_statistics(prob, label))
        prob_np, label_np = prob.cpu().numpy()[..., 0], label.cpu().numpy()[..., 0]
        sm_err = 0.0
        for i in range(prob_np.shape[0]):
            pred, gt = S.prepare((prob_np[i] * 255).astype(np.uint8), (label_np[i] * 255).astype(np.uint8))
            fg, bg = S.threshold_histograms(pred, gt)
            check(np.array_equal(stats["fg_hist"][i], fg) and np.array_equal(stats["bg_hist"][i], bg),
                  "card histograms differ from the host's")
            check(stats["gt_count"][i] == np.count_nonzero(gt) and stats["n_pixels"][i] == gt.size, "card counts")
            np.testing.assert_allclose(stats["sm"][i], S.smeasure(pred, gt), **VAL_SM_TOL, err_msg="card sm vs host")
            sm_err = max(sm_err, abs(float(stats["sm"][i]) - S.smeasure(pred, gt)))
        say(f"  (c) batch_statistics on the card vs the host algorithms on a captured batch: histograms and counts "
            f"equal, |sm diff| {sm_err:.3e}")

        # where a device-route image's time goes, each part alone (ms an
        # image): the loader of each run, then the shared parts
        parts = {}
        for tag, kind in (("s", "serial"), ("a", "pool_prefetch"), ("n", "native")):
            t0 = time.perf_counter()
            batches = list(grabbed[tag]["runner"].val_loader)
            torch.cuda.synchronize()
            parts[f"loader_{kind}"] = (time.perf_counter() - t0) * 1e3 / len(batches)
        runner = grabbed["a"]["runner"]
        first = batches[0]
        parts["forward"] = cuda_time_ms(lambda: runner._predict(first["input"], first["depth"]), 20, warmup=3)
        parts["statistics_and_copy"] = cuda_time_ms(lambda: statistics_to_host(batch_statistics(prob, label)), 20,
                                                    warmup=3)
        evaluators = [METRICS.build({"type": m}) for m in VAL_METRICS]
        t0 = time.perf_counter()
        for _ in range(5):
            prob_host, label_host = prob.cpu().numpy(), label.cpu().numpy()
            for m in evaluators:
                m.process(prob_host, label_host)
        parts["host_copy_and_metrics"] = (time.perf_counter() - t0) * 1e3 / 5
        parts["device_route_total"] = 1e3 / dev["val_imgs_per_sec"]
        parts["host_route_total"] = 1e3 / host["val_imgs_per_sec"]
        parts["serial_total"] = 1e3 / serial["val_imgs_per_sec"]
        parts["native_total"] = 1e3 / native["val_imgs_per_sec"]
        say("  where a val image's time goes, each part alone (ms an image): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f" [{card}]")
        del runner, batches, first
        grabbed.clear()

        # (d) visualizations on 4 images, named from their files
        vis_tree = os.path.join(tmp, "sod4")
        write_sod_tree(vis_tree, [VAL_SIZES[i % len(VAL_SIZES)] for i in range(4)], "RGB", seed=8)
        sod4 = f"{{'type': 'SOD_TEST', 'data_dir': '{vis_tree}', 'depth_dir': 'Depth', 'split': 'val'}}"
        _, vis_launches = run_val(tmp, "d", sod4, ["save_visualizations=true"])
        check(vis_launches == launch_tuple("fused", 4), f"visualization run: launches {vis_launches}")
        vis_dir = os.path.join(tmp, "d", "visualizations")
        kinds = ("input", "label", "output", "depth", "diffusion")
        want = sorted(f"scene{i:02d}_{k}.png" for i in range(4) for k in kinds)
        check(sorted(os.listdir(vis_dir)) == want, sorted(os.listdir(vis_dir)))
        with Image.open(os.path.join(vis_dir, "scene03_output.png")) as im:
            check(im.size == (SIZE, SIZE) and im.mode == "L", (im.size, im.mode))
        say(f"  (d) save_visualizations: {len(want)} PNGs for 4 images, named from the files")

        # (f) one 704² batch through COD_TEST
        cod_tree = os.path.join(tmp, "camo")
        write_sod_tree(cod_tree, [(480, 640)], "Image", seed=9)
        camo = f"{{'type': 'COD_TEST', 'data_dir': '{cod_tree}', 'depth_dir': 'Depth', 'split': 'val'}}"
        big, big_launches = run_val(tmp, "f", camo)
        check(big_launches == launch_tuple("fused", 1), f"COD_TEST 704²: launches {big_launches}")
        check(all(np.isfinite(big[f"COD/{m}"]) for m in VAL_METRICS), big)
        say("  (f) COD_TEST, one 704² image: " + ", ".join(f"{m} {big[f'COD/{m}']:.6f}" for m in VAL_METRICS)
            + f"; launches ({LAUNCH_NAMES}) {big_launches}")
    return {
        "model": "cod, full width, phase 8's epoch_2.pth (seeded init, 6 steps)",
        "recipe": "configs/cod.yml -m val through dgtd_tpu_torch.test.main, bf16",
        "dataset": f"SOD_TEST tree of {VAL_N} PNGs of mixed sizes, resized to {SIZE}²",
        "images": VAL_N, "batch": 1,
        "val_imgs_per_sec": {"device_stats": dev["val_imgs_per_sec"], "host": host["val_imgs_per_sec"],
                             "serial_loader": serial["val_imgs_per_sec"], "native": native["val_imgs_per_sec"]},
        "loader": {"num_workers": VAL_WORKERS, "prefetch": 2, "serial_per_image_stats_equal": True},
        "native_metrics": {k: v for k, v in native.items() if k.startswith("COD/")},
        "metrics": {"device_stats": {k: v for k, v in dev.items() if k.startswith("COD/")},
                    "host": {k: v for k, v in host.items() if k.startswith("COD/")}},
        "route_max_abs_diff": worst[0],
        "launches": {"device_stats": dev_launches, "host": host_launches, "serial": serial_launches,
                     "native": native_launches, "visualizations": vis_launches,
                     "cod_test_704": big_launches},
        "card_vs_host_sm_max_abs_diff": sm_err,
        "cod_test_704": {k: v for k, v in big.items() if k.startswith("COD/") or k == "val_imgs_per_sec"},
        "ms_per_image": parts,
        "phase_s": time.perf_counter() - t_phase,
        "_fwd_launches": dev_launches[0], "_batches": VAL_N,
    }


def preempt_phase(card):
    """Phase 8b: the train CLI in a subprocess (``python -m
    dgtd_tpu_torch.train configs/cod.yml``, bf16, the recipe's loader with
    its num_workers) on tiny ``cod`` at grid 12, so that it starts fast and
    still runs the fused stencil kernels, with ``ProfilerHook`` on steps
    [2, 4). Once its log shows step 3 it gets SIGTERM: it must save a
    ``preempt_step_N``, log it, leave a trace that names the fused forward and
    backward kernels, and exit 0; ``--resume`` of the checkpoint must then
    finish the epoch. Returns the ``trained`` line's ``preemption`` fields."""
    import signal

    say(f"phase 8b: SIGTERM to a train CLI subprocess (tiny cod, grid 12, {PREEMPT_N} images at {PREEMPT_SIZE}², "
        f"batch {PREEMPT_BATCH}, ProfilerHook on steps [2, 4)), then --resume to the end of the epoch")
    t_phase = time.perf_counter()
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    steps = PREEMPT_N // PREEMPT_BATCH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_preempt_") as tmp:
        work = os.path.join(tmp, "run")
        ovs = [f"work_dir={work}", "train_cfg.max_epochs=1", "train_cfg.val_interval=0",
               f"train_dataloader.batch_size={PREEMPT_BATCH}",
               f"train_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {PREEMPT_N}, 'size': {PREEMPT_SIZE}}}",
               "default_hooks.logger.interval=1", "default_hooks.checkpoint.interval=1",
               "custom_hooks.1={'type': 'ProfilerHook', 'start_step': 2, 'num_steps': 2}",
               *(f"model.{k}={v}" for k, v in PREEMPT_MODEL.items())]
        argv = [sys.executable, "-m", "dgtd_tpu_torch.train", recipe] + [a for o in ovs for a in ("-o", o)]
        log_path = os.path.join(work, "log.jsonl")

        def records():
            if not os.path.exists(log_path):
                return []
            with open(log_path) as f:
                return [json.loads(line) for line in f if line.endswith("\n")]

        def run(args, out_name, signal_at=None):
            with open(os.path.join(tmp, out_name), "w") as out:
                proc = subprocess.Popen(args, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
                try:
                    if signal_at is not None:
                        deadline = time.monotonic() + PREEMPT_TIMEOUT_S
                        while not any(r.get("step") == signal_at and "loss" in r for r in records()):
                            check(proc.poll() is None, f"the train CLI ended before step {signal_at}")
                            check(time.monotonic() < deadline, f"no step {signal_at} in {PREEMPT_TIMEOUT_S} s")
                            time.sleep(0.05)
                        proc.send_signal(signal.SIGTERM)
                    rc = proc.wait(timeout=PREEMPT_TIMEOUT_S)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            with open(os.path.join(tmp, out_name)) as f:
                text = f.read()
            check(rc == 0, f"train CLI exited {rc}:\n{text[-3000:]}")

        run(argv, "cut.log", signal_at=3)
        first = records()
        pre = [r for r in first if r.get("preempted")]
        check(len(pre) == 1, f"preemption records {pre}")
        ckpt = pre[0]["checkpoint"]
        cut_step = max(r["step"] for r in first if "loss" in r)
        check(os.path.basename(ckpt) == f"preempt_step_{cut_step}.pth" and os.path.exists(ckpt) and cut_step < steps,
              f"checkpoint {ckpt} after step {cut_step} of {steps}")
        prof = [r for r in first if "profile" in r]
        check(len(prof) == 1 and os.path.exists(prof[0]["profile"]), f"profile records {prof}")
        with open(prof[0]["profile"]) as f:
            trace = f.read()
        kernels = ("stencil_fused_fwd_kernel", "stencil_fused_bwd_kernel")
        check(all(k in trace for k in kernels), f"the trace names none or one of {kernels}")
        run(argv + ["--resume", ckpt], "resume.log")
        second = records()[len(first):]
        check(second[0] == {"resumed_at_epoch": 0, "step": cut_step, "skip_batches": cut_step},
              f"resume record {second[0]}")
        resumed = [r["step"] for r in second if "loss" in r]
        check(resumed == list(range(cut_step + 1, steps + 1)), f"resumed steps {resumed}")
        check(os.path.exists(os.path.join(work, "epoch_1.pth")), "no epoch_1.pth after the resumed epoch")
    row = {"signal_after_step": 3, "checkpoint_step": cut_step, "epoch_steps": steps,
           "profile_truncated": bool(prof[0].get("truncated", False)), "trace_bytes": len(trace),
           "trace_names": list(kernels), "resumed_steps": len(resumed), "phase_s": time.perf_counter() - t_phase}
    say(f"  SIGTERM after step 3: preempt_step_{cut_step}.pth saved, exit 0; trace of {len(trace)} bytes names "
        f"{', '.join(kernels)} (truncated: {row['profile_truncated']}); --resume trained steps {cut_step + 1}-{steps} "
        f"and saved epoch_1.pth; {row['phase_s']:.1f} s [{card}]")
    return row


def variant_launches(D, model_type, overrides, n_fwd, n_bwd):
    """The stencil counters' increments for ``n_fwd`` forwards and ``n_bwd``
    backwards of a full-width variant at the recipe's grid: none for a model
    that runs no prompt encoder (baseline, DQnet, use_prompts or
    inject_prompts off), else the route's launches for its kernel and steps."""
    import torch

    if model_type != "cod" or not overrides.get("use_prompts", True) or not overrides.get("inject_prompts", True):
        return NO_LAUNCHES
    k, steps = overrides.get("diffusion_kernel", KERNEL), overrides.get("diffusion_steps", STEPS)
    fwd = expected_launches(D, (12, 12), k, torch.bfloat16, steps, bwd=False)
    bwd = expected_launches(D, (12, 12), k, torch.bfloat16, steps, bwd=True)
    return tuple(n_fwd * f + n_bwd * b for f, b in zip(fwd, bwd))


def variants_phase(D, MD, P, card):
    """Phase 17: the model family at full width (PVTv2-b2, the ConvNeXt-B
    tower where there is one), 384², bf16. For each of VARIANTS: train
    VARIANT_STEPS steps at batch TRAIN_BATCH through the Runner
    (``configs/cod.yml`` with ``-o model.type=…`` and the model's ``-o``
    overrides), serve 1 batch of 8 through ``dgtd_tpu_torch.predict.main
    --model …`` on the trained weights, each run's stencil launches read from
    the counters around it against what the route says (none for baseline,
    DQnet and use_prompts=false; the train steps' are the warm-up's and the
    CUDA graphs' capture's), then two replayed steps under the profiler: no
    counter moves, and the stencil kernels run where the route launches
    them; the parameter count, ms per served batch
    and per train step (back to back), the peak memory. Then: baseline's
    prompt modules bit-equal after its steps; the tiled kernels (k = 9 and
    11), the fused kernel (k = 3, 6 steps) and the per-step kernels (k = 13)
    against their plain versions on (P_TRAIN, 12, 12) planes, and on the
    kernel11 and kernel13 runs' own stencil tensors, timed; ``remat`` against no remat (same weights, batch and
    DropPath generator; loss and every gradient; peak memory of both); tiny
    baseline and DQnet in fp32 on the card against the CPU. Returns the
    ``variants`` line's fields and the tiled and per-step kernels' launches,
    errors and times for the ``kernels`` line."""
    import copy

    import torch

    from dgtd_tpu_torch.core.config import load_config
    from dgtd_tpu_torch.core.registry import MODELS
    from dgtd_tpu_torch.models.layers import DropPath
    from dgtd_tpu_torch.train import state as S
    from dgtd_tpu_torch.train.loop import Runner
    from dgtd_tpu_torch.train.state import step_generator, train_step

    say(f"phase 17: model variants at full width, {SIZE}², bf16: {', '.join(v[0] for v in VARIANTS)}; each trained "
        f"{VARIANT_STEPS} steps at batch {TRAIN_BATCH} through the Runner and served {VARIANT_SERVE // BATCH} batches "
        f"of {BATCH} through predict.main")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    # the stencil tensors of the kernel11 and kernel13 runs, by label: the
    # first served MessagePassing inputs, the first trained x, w and g
    rows, grabs = {}, {"kernel11": {}, "kernel13": {}}
    spied = [None]  # the label being captured
    planes_unspied = MD.diffusion_planes

    def capture(module, inputs, output):
        grab = grabs[spied[0]]
        if isinstance(module, MD.MessagePassing) and "served" not in grab:
            grab["served"] = (inputs[0].detach().clone(), inputs[1].detach().clone())

    def spy_planes(x, w, kernel, steps):
        out = planes_unspied(x, w, kernel, steps)
        grab = grabs[spied[0]]
        if "x" not in grab and out.requires_grad:
            grab["x"], grab["w"] = x.detach().clone(), w.detach().clone()
            out.register_hook(lambda gr: grab.setdefault("g", gr.detach().clone()))
        return out

    g_dev = torch.Generator(device=dev).manual_seed(6)
    img = torch.randn(BATCH, SIZE, SIZE, 3, generator=g_dev, device=dev)
    depth = torch.rand(BATCH, SIZE, SIZE, 1, generator=g_dev, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_") as tmp:
        write_inputs(tmp, VARIANT_SERVE)
        for label, model_type, overrides in VARIANTS:
            model_ovs = [f"model.type={model_type}", f"custom_hooks.0.type={VARIANT_HOOKS[model_type]}"]
            model_ovs += [f"model.{k}={v}" for k, v in overrides.items()]
            if label in VARIANT_LR_KEYS:
                model_ovs.append(f"optim_wrapper.paramwise_cfg.custom_keys={VARIANT_LR_KEYS[label]}")
            ovs = [f"work_dir={os.path.join(tmp, label)}", "train_cfg.max_epochs=1", "train_cfg.val_interval=0",
                   f"train_dataloader.batch_size={TRAIN_BATCH}",
                   f"train_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {VARIANT_STEPS * TRAIN_BATCH}, "
                   f"'size': {SIZE}}}", "default_hooks.logger.interval=1"] + model_ovs
            runner = Runner(load_config(recipe, ovs), work_dir=os.path.join(tmp, label), seed=0, device=dev,
                            dtype=torch.bfloat16)
            model = runner.model
            n_params = sum(p.numel() for p in model.parameters())
            frozen = model.frozen_param_prefixes
            dead = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith(frozen)}
            check((label == "baseline") == bool(dead), f"{label}: frozen prefixes {frozen}")
            spying = label in grabs
            spied[0] = label
            if spying:
                MD.diffusion_planes = spy_planes
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_plane_launches(D)
                trained = runner.train()
                train_launches = plane_launches(D)
                train_peak = torch.cuda.max_memory_allocated()
            finally:
                MD.diffusion_planes = planes_unspied
            want = variant_launches(D, model_type, overrides, VARIANT_STEPS, VARIANT_STEPS)
            check(trained["steps"] == VARIANT_STEPS, f"{label}: {trained}")
            check(train_launches == want, f"{label} train: launches ({LAUNCH_NAMES}) {train_launches}, expected {want}")
            with open(os.path.join(tmp, label, "log.jsonl")) as f:
                records = [r for r in map(json.loads, f) if "loss" in r]
            has_ssim = model.use_ssim and want != NO_LAUNCHES
            check(len(records) == VARIANT_STEPS and all(("loss_ssim" in r) == has_ssim for r in records), records)
            check(all(np.isfinite(r["loss"]) for r in records), records)
            first = next(iter(runner.train_loader))
            batch = {k: first[k] for k in ("input", "label", "depth")}
            counter = [VARIANT_STEPS]

            def one_step():
                train_step(model, runner.optimizer, batch, counter[0], runner.seed + 1)
                counter[0] += 1

            step_ms = cuda_time_ms(one_step, 3, warmup=1)
            # the steps after the capture replay its graphs and call no kernel
            # wrapper: the counters stay still, and the stencil kernels the
            # profiler finds in a replayed step ran from the graphs
            reset_plane_launches(D)
            graph_steps = S.GRAPH_STEPS
            replayed_ms = device_ms(one_step, 1, "stencil_")
            check(S.GRAPH_STEPS == graph_steps + 2 and plane_launches(D) == NO_LAUNCHES,
                  f"{label}: {S.GRAPH_STEPS - graph_steps} replayed steps, launches {plane_launches(D)}")
            check((replayed_ms is not None) == (want != NO_LAUNCHES),
                  f"{label}: stencil device ms {replayed_ms} in a replayed step, expected launches {want}")
            served_ms = cuda_time_ms(lambda: model.predict(img, depth), 5, warmup=2)
            dead_equal = all(torch.equal(p.detach(), dead[n]) for n, p in model.named_parameters() if n in dead)
            check(dead_equal, f"{label}: a frozen prompt-module parameter moved")
            ckpt = os.path.join(tmp, f"{label}.pth")
            torch.save(model.state_dict(), ckpt)
            del runner, model, batch, first
            torch.cuda.empty_cache()

            hook = torch.nn.modules.module.register_module_forward_hook(capture) if spying else None
            try:
                reset_plane_launches(D)
                served = P.main(["--checkpoint", ckpt, "--model", model_type, "--image-dir", os.path.join(tmp, "img"),
                                 "--depth-dir", os.path.join(tmp, "dep"), "--out-dir", os.path.join(tmp, f"out_{label}"),
                                 "--size", str(SIZE), "--batch", str(BATCH)]
                                + [a for k, v in overrides.items() for a in ("-o", f"{k}={v}")])
                torch.cuda.synchronize()
                served_launches = plane_launches(D)
            finally:
                if hook is not None:
                    hook.remove()
            want_served = variant_launches(D, model_type, overrides, served["batches"], 0)
            check(served["batches"] == VARIANT_SERVE // BATCH, served)
            check(served_launches == want_served,
                  f"{label} served: launches ({LAUNCH_NAMES}) {served_launches}, expected {want_served}")
            check(len(os.listdir(os.path.join(tmp, f"out_{label}"))) == VARIANT_SERVE, f"{label}: masks")
            rows[label] = {"model": model_type, "overrides": overrides, "parameters": n_params,
                           "served_ms_per_batch": served_ms, "served_cli_loop_s": served["loop_s"],
                           "train_ms_per_step": step_ms, "train_loop_s": trained["loop_s"],
                           "replayed_stencil_device_ms": replayed_ms,
                           "peak_memory_bytes_train": train_peak, "losses": [r["loss"] for r in records],
                           "launches_train": train_launches, "launches_served": served_launches,
                           "frozen_parameters": len(dead), "frozen_bit_equal": dead_equal if dead else None}
            say(f"  {label} ({model_type} {overrides}): {n_params} parameters; served {served_ms:.3f} ms per batch of "
                f"{BATCH}; train {step_ms:.3f} ms per step at batch {TRAIN_BATCH}, peak memory {train_peak / 2**30:.3f} "
                f"GiB; stencil launches ({LAUNCH_NAMES}) train {train_launches}, served {served_launches}"
                + (f"; {len(dead)} frozen parameters bit-equal after {VARIANT_STEPS + 6} steps" if dead else "")
                + f" [{card}]")

    # the tiled kernels (k = 9, 11) and the fused kernel at k = 3, 6 steps,
    # on random planes of the train stencil's shape and on kernel11's own
    say(f"  stencil kernels of the variants vs plain on ({P_TRAIN},12,12) planes and on kernel11's captured tensors")
    g = torch.Generator(device=dev).manual_seed(11)
    errs, errs13 = {"fwd": 0.0, "bwd": 0.0}, {"fwd": 0.0, "bwd": 0.0}
    for k, steps in ((9, STEPS), (11, STEPS), (3, 6), (K13, STEPS)):
        x = torch.rand(P_TRAIN, 12, 12, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(P_TRAIN, k * k, 12, 12, generator=g, device=dev), dim=1)
        gr = torch.rand(P_TRAIN, 12, 12, generator=g, device=dev)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            xd, wd, gd = x.to(dt), wt.to(dt), gr.to(dt)
            e_f = check_kernel(D, xd, wd, k, steps, f"{name} k={k} 12x12, {steps} steps")
            e_b = check_bwd(D, gd, step_inputs(D, xd, wd, k, steps), wd, k, f"{name} k={k} 12x12, {steps} steps")
            if k == K13:
                errs13 = {"fwd": max(errs13["fwd"], e_f), "bwd": max(errs13["bwd"], e_b)}
            elif k != 3:
                errs["fwd"], errs["bwd"] = max(errs["fwd"], e_f), max(errs["bwd"], e_b)
    # each run's own stencil tensors: kernel11's through the tiled kernels,
    # kernel13's through the per-step ones, held to the plain versions and
    # timed (kernel11's beside the per-step kernels on the same tensors);
    # their device time is read in the profiler phase with the others
    k11_rows, k13_rows, k11_calls = {}, {}, []
    for label, k, route, out_rows in (("kernel11", K11, "tiled", k11_rows), ("kernel13", K13, "per_step", k13_rows)):
        grab = grabs[label]
        xp, wt = MD.affinity_planes(*grab["served"], k)
        check(tuple(xp.shape) == (P_MAIN, 12, 12) and xp.dtype == torch.bfloat16, (xp.shape, xp.dtype))
        e_f = check_kernel(D, xp, wt, k, STEPS, f"{label} served bf16 stencil inputs")
        gx, gw, gg = grab["x"], grab["w"], grab["g"]
        check(tuple(gx.shape) == (P_TRAIN, 12, 12) and gx.dtype == torch.bfloat16, (gx.shape, gx.dtype))
        gxs = torch.stack(step_inputs(D, gx, gw, k, STEPS))
        e_b = check_bwd(D, gg, gxs, gw, k, f"{label} trained bf16, 4 steps")
        if label == "kernel11":
            errs["fwd"], errs["bwd"] = max(errs["fwd"], e_f), max(errs["bwd"], e_b)
        else:
            errs13 = {"fwd": max(errs13["fwd"], e_f), "bwd": max(errs13["bwd"], e_b)}
        for part, fn, per_step, plain, bound, match, step_match in (
            ("fwd", functools.partial(D.diffusion_planes, xp, wt, k, STEPS),
             lambda xp=xp, wt=wt, k=k: D._per_step_forward(xp, wt, k, STEPS, None, torch.empty_like(xp)),
             functools.partial(D.diffusion_planes_plain, xp, wt, k, STEPS), stencil_bound(xp, wt, k, STEPS),
             "stencil_tiled_fwd", "stencil_step_kernel"),
            ("bwd", functools.partial(D.diffusion_planes_bwd, gg, gxs, gw, k),
             functools.partial(D._per_step_backward, gg, gxs, gw, k),
             functools.partial(D.diffusion_planes_bwd_plain, gg, gxs, gw, k), stencil_bwd_bound(gg, gxs, gw, k),
             "stencil_tiled_bwd", "stencil_bwd_kernel"),
        ):
            row = dict(ms=cuda_time_ms(fn, 200), plain_ms=cuda_time_ms(plain, 20, warmup=2), bound_ms=bound[0],
                       bound_by=bound[1])
            if route == "tiled":
                row["per_step_ms"] = cuda_time_ms(per_step, 200)
                k11_calls += [(f"tiled {part} k={k} {label} bf16", row, "device_ms", fn, match, 200),
                              (f"per-step {part} k={k} {label} bf16", row, "per_step_device_ms", per_step, step_match,
                               200)]
            else:  # the op is the per-step kernels here
                k11_calls.append((f"per-step {part} k={k} {label} bf16", row, "device_ms", fn, step_match, 200))
            out_rows[part] = row
            say(f"  {route} {part} on {label}'s tensors ({tuple(xp.shape if part == 'fwd' else gg.shape)}, k={k}, "
                f"{STEPS} steps, bf16): {row['ms']:.5f} ms per call"
                + (f", per-step kernels {row['per_step_ms']:.5f} ms" if route == "tiled" else "")
                + f", plain {row['plain_ms']:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}) [{card}]")

    # remat: the same weights, batch and DropPath generator with and without;
    # two runs without give the card's own run-to-run spread in bf16
    say(f"  remat: cod with and without model.remat=true, batch {TRAIN_BATCH}, {SIZE}², bf16, drop-path on; "
        "twice without")
    base = MODELS.get("cod")(seed=0)
    state = base.state_dict()
    rng = np.random.RandomState(12)
    rb = [torch.from_numpy(a).to(dev) for a in (
        rng.randn(TRAIN_BATCH, SIZE, SIZE, 3).astype(np.float32), rng.rand(TRAIN_BATCH, SIZE, SIZE, 1).astype(np.float32),
        (rng.rand(TRAIN_BATCH, SIZE, SIZE, 1) > 0.5).astype(np.float32))]
    remat_rows, grads = {}, {}
    for tag, remat in (("without", False), ("without_again", False), ("with", True)):
        if tag == "with":
            base.cpu()
            torch.cuda.empty_cache()
            base = MODELS.get("cod")(seed=None, remat=True)
            base.load_state_dict(state)
        base.to(dev)
        base.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = base.loss(*rb, generator=step_generator(1, 0, dev))
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        remat_rows[tag] = {"loss": float(loss.detach()), "peak_memory_bytes": peak, "activation_peak_bytes": peak - before}
        grads[tag] = {n: p.grad.detach().float().cpu().clone() for n, p in base.named_parameters()}
        del loss
        if tag != "without_again":  # forward and backward back to back, ms
            remat_rows[tag]["fwd_bwd_ms"] = cuda_time_ms(
                lambda: base.loss(*rb, generator=step_generator(1, 0, dev))[0].backward(), 3, warmup=1)
    base.cpu()
    del base
    torch.cuda.empty_cache()
    ref = grads["without"]
    scale = max(float(v.abs().max()) for v in ref.values())
    spread = {}
    for tag in ("without_again", "with"):
        num = den = 0.0
        worst = (0.0, "")
        for n, g in ref.items():
            d = grads[tag][n] - g
            num, den = num + float((d * d).sum()), den + float((g * g).sum())
            worst = max(worst, (float(d.abs().max()) / max(float(g.abs().max()), 1e-4 * scale), n))
        spread[tag] = {"global_rel_l2": (num / den) ** 0.5, "worst_share_of_scale": worst[0], "worst_param": worst[1]}
    del grads
    rel = abs(remat_rows["with"]["loss"] - remat_rows["without"]["loss"]) / abs(remat_rows["without"]["loss"])
    check(rel <= FIRST_LOSS_RTOL, f"remat loss {remat_rows['with']['loss']} vs {remat_rows['without']['loss']}")
    for key in ("global_rel_l2", "worst_share_of_scale"):
        noise = spread["without_again"][key]
        check(spread["with"][key] <= REMAT_NOISE_FACTOR * noise,
              f"remat gradients: {key} {spread['with'][key]:.3e} > {REMAT_NOISE_FACTOR} x the run-to-run {noise:.3e}")
    say(f"  remat: loss {remat_rows['with']['loss']:.6f} vs {remat_rows['without']['loss']:.6f} (relative {rel:.2e}, "
        f"limit {FIRST_LOSS_RTOL}); gradients vs the run without: global relative L2 "
        f"{spread['with']['global_rel_l2']:.3e}, worst {spread['with']['worst_share_of_scale']:.3e} of its scale "
        f"({spread['with']['worst_param']}); two runs without: {spread['without_again']['global_rel_l2']:.3e} and "
        f"{spread['without_again']['worst_share_of_scale']:.3e} (limit {REMAT_NOISE_FACTOR} x those); peak memory "
        f"{remat_rows['with']['peak_memory_bytes'] / 2**30:.3f} GiB with remat, "
        f"{remat_rows['without']['peak_memory_bytes'] / 2**30:.3f} without (above the weights: "
        f"{remat_rows['with']['activation_peak_bytes'] / 2**30:.3f} and "
        f"{remat_rows['without']['activation_peak_bytes'] / 2**30:.3f} GiB); forward and backward "
        f"{remat_rows['with']['fwd_bwd_ms']:.3f} ms with remat, {remat_rows['without']['fwd_bwd_ms']:.3f} without "
        f"[{card}]")

    # tiny baseline and DQnet, fp32 on the card against the CPU (phase 7's limits)
    tiny_rows = {}
    for name, kwargs in (("baseline", TINY), ("DQnet", dict(variant="tiny", channel=8))):
        m_cpu = MODELS.get(name)(dtype=torch.float32, seed=0, **kwargs)
        for mod in m_cpu.modules():
            if isinstance(mod, DropPath):
                mod.rate = 0.0
        m_dev = copy.deepcopy(m_cpu).to(dev)
        rng = np.random.RandomState(5)
        inputs = [torch.from_numpy(a) for a in (
            rng.randn(2, 64, 64, 3).astype(np.float32), rng.rand(2, 64, 64, 1).astype(np.float32),
            (rng.rand(2, 64, 64, 1) > 0.5).astype(np.float32))]
        loss_cpu = m_cpu.loss(*inputs)[0]
        loss_cpu.backward()
        reset_plane_launches(D)
        loss_dev = m_dev.loss(*[t.to(dev) for t in inputs])[0]
        loss_dev.backward()
        torch.cuda.synchronize()
        check(plane_launches(D) == NO_LAUNCHES, f"tiny {name}: launches {plane_launches(D)}")
        loss_cpu, loss_dev = loss_cpu.item(), loss_dev.item()
        check(abs(loss_dev - loss_cpu) <= TINY_LOSS_RTOL * abs(loss_cpu), f"tiny {name} loss {loss_dev} vs {loss_cpu}")
        ref_grads = dict(m_cpu.named_parameters())
        scale = max(float(p.grad.abs().max()) for p in ref_grads.values() if p.grad is not None)
        worst = (0.0, "")
        for n, p in m_dev.named_parameters():
            ref = ref_grads[n].grad
            check((p.grad is None) == (ref is None), f"tiny {name} {n}: gradient on one side only")
            if ref is None:
                continue
            diff = float((p.grad.cpu() - ref).abs().max())
            limit = TINY_GRAD_RTOL * max(float(ref.abs().max()), 1e-4 * scale)
            check(diff <= limit, f"tiny {name} gradient of {n}: card vs CPU {diff:.3e} > {limit:.3e}")
            worst = max(worst, (diff / limit, n))
        prob_cpu = m_cpu.predict(*inputs[:2])[0]
        prob_err = float((m_dev.predict(*[t.to(dev) for t in inputs[:2]])[0].cpu() - prob_cpu).abs().max())
        check(prob_err <= CPU_PROB_ATOL, f"tiny {name} predict card vs CPU {prob_err:.2e}")
        tiny_rows[name] = {"loss_card": loss_dev, "loss_cpu": loss_cpu, "prob_max_abs_err": prob_err,
                           "worst_gradient_share_of_limit": worst[0]}
        say(f"  tiny {name}, fp32 card vs CPU: loss {loss_dev:.7f} vs {loss_cpu:.7f}; every gradient within "
            f"{TINY_GRAD_RTOL} of its scale (closest: {worst[1]} at {worst[0]:.3f} of it); predict max_abs_err "
            f"{prob_err:.3e}")
        del m_cpu, m_dev
    k11_row, k13_row = rows["kernel11"], rows["kernel13"]
    return {
        "size": SIZE, "serve_batch": BATCH, "train_batch": TRAIN_BATCH, "dtype": "bfloat16",
        "variants": rows, "remat": {**remat_rows, "loss_rel_diff": rel, "gradient_spread": spread,
                                    "noise_factor": REMAT_NOISE_FACTOR},
        "tiny_fp32_card_vs_cpu": tiny_rows, "launch_order": LAUNCH_NAMES,
        "phase_s": time.perf_counter() - t_phase, "card": card,
        "_kernel11": {"fwd": k11_row["launches_train"][6] + k11_row["launches_served"][6],
                      "bwd": k11_row["launches_train"][7], "err": errs, "err13": errs13, "rows": k11_rows,
                      "calls": k11_calls},
        "_kernel13": {"fwd": k13_row["launches_train"][4] + k13_row["launches_served"][4],
                      "bwd": k13_row["launches_train"][5], "rows": k13_rows},
    }


def read_json(path):
    with open(path) as f:
        return json.load(f)


def dp_rank(rank, world, init_file, out_dir, dtype_names):
    """One process of phase 19: rank ``rank`` of ``world`` gloo ranks on the
    card (``world`` 1: one process, no group). For each dtype it builds
    full-width ``cod`` from seed 0 and takes DP_STEPS train steps of the
    recipe's optimizer on its rows of the same synthetic global batches
    (``DataLoader(rank=, world=)``), with each step's loss (the global
    batch's), ms, stencil launches and the seconds of the gradient
    all-reduce; then checks that every rank holds the same parameters and
    statistics bit for bit. The fp32 run's rank 0 saves its state for the
    comparison with one process."""
    import torch
    import torch.distributed as dist

    from dgtd_tpu_torch.core.config import load_config
    from dgtd_tpu_torch.data.datasets import SyntheticSODDataset
    from dgtd_tpu_torch.data.loader import DataLoader
    from dgtd_tpu_torch.models.cod import cod
    from dgtd_tpu_torch.ops import diffusion as D
    from dgtd_tpu_torch.train import state as S
    from dgtd_tpu_torch.train.optim import Optimizer

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    cfg = load_config(os.path.join(ROOT, "configs", "cod.yml"))
    reduce_s = []
    reduce_grads = S.all_mean_

    def timed_reduce(tensors, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_grads(tensors, group)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    S.all_mean_ = timed_reduce
    out = {}
    initial = None
    for name in dtype_names:
        reduce_s.clear()
        # seed 0's weights, initialized once a process and loaded again for
        # the next dtype
        model = cod(dtype=getattr(torch, name), seed=0 if initial is None else None)
        if initial is None:
            initial = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(initial)
        model = model.to(dev)
        loader = DataLoader(SyntheticSODDataset(n=DP_STEPS * TRAIN_BATCH, size=SIZE), TRAIN_BATCH, shuffle=True,
                            seed=0, drop_last=True, device=dev, rank=rank, world=world)
        opt = Optimizer(model.named_parameters(), cfg["optim_wrapper"], int(cfg["train_cfg"]["max_epochs"]),
                        len(loader), frozen_prefixes=model.frozen_param_prefixes, model_cfg=cfg["model"])
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for step, batch in enumerate(loader):
            reset_plane_launches(D)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = S.train_step(model, opt, {k: batch[k] for k in ("input", "label", "depth")}, step, seed=1)
            loss = float(aux["loss"])
            torch.cuda.synchronize()
            steps.append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3, "rows": int(batch["input"].shape[0]),
                          "launches": plane_launches(D)})
        state = model.state_dict()
        equal = True
        if world > 1:
            flat = torch.cat([v.contiguous().reshape(-1).view(torch.uint8) for v in state.values()])
            theirs = flat.clone()
            dist.broadcast(theirs, src=0)
            flag = torch.tensor([int(torch.equal(flat, theirs))])
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            equal = bool(flag.item())
            del flat, theirs
        if name == "float32" and rank == 0:
            torch.save({k: v.cpu() for k, v in state.items()}, os.path.join(out_dir, f"dp_state_{world}.pt"))
        out[name] = {"steps": steps, "reduce_s": list(reduce_s), "bit_equal": equal,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(), "lr": opt.base_lr}
        del model, opt, state
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"dp_{world}_{rank}.json"), "w") as f:
        json.dump(out, f)
    if world > 1:
        dist.destroy_process_group()


def dp_phase(card):
    """Phase 19: full-width ``cod`` trained DP_STEPS steps in one process
    and on DP_RANKS gloo ranks of the card from the same seed and batches,
    then DP_STEPS bf16 steps on the ranks (``dp_rank``)."""
    import torch
    import torch.multiprocessing as mp

    say(f"phase 19: data parallelism: full-width cod, {DP_STEPS} train steps at a global batch of {TRAIN_BATCH} "
        f"({SIZE}², configs/cod.yml's optimizer), fp32 (TF32 off) in one process and on {DP_RANKS} gloo ranks of "
        f"the card ({TRAIN_BATCH // DP_RANKS} rows each); then {DP_STEPS} bf16 steps on the ranks")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        mp.spawn(dp_rank, args=(1, None, tmp, ("float32",)), nprocs=1)
        mp.spawn(dp_rank, args=(DP_RANKS, os.path.join(tmp, "init"), tmp, ("float32", "bfloat16")), nprocs=DP_RANKS)
        single = read_json(os.path.join(tmp, "dp_1_0.json"))["float32"]
        ranks = [read_json(os.path.join(tmp, f"dp_{DP_RANKS}_{r}.json")) for r in range(DP_RANKS)]
        ref = torch.load(os.path.join(tmp, "dp_state_1.pt"))
        got = torch.load(os.path.join(tmp, f"dp_state_{DP_RANKS}.pt"))
    lr = single["lr"]
    for i, s in enumerate(single["steps"]):
        for r in ranks:
            d = r["float32"]["steps"][i]
            check(abs(d["loss"] - s["loss"]) <= DP_LOSS_RTOL * abs(s["loss"]),
                  f"step {i}: loss {d['loss']} on {DP_RANKS} ranks vs {s['loss']} in one process")
    for r, res in enumerate(ranks):
        for name, run in res.items():
            check(run["bit_equal"], f"{name}: the ranks' parameters and statistics differ")
            check(all(st["rows"] == TRAIN_BATCH // DP_RANKS for st in run["steps"]), f"rank {r} rows {run['steps']}")
            check(all(tuple(st["launches"]) == launch_tuple("fused", 1, 1) for st in run["steps"]),
                  f"rank {r} {name}: stencil launches a step {[st['launches'] for st in run['steps']]}")
    check(all(tuple(st["launches"]) == launch_tuple("fused", 1, 1) for st in single["steps"]), single["steps"])
    far = total = 0
    worst_bn = worst_param = 0.0
    for k, v in ref.items():
        g = got[k]
        if k.endswith(DP_BN_KEYS):
            torch.testing.assert_close(g, v, **DP_TOL, msg=lambda m, k=k: f"{k} on {DP_RANKS} ranks vs one process: {m}")
            worst_bn = max(worst_bn, float((g.double() - v.double()).abs().max()))
            continue
        diff = (g - v).abs()
        worst_param = max(worst_param, float(diff.max()))
        check(float(diff.max()) <= DP_STEPS * 2 * lr, f"{k}: {float(diff.max())} > {DP_STEPS}·2·lr")
        far += int((diff > DP_TOL["atol"] + DP_TOL["rtol"] * v.abs()).sum())
        total += v.numel()
    check(far <= DP_FAR_SHARE * total, f"{far} of {total} parameter entries outside rtol/atol")
    del ref, got
    row = {
        "model": "cod, full width (PVTv2-b2, ConvNeXt-B), seed 0", "size": SIZE, "global_batch": TRAIN_BATCH,
        "ranks": DP_RANKS, "backend": "gloo (two ranks on one card; NCCL refuses that)", "steps": DP_STEPS,
        "fp32_one_process": single["steps"],
        "fp32_ranks": [r["float32"] for r in ranks], "bf16_ranks": [r["bfloat16"] for r in ranks],
        "params_outside_tol": far, "param_entries": total, "max_param_diff": worst_param,
        "max_bn_stat_diff": worst_bn, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    for i, s in enumerate(single["steps"]):
        say(f"  step {i + 1} fp32: loss one process {s['loss']:.7f}, {DP_RANKS} ranks "
            f"{', '.join(format(r['float32']['steps'][i]['loss'], '.7f') for r in ranks)}; ms one process "
            f"{s['ms']:.1f}, ranks {', '.join(format(r['float32']['steps'][i]['ms'], '.1f') for r in ranks)}")
    say(f"  after {DP_STEPS} steps: {far} of {total} parameter entries outside rtol 1e-4 / atol 1e-5 (limit "
        f"{DP_FAR_SHARE:g} of them), largest parameter difference {worst_param:.3e} (limit {DP_STEPS * 2 * lr:g}), "
        f"BatchNorm statistics within tolerance (largest difference {worst_bn:.3e}); the ranks bit-equal; one "
        f"fused forward and one fused backward a step on each rank")
    for r, res in enumerate(ranks):
        b16 = res["bfloat16"]
        say(f"  rank {r} bf16: ms a step {[round(st['ms'], 1) for st in b16['steps']]}, of which the gradient "
            f"all-reduce (gloo, through the host) {[round(t * 1e3, 1) for t in b16['reduce_s']]}; peak memory "
            f"{b16['peak_memory_bytes'] / 2**30:.2f} GiB [{card}]")
    return row


def torchrun_phase(card):
    """Phase 20: ``torchrun --standalone --nproc_per_node=1 -m
    dgtd_tpu_torch.train configs/cod.yml`` (one rank, NCCL) for 2 steps on
    synthetic data: its log, a checkpoint that loads into the model."""
    import torch

    from dgtd_tpu_torch.models.cod import cod

    steps = TORCHRUN_N // TRAIN_BATCH
    say(f"phase 20: the train CLI under torchrun --standalone --nproc_per_node=1 (NCCL): configs/cod.yml, "
        f"{steps} steps at batch {TRAIN_BATCH}, {SIZE}², bf16")
    t_phase = time.perf_counter()
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
                "-m", "dgtd_tpu_torch.train", recipe]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_torchrun_") as tmp:
        work = os.path.join(tmp, "run")
        ovs = [f"work_dir={work}", "train_cfg.max_epochs=1", "train_cfg.val_interval=0",
               f"train_dataloader.batch_size={TRAIN_BATCH}",
               f"train_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {TORCHRUN_N}, 'size': {SIZE}}}",
               "default_hooks.logger.interval=1", "default_hooks.checkpoint.interval=1"]
        argv = launcher + [a for o in ovs for a in ("-o", o)]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=TORCHRUN_TIMEOUT_S)
        run_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"torchrun exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(work, "log.jsonl")) as f:
            records = [json.loads(line) for line in f]
        check(records[0] == {"dist": {"backend": "nccl", "world": 1}}, f"first record {records[0]}")
        losses = [r["loss"] for r in records if "loss" in r]
        check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
        ckpt = os.path.join(work, "epoch_1.pth")
        check(any(r.get("checkpoint") == ckpt for r in records), f"no checkpoint record for {ckpt}")
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        check(state["meta"] == {"epoch": 1, "iter": steps}, state["meta"])
        cod(seed=None).load_state_dict(state["state_dict"])
        del state
    row = {"launcher": "torchrun --standalone --nproc_per_node=1", "backend": "nccl", "steps": steps,
           "losses": losses, "run_s": run_s, "checkpoint_loaded": True,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    say(f"  {steps} steps on one NCCL rank, losses {losses}, {run_s:.1f} s with the launcher; epoch_1.pth loads "
        f"into cod [{card}]")
    return row


def spatial_inputs(shape, dtype, seed):
    """The x (B, H, W, C) and normalized w (B, H, W, C, k²) of a spatial
    case, the same in every process from ``seed``."""
    import torch

    from dgtd_tpu_torch.models import diffusion as MD

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=g, device="cuda")
    w = MD.normalize_affinity(torch.rand(*shape, KERNEL * KERNEL, generator=g, device="cuda"), dim=-1)
    return x.to(dtype), w.to(dtype)


def spatial_rank(rank, world, init_file, out_dir):
    """One rank of phase 21: ``spatial_diffusion`` on its rows of every
    SPATIAL_CASES case, fp32 and bf16; the launches by route; one step's
    exchange and stencil timed apart. Saves its shards and timings."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from dgtd_tpu_torch.ops import diffusion as D
    from dgtd_tpu_torch.parallel import spatial as SP

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    r = KERNEL // 2
    out = {}
    for i, (shape, _) in enumerate(SPATIAL_CASES):
        for name in ("float32", "bfloat16"):
            x, w = spatial_inputs(shape, getattr(torch, name), i)
            xs, ws = SP.shard_rows(x).contiguous(), SP.shard_rows(w).contiguous()
            del x, w
            SP.spatial_diffusion(xs, ws, KERNEL, STEPS)  # warm-up
            reset_plane_launches(D)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            res = SP.spatial_diffusion(xs, ws, KERNEL, STEPS)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
            launches = plane_launches(D)
            # one step's two parts apart: the halo exchange, then the stencil
            b, hs, wd, c = xs.shape
            planes = xs.permute(0, 3, 1, 2).reshape(b * c, hs, wd).contiguous()
            wp = F.pad(ws.permute(0, 3, 4, 1, 2).reshape(b * c, KERNEL ** 2, hs, wd), (0, 0, r, r)).contiguous()
            ex = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                halo = SP.exchange_halos(planes, r)
                torch.cuda.synchronize()
                ex.append((time.perf_counter() - t0) * 1e3)
            stencil_ms = cuda_time_ms(lambda: D.diffusion_planes(halo, wp, KERNEL, 1), 20, warmup=3)
            out[f"{i}_{name}"] = {"shard": list(xs.shape), "halo_plane": [hs + 2 * r, wd],
                                  "route": D.plane_route(hs + 2 * r, wd, KERNEL, xs.dtype, 1),
                                  "launches": launches, "call_ms": call_ms, "exchange_ms": sorted(ex)[len(ex) // 2],
                                  "stencil_ms": stencil_ms}
            torch.save(res.cpu(), os.path.join(out_dir, f"spatial_{i}_{name}_{rank}.pt"))
            del xs, ws, res, planes, wp, halo
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"spatial_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def spatial_phase(D, card):
    """Phase 21: ``parallel/spatial.py::spatial_diffusion`` on SPATIAL_RANKS
    gloo ranks of the card (``spatial_rank``), its shards joined and held to
    the unsharded ``diffusion_planes`` on the same tensors."""
    import torch
    import torch.multiprocessing as mp

    say(f"phase 21: spatial_diffusion on {SPATIAL_RANKS} gloo ranks of the card (H sharded, {KERNEL // 2}-row halos "
        f"through the host), k={KERNEL}, {STEPS} steps, against the unsharded diffusion_planes: "
        + ", ".join(f"x {shape} ({route})" for shape, route in SPATIAL_CASES))
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as tmp:
        mp.spawn(spatial_rank, args=(SPATIAL_RANKS, os.path.join(tmp, "init"), tmp), nprocs=SPATIAL_RANKS)
        per_rank = [read_json(os.path.join(tmp, f"spatial_{r}.json")) for r in range(SPATIAL_RANKS)]
        for i, (shape, route) in enumerate(SPATIAL_CASES):
            for name in ("float32", "bfloat16"):
                dt = getattr(torch, name)
                key = f"{i}_{name}"
                x, w = spatial_inputs(shape, dt, i)
                b, h, wd, c = shape
                ref = D.diffusion_planes(x.permute(0, 3, 1, 2).reshape(b * c, h, wd).contiguous(),
                                         w.permute(0, 3, 4, 1, 2).reshape(b * c, KERNEL ** 2, h, wd).contiguous(),
                                         KERNEL, STEPS).reshape(b, c, h, wd).permute(0, 2, 3, 1).float().cpu()
                del x, w
                got = torch.cat([torch.load(os.path.join(tmp, f"spatial_{i}_{name}_{r}.pt"))
                                 for r in range(SPATIAL_RANKS)], dim=1).float()
                tol = FP32_TOL if dt == torch.float32 else dict(rtol=0, atol=BF16_ATOL)
                torch.testing.assert_close(got, ref, **tol, msg=lambda m: f"spatial {shape} {name}: {m}")
                err = float((got - ref).abs().max())
                for r, res in enumerate(per_rank):
                    row = res[key]
                    check(row["route"] == route and tuple(row["launches"]) == launch_tuple(route, STEPS),
                          f"spatial {shape} {name} rank {r}: route {row['route']}, launches {row['launches']}")
                rows[key] = {"shape": list(shape), "dtype": name, "route": route, "max_abs_err": err,
                             "ranks": [res[key] for res in per_rank]}
                say(f"  x {shape} {name}: shards {per_rank[0][key]['shard']}, halo'd planes "
                    f"{per_rank[0][key]['halo_plane']} on the {route} kernel, {STEPS} launches a shard "
                    f"({LAUNCH_NAMES}: {per_rank[0][key]['launches']}); max_abs_err {err:.3e}; a step: exchange "
                    f"{', '.join(format(res[key]['exchange_ms'], '.3f') for res in per_rank)} ms, stencil "
                    f"{', '.join(format(res[key]['stencil_ms'], '.4f') for res in per_rank)} ms; a call "
                    f"{', '.join(format(res[key]['call_ms'], '.2f') for res in per_rank)} ms [{card}]")
                del ref, got
    return {"ranks": SPATIAL_RANKS, "kernel": KERNEL, "steps": STEPS, "backend": "gloo", "cases": rows,
            "phase_s": time.perf_counter() - t_phase, "card": card}


def seeded_depther(seed):
    """The full-width depther on the CPU with seeded weights: every linear
    and conv N(0, 1/fan_in) with zero bias (activations keep their scale
    through the 24 blocks and the head, so the 256 bins' logits are O(1)),
    pos_embed and cls_token N(0, 0.02²), LayerScale gammas 0.1, LayerNorms
    at 1 and 0."""
    import torch
    import torch.nn as nn

    from dgtd_tpu_torch.models.dpt import DinoDPTDepther

    model = DinoDPTDepther(arch=DEPTHER_ARCH, n_bins=DEPTHER_BINS)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                # a stride-k ConvTranspose2d of kernel k sums its I inputs once
                fan_in = m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith(("pos_embed", "cls_token")):
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith(".gamma"):
                p.fill_(0.1)
    return model.eval()


def write_scenes(root, sizes, seed):
    """Smooth random RGB scenes (coarse noise upsampled, plus fine noise)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(root)
    for i, (h, w) in enumerate(sizes):
        coarse = (rng.rand(5, 7, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.float32)
        img = np.clip(img + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"scene{i:02d}.png"))


def depther_phase(card):
    """Phase 22: the offline depther at full width. Seeded ViT-L/14 + DPT
    head written as the release's two files (the backbone's official keys
    with ``mask_token``; the head under ``state_dict`` with ``decode_head.``
    keys); fp32 card vs CPU on a small input; bf16 vs fp32 at 518²; then
    ``python -m dgtd_tpu_torch.tools.depth_gen --estimator dinov2`` (bf16,
    ``main()``) twice over DEPTHER_SIZES, the second run timed."""
    import torch
    from PIL import Image

    from dgtd_tpu_torch.convert import depther_part_state, load_depther_part
    from dgtd_tpu_torch.models.dpt import DinoDPTDepther
    from dgtd_tpu_torch.tools import depth_gen as DG

    say(f"phase 22: the offline depther: DINOv2 {DEPTHER_ARCH} + DPT head ({DEPTHER_BINS} bins), seeded weights, "
        f"through depth_gen --estimator dinov2 --long-side {DEPTHER_SIDE} on {len(DEPTHER_SIZES)} PNGs")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    model = seeded_depther(0)
    n_backbone = sum(p.numel() for p in model.backbone.parameters())
    n_head = sum(p.numel() for p in model.decode_head.parameters())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_depther_") as tmp:
        backbone = {**model.backbone.state_dict(), "mask_token": torch.zeros(1, model.backbone.embed_dim)}
        torch.save(backbone, os.path.join(tmp, "dinov2_vitl14_pretrain.pth"))
        torch.save({"state_dict": {f"decode_head.{k}": v for k, v in model.decode_head.state_dict().items()}},
                   os.path.join(tmp, "dinov2_vitl14_nyu_dpt_head.pth"))
        del backbone
        # the files load back strictly, the mask token the one key unused
        loaded = DinoDPTDepther(arch=DEPTHER_ARCH, n_bins=DEPTHER_BINS)
        skipped = load_depther_part(loaded.backbone, depther_part_state(
            os.path.join(tmp, "dinov2_vitl14_pretrain.pth"), "dinov2"), "dinov2")
        load_depther_part(loaded.decode_head, depther_part_state(
            os.path.join(tmp, "dinov2_vitl14_nyu_dpt_head.pth"), "dpt_head"), "dpt_head")
        check(skipped == ["mask_token"], f"unused backbone keys {skipped}")
        del loaded

        # fp32, card vs CPU, on an input that takes centre padding and pos-embed interpolation
        g = torch.Generator().manual_seed(1)
        small = torch.randn(1, 3, *DEPTHER_CPU_HW, generator=g)
        with torch.inference_mode():
            ref = model(small)
        model.to(dev)
        with torch.inference_mode():
            got = model(small.to(dev)).cpu()
        span = float(ref.max() - ref.min())
        cpu_rel = float((got - ref).abs().max()) / span
        check(tuple(got.shape) == (1, 1, *DEPTHER_CPU_HW) and bool(torch.isfinite(got).all()), f"shape {got.shape}")
        check(cpu_rel <= DEPTHER_CPU_REL, f"depther fp32 card vs CPU: {cpu_rel:.3e} of the range > {DEPTHER_CPU_REL}")
        say(f"  fp32 card vs CPU at {DEPTHER_CPU_HW}: max |diff| {cpu_rel:.3e} of the depth's range "
            f"{span:.4f} (limit {DEPTHER_CPU_REL}) [{card}]")

        # bf16 autocast vs fp32 at 518x518
        x = torch.randn(1, 3, DEPTHER_SIDE, DEPTHER_SIDE, generator=g).to(dev)
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            model.dtype = dt
            with torch.inference_mode():
                out[dt] = model(x).float()
        model.dtype = torch.float32
        d32, d16 = out[torch.float32], out[torch.bfloat16]
        span = float(d32.max() - d32.min())
        bf16_max_rel = float((d16 - d32).abs().max()) / span
        bf16_mean_rel = float((d16 - d32).abs().mean()) / span
        check(bool(torch.isfinite(d16).all()) and bf16_max_rel <= DEPTHER_BF16_MAX_REL
              and bf16_mean_rel <= DEPTHER_BF16_MEAN_REL,
              f"depther bf16 vs fp32 at {DEPTHER_SIDE}²: max {bf16_max_rel:.3e}, mean {bf16_mean_rel:.3e} of the range")
        say(f"  bf16 vs fp32 at {DEPTHER_SIDE}²: max |diff| {bf16_max_rel:.3e}, mean {bf16_mean_rel:.3e} of the "
            f"depth's range {span:.4f} (limits {DEPTHER_BF16_MAX_REL}, {DEPTHER_BF16_MEAN_REL}); depth "
            f"{float(d32.min()):.4f}..{float(d32.max()):.4f} [{card}]")
        del model, x, out, d32, d16
        torch.cuda.empty_cache()

        # the CLI over the PNGs, bf16, on the card: a cold run, then a timed one
        write_scenes(os.path.join(tmp, "img"), DEPTHER_SIZES, seed=2)
        argv = ["--image-dir", os.path.join(tmp, "img"), "--estimator", "dinov2", "--arch", DEPTHER_ARCH,
                "--backbone-ckpt", os.path.join(tmp, "dinov2_vitl14_pretrain.pth"),
                "--head-ckpt", os.path.join(tmp, "dinov2_vitl14_nyu_dpt_head.pth"),
                "--long-side", str(DEPTHER_SIDE), "--render", "gray"]
        runs = []
        for i in range(2):
            # the CLI's own peak: above what the earlier phases still hold
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary = DG.main(argv + ["--out-dir", os.path.join(tmp, f"depth{i}")])
            summary["cli_s"] = time.perf_counter() - t0
            summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
            runs.append(summary)
            torch.cuda.empty_cache()
        n = len(DEPTHER_SIZES)
        for i in range(2):
            names = sorted(os.listdir(os.path.join(tmp, f"depth{i}")))
            check(runs[i]["written"] == n and names == [f"scene{j:02d}_depth.png" for j in range(n)],
                  f"depth_gen run {i}: wrote {runs[i]['written']}, files {names}")
            for j, (h, w) in enumerate(DEPTHER_SIZES):
                with Image.open(os.path.join(tmp, f"depth{i}", names[j])) as im:
                    arr = np.asarray(im)
                check(im.mode == "L" and arr.shape == (h, w) and arr.min() == 0 and arr.max() == 255,
                      f"{names[j]}: mode {im.mode}, shape {arr.shape}, range {arr.min()}..{arr.max()}")
        with Image.open(os.path.join(tmp, "depth0", "scene00_depth.png")) as a, \
                Image.open(os.path.join(tmp, "depth1", "scene00_depth.png")) as b:
            repeat_max = int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())
    timed = runs[1]
    ms_by_part = {k: v * 1e3 / n for k, v in timed["parts_s"].items()}
    row = {"model": f"DINOv2 {DEPTHER_ARCH} + DPT head, classify, {DEPTHER_BINS} UD bins, seeded weights",
           "parameters": {"backbone": n_backbone, "head": n_head}, "long_side": DEPTHER_SIDE, "images": n,
           "sizes": DEPTHER_SIZES, "dtype": "bfloat16", "images_per_s": n / timed["seconds"],
           "ms_per_image_by_part": ms_by_part, "loop_s": timed["seconds"], "cli_s": timed["cli_s"],
           "peak_memory_bytes": timed["peak_memory_bytes"],
           "cold_run": {"images_per_s": n / runs[0]["seconds"], "cli_s": runs[0]["cli_s"],
                        "ms_per_image_by_part": {k: v * 1e3 / n for k, v in runs[0]["parts_s"].items()}},
           "repeat_max_grey_diff": repeat_max,
           "fp32_card_vs_cpu": {"hw": list(DEPTHER_CPU_HW), "max_rel_to_range": cpu_rel, "limit": DEPTHER_CPU_REL},
           "bf16_vs_fp32": {"hw": [DEPTHER_SIDE, DEPTHER_SIDE], "max_rel_to_range": bf16_max_rel,
                            "mean_rel_to_range": bf16_mean_rel,
                            "limits": [DEPTHER_BF16_MAX_REL, DEPTHER_BF16_MEAN_REL]},
           "phase_s": time.perf_counter() - t_phase, "card": card}
    say(f"  depth_gen: {n} maps in {timed['seconds']:.2f} s ({row['images_per_s']:.2f} images/s); ms an image: "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms_by_part.items())
        + f"; peak {timed['peak_memory_bytes'] / 2**30:.2f} GiB; cold run {row['cold_run']['images_per_s']:.2f} "
          f"images/s [{card}]")
    return row


def serving_check_phase(D, card):
    """Phase 23: ``dgtd_tpu_torch/tools/serving_check.py`` with its defaults
    (``cod`` predict at 704² and 1024², the 512² diffusion block's three
    legs), its JSON lines reprinted; the stencil launch counters reset just
    before it and read just after."""
    import torch

    from dgtd_tpu_torch.tools import serving_check as SC

    say(f"phase 23: serving_check --sizes {' '.join(map(str, SERVING_SIZES))} --grid {SERVING_CHECK_GRID}")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_plane_launches(D)
    results = SC.run(SERVING_SIZES, SERVING_CHECK_GRID)
    launches = plane_launches(D)
    for res in results:
        check(res["ok"], f"serving_check {res['check']}: {res}")
    by_check = {res["check"]: res for res in results}
    block = by_check[f"diffusion_{SERVING_CHECK_GRID}sq_c24_k{KERNEL}_s{STEPS}"]
    check(D.plane_route(SERVING_CHECK_GRID, SERVING_CHECK_GRID, KERNEL, torch.bfloat16, STEPS) == "tiled"
          and all(block["stencil_launches"][leg]["TILED_LAUNCHES"] > 0 for leg in ("nhwc_wrapper", "planes")),
          f"the {SERVING_CHECK_GRID}² block's kernel legs: {block['stencil_launches']}")
    for size in SERVING_SIZES:
        check(by_check[f"predict_{size}sq_bs1"]["stencil_launches"]["FUSED_LAUNCHES"] > 0,
              f"predict at {size}²: {by_check[f'predict_{size}sq_bs1']['stencil_launches']}")
    check(launches[0] > 0 and launches[6] > 0, f"serving_check launches ({LAUNCH_NAMES}) {launches}")
    say(f"  launches ({LAUNCH_NAMES}): {launches} [{card}]")
    return {"results": results, "launches": launches, "launch_order": LAUNCH_NAMES,
            "phase_s": time.perf_counter() - t_phase, "card": card}


def _dir_bytes(path):
    return {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def bundle_phase(D, card):
    """Phase 24: ``tools/export_serving.py`` on full-width ``cod`` at 384²
    (bf16, the default, then fp32): export, ``ServingModel.load``, serve a
    384² input and a BUNDLE_ODD_HW input; each held to eager ``predict`` on
    the same inputs (the odd size resized to the bucket and back with the
    loader's resize), the fused forward's counter read around the bundle's
    calls; eager predict and the bundle's program timed at batch 1."""
    import torch

    from dgtd_tpu_torch.models.cod import cod
    from dgtd_tpu_torch.tools import export_serving as E

    say(f"phase 24: serving bundles of full-width cod at {SIZE}² (export_serving, bf16 and fp32), served at {SIZE}² "
        f"and {BUNDLE_ODD_HW[0]}x{BUNDLE_ODD_HW[1]} through ServingModel")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(24)
    cases = {hw: (rng.randn(1, *hw, 3).astype(np.float32), rng.rand(1, *hw, 1).astype(np.float32))
             for hw in ((SIZE, SIZE), BUNDLE_ODD_HW)}
    row = {"size": SIZE, "card": card}
    model = cod(seed=0).to(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bundle_") as tmp:
        for name, dtype, tol in (("bf16", torch.bfloat16, dict(rtol=0.0, atol=BF16_ATOL)),
                                 ("fp32", torch.float32, FP32_TOL)):
            model.dtype = dtype  # the compute policy: autocast on or off
            out = os.path.join(tmp, name)
            meta = E.export_bundle(model, out, sizes=[SIZE], meta_extra={"model": "cod", "ckpt": None,
                                                                         "loaded_params": 0})
            t0 = time.perf_counter()
            serving = E.ServingModel.load(out)
            load_s = time.perf_counter() - t0
            leg = {"export_s": meta["export_seconds"]["cuda"][str(SIZE)], "load_s": load_s, "bytes": _dir_bytes(out)}
            # the program holds no weight: they come in as an input, from params.npz
            check(leg["bytes"][f"predict_{SIZE}_cuda.pt2"] < leg["bytes"]["params.npz"] / 10, leg["bytes"])
            for hw, (img, dep) in cases.items():
                reset_plane_launches(D)
                got = serving(img, dep)
                torch.cuda.synchronize()
                launches = plane_launches(D)
                check(launches == launch_tuple("fused", 1),
                      f"{name} bundle at {hw}: stencil launches ({LAUNCH_NAMES}) {launches}, want one fused forward")
                at = (img, dep) if hw == (SIZE, SIZE) else (E._resize_nhwc(img, SIZE), E._resize_nhwc(dep, SIZE))
                ref = model.predict(*(torch.from_numpy(a).to(dev) for a in at))[0].float().cpu().numpy()
                if hw != (SIZE, SIZE):
                    ref = E._resize_nhwc(ref, hw)
                check(got.shape == (1, *hw, 1) and bool(np.isfinite(got).all()), (name, hw, got.shape))
                err = float(np.abs(got - ref).max())
                bar = tol["atol"] + tol["rtol"] * float(np.abs(ref).max())
                say(f"  {name} bundle at {hw[0]}x{hw[1]}: max_abs_err vs eager predict {err:.3e} (limit {bar:.1e}); "
                    f"stencil launches {launches}")
                check(err <= bar, f"{name} bundle at {hw}: {err:.3e} > {bar:.1e}")
                leg[f"{hw[0]}x{hw[1]}"] = {"max_abs_err": err, "limit": bar, "launches": launches}
            if name == "bf16":
                img, dep = (torch.from_numpy(a).to(dev) for a in cases[(SIZE, SIZE)])
                leg["eager_ms"] = cuda_time_ms(lambda: model.predict(img, dep), BUNDLE_ITERS, warmup=2)
                leg["bundle_ms"] = cuda_time_ms(lambda: serving.run(SIZE, img, dep), BUNDLE_ITERS, warmup=2)
                leg["bundle_numpy_ms"] = cuda_time_ms(lambda: serving(*cases[(SIZE, SIZE)]), BUNDLE_ITERS, warmup=2)
                reset_plane_launches(D)
                serving.run(SIZE, img, dep)
                torch.cuda.synchronize()
                row["launches"] = plane_launches(D)[0] + sum(
                    leg[f"{h}x{w}"]["launches"][0] for h, w in cases)
                say(f"  bf16 batch 1 at {SIZE}²: eager predict {leg['eager_ms']:.2f} ms, the bundle's program "
                    f"{leg['bundle_ms']:.2f} ms, ServingModel with its host copies {leg['bundle_numpy_ms']:.2f} ms "
                    f"[{card}]")
            say(f"  {name}: export {leg['export_s']:.1f} s, load {load_s:.1f} s, files {leg['bytes']}")
            row[name] = leg
            del serving
    del model
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    return row


def dqnet_msda_bundle_phase(card):
    """Phase 25: a ``DQnet`` bundle at a cut depth (bf16, 384²) served and
    held to eager ``predict``; then the ``MSDeformAttn`` layer at the
    encoder width exported with ``torch.export``, saved, loaded and run on
    the card: ``msda.LAUNCHES`` counts its forward kernel, and its output
    equals the eager layer's. (No model of the repository calls the layer,
    DQnet included.)"""
    import torch

    from dgtd_tpu_torch.models.dqnet import DQnet
    from dgtd_tpu_torch.ops import msda as A
    from dgtd_tpu_torch.tools import export_serving as E

    say(f"phase 25: a DQnet bundle (PVT {DQNET_BUNDLE_VARIANT}: b2's widths at a cut depth, bf16, {SIZE}²); the "
        f"MSDeformAttn layer exported at the encoder width")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(25)
    img, dep = rng.randn(1, SIZE, SIZE, 3).astype(np.float32), rng.rand(1, SIZE, SIZE, 1).astype(np.float32)
    row = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dqnet_") as tmp:
        model = DQnet(variant=DQNET_BUNDLE_VARIANT, seed=0).to(dev)
        meta = E.export_bundle(model, tmp, sizes=[SIZE], meta_extra={"model": "DQnet"})
        serving = E.ServingModel.load(tmp)
        A.LAUNCHES = 0
        got = serving(img, dep)
        torch.cuda.synchronize()
        ref = model.predict(torch.from_numpy(img).to(dev), torch.from_numpy(dep).to(dev))[0].float().cpu().numpy()
        err = float(np.abs(got - ref).max())
        say(f"  DQnet bundle: export {meta['export_seconds']['cuda'][str(SIZE)]:.1f} s, max_abs_err vs eager "
            f"{err:.3e} (limit {BF16_ATOL}); msda launches {A.LAUNCHES} (DQnet has no MSDA)")
        check(got.shape == (1, SIZE, SIZE, 1) and err <= BF16_ATOL, f"DQnet bundle {got.shape} {err:.3e}")
        row["dqnet"] = {"variant": DQNET_BUNDLE_VARIANT, "export_s": meta["export_seconds"]["cuda"][str(SIZE)],
                        "bytes": _dir_bytes(tmp), "max_abs_err": err, "msda_launches": A.LAUNCHES}
        del model, serving
        torch.cuda.empty_cache()

        layer = A.MSDeformAttn(ENC_D_MODEL, len(ENC_SHAPES), ENC_HEADS, ENC_POINTS, seed=0).to(dev).eval()

        class Encoder(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.layer = layer

            def forward(self, q, r, v):
                return self.layer(q, r, v, ENC_SHAPES)

        q = torch.from_numpy(rng.randn(1, ENC_S, ENC_D_MODEL).astype(np.float32)).to(dev)
        v = torch.from_numpy(rng.randn(1, ENC_S, ENC_D_MODEL).astype(np.float32)).to(dev)
        r = torch.from_numpy(rng.rand(1, ENC_S, len(ENC_SHAPES), 2).astype(np.float32)).to(dev)
        path = os.path.join(tmp, "msdeformattn.pt2")
        with torch.no_grad():
            torch.export.save(torch.export.export(Encoder(), (q, r, v)), path)
            program = torch.export.load(path).module()
            A.LAUNCHES = 0
            got = program(q, r, v)
            torch.cuda.synchronize()
            launches = A.LAUNCHES
            ref = layer(q, r, v, ENC_SHAPES)
        err = float((got - ref).abs().max())
        say(f"  exported MSDeformAttn (N=1, Lq=S={ENC_S}): msda forward launches {launches}, max_abs_err vs eager "
            f"{err:.3e}")
        check(launches == 1, f"exported MSDeformAttn: {launches} forward launches, want 1")
        check(err <= FP32_TOL["atol"] + FP32_TOL["rtol"] * float(ref.abs().max()), f"exported MSDeformAttn {err:.3e}")
        row["msdeformattn"] = {"launches": launches, "max_abs_err": err, "n": 1, "lq": ENC_S}
    row["phase_s"] = time.perf_counter() - t_phase
    return row


def layout_phase(D, card):
    """Phase 26: full-width ``cod`` under
    ``core.flags.diffusion_plane_layout`` False (the NHWC stencil: the NHWC
    plane kernel forward, the fused plane backward on NHWC gradients)
    against True (the plane kernels): a served batch (BATCH at 384², bf16)
    and one train step's loss and backward (TRAIN_BATCH, bf16, one
    drop-path generator seed for both), held together within the bf16
    bars (the probabilities within twice the plane layout's own
    bf16-vs-fp32 gap on the batch, at the largest (at least BF16_ATOL) and
    on average; the loss within FIRST_LOSS_RTOL); each layout's kernels
    counted; both timed in turns."""
    import torch

    from dgtd_tpu_torch.core import flags
    from dgtd_tpu_torch.models.cod import cod

    say(f"phase 26: cod under diffusion_plane_layout False (NHWC stencil) vs True (planes): a served batch of {BATCH} "
        f"and a train step at batch {TRAIN_BATCH}, {SIZE}², bf16")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(26)
    img = torch.from_numpy(rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)).to(dev)
    dep = torch.from_numpy(rng.rand(BATCH, SIZE, SIZE, 1).astype(np.float32)).to(dev)
    timg = torch.from_numpy(rng.randn(TRAIN_BATCH, SIZE, SIZE, 3).astype(np.float32)).to(dev)
    tdep = torch.from_numpy(rng.rand(TRAIN_BATCH, SIZE, SIZE, 1).astype(np.float32)).to(dev)
    tlab = torch.from_numpy((rng.rand(TRAIN_BATCH, SIZE, SIZE, 1) > 0.5).astype(np.float32)).to(dev)
    model = cod(seed=0).to(dev)

    def counts():
        return plane_launches(D) + (D.NHWC_PLANE_LAUNCHES, D.NHWC_GRID_LAUNCHES, D.NHWC_LAUNCHES)

    def reset():
        reset_plane_launches(D)
        D.NHWC_PLANE_LAUNCHES = D.NHWC_GRID_LAUNCHES = D.NHWC_LAUNCHES = 0

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(timg, tdep, tlab, torch.Generator(device=dev).manual_seed(26))
        loss.backward()
        return loss

    saved = flags.diffusion_plane_layout
    row = {"card": card, "counter_order": LAUNCH_NAMES + ", nhwc plane fwd, nhwc grid fwd, nhwc step fwd"}
    try:
        runs = {}
        for value in (True, False):
            flags.set_flag("diffusion_plane_layout", value)
            reset()
            prob = model.predict(img, dep)[0].float()
            torch.cuda.synchronize()
            served = counts()
            reset()
            loss = float(step().detach())
            torch.cuda.synchronize()
            trained = counts()
            grads = {k: p.grad.float().clone() for k, p in model.named_parameters() if p.grad is not None}
            runs[value] = (prob, loss, grads, served, trained)
            say(f"  layout {value}: served launches {served}, train-step launches {trained}, loss {loss:.6f}")
        nhwc_served, nhwc_trained = runs[False][3], runs[False][4]
        check(nhwc_served == NO_LAUNCHES + (1, 0, 0), f"flag False served: {nhwc_served}")
        check(nhwc_trained == launch_tuple("fused", 0, 1) + (1, 0, 0), f"flag False train step: {nhwc_trained}")
        check(runs[True][3] == launch_tuple("fused", 1) + (0, 0, 0), f"flag True served: {runs[True][3]}")
        check(runs[True][4] == launch_tuple("fused", 1, 1) + (0, 0, 0), f"flag True train step: {runs[True][4]}")
        # the two layouts' kernels sum a step's taps in other orders and round
        # each step to bf16, and the model carries the difference on in
        # bf16: two bf16 runs of one fp32 forward, each within the plane
        # layout's own bf16-vs-fp32 gap of it (measured here, on this batch),
        # so within twice that gap of each other, at the largest (at least
        # BF16_ATOL) and on average
        flags.set_flag("diffusion_plane_layout", True)
        model.dtype = torch.float32
        try:
            prob32 = model.predict(img, dep)[0].float()
        finally:
            model.dtype = torch.bfloat16
        gap = (runs[True][0] - prob32).abs()
        gap_max, gap_mean = float(gap.max()), float(gap.mean())
        diff = runs[False][0] - runs[True][0]
        prob_err, prob_mean_err, mean_shift = float(diff.abs().max()), float(diff.abs().mean()), float(diff.mean())
        prob_bar, mean_bar = max(BF16_ATOL, 2 * gap_max), 2 * gap_mean
        loss_rel = abs(runs[False][1] - runs[True][1]) / abs(runs[True][1])
        grad_rel = max(float((runs[False][2][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                       for k, g in runs[True][2].items())
        say(f"  False vs True: served probability max_abs_err {prob_err:.3e} (limit {prob_bar:.3e}; the planes' "
            f"bf16-vs-fp32 gap {gap_max:.3e}), mean abs {prob_mean_err:.3e} (limit {mean_bar:.3e}; gap mean "
            f"{gap_mean:.3e}), mean shift {mean_shift:.2e}; loss rel {loss_rel:.2e} (limit "
            f"{FIRST_LOSS_RTOL}); gradients' largest difference to their scale {grad_rel:.2e}")
        check(prob_err <= prob_bar, f"layout False vs True served: {prob_err:.3e} > {prob_bar:.3e}")
        check(prob_mean_err <= mean_bar, f"layout False vs True served mean abs: {prob_mean_err:.3e} > {mean_bar:.3e}")
        check(loss_rel <= FIRST_LOSS_RTOL, f"layout False vs True loss: {loss_rel:.2e}")
        check(all(bool(torch.isfinite(g).all()) for g in runs[False][2].values()), "flag False gradients finite")
        del runs
        timings = {"served_ms": {True: [], False: []}, "train_step_ms": {True: [], False: []}}
        for value in (True, False, False, True):
            flags.set_flag("diffusion_plane_layout", value)
            timings["served_ms"][value].append(cuda_time_ms(lambda: model.predict(img, dep), LAYOUT_ITERS, warmup=2))
            timings["train_step_ms"][value].append(cuda_time_ms(step, LAYOUT_ITERS, warmup=2))
        row.update({"served_launches": nhwc_served, "train_launches": nhwc_trained, "prob_max_abs_err": prob_err,
                    "prob_mean_abs_err": prob_mean_err, "prob_mean_shift": mean_shift, "prob_limit": prob_bar,
                    "mean_abs_limit": mean_bar, "bf16_vs_fp32_gap": {"max": gap_max, "mean_abs": gap_mean},
                    "loss_rel": loss_rel, "grad_rel_to_scale": grad_rel,
                    **{k: {("planes" if v else "nhwc"): ms for v, ms in t.items()} for k, t in timings.items()}})
        say(f"  served ms a batch: planes {timings['served_ms'][True]}, nhwc {timings['served_ms'][False]}; train "
            f"ms a step (loss and backward): planes {timings['train_step_ms'][True]}, nhwc "
            f"{timings['train_step_ms'][False]} [{card}]")
    finally:
        flags.set_flag("diffusion_plane_layout", saved)
    del model
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    return row


def space_inputs(size, batch):
    """A served batch's image and depth (NHWC, on the card), the same in
    every process for a (size, batch)."""
    import torch

    g = torch.Generator().manual_seed(size * 1000 + batch)
    img = torch.randn(batch, size, size, 3, generator=g)
    dep = torch.rand(batch, size, size, 1, generator=g)
    return img.cuda(), dep.cuda()


def space_train_batches():
    """Phase 27's SPACE_TRAIN_STEPS global train batches (NHWC, on the host):
    a normalized image, a depth and a binary label, the same in every
    process."""
    import torch

    g = torch.Generator().manual_seed(27)
    return [{"input": torch.randn(TRAIN_BATCH, SIZE, SIZE, 3, generator=g),
             "depth": torch.rand(TRAIN_BATCH, SIZE, SIZE, 1, generator=g),
             "label": (torch.rand(TRAIN_BATCH, SIZE, SIZE, 1, generator=g) > 0.5).float()}
            for _ in range(SPACE_TRAIN_STEPS)]


def space_train(model, weights, layout, name, grads_path=None, n_steps=SPACE_TRAIN_STEPS, recipe_overrides=(),
                nudge=False):
    """``n_steps`` train steps (``train/state.py::train_step``,
    configs/cod.yml's optimizer under ``recipe_overrides``) of ``model``
    reloaded with seed 0's ``weights``, in dtype ``name``, on this process's rows of
    :func:`space_train_batches` under ``layout`` (None: one process, every
    row). The stencil's launch counters and the layout's counts are reset
    just before each step and read just after. Returns each step's loss
    terms, ms, launches and counts, the peak memory, and whether every
    rank holds the same parameters and statistics bit for bit afterwards;
    ``grads_path`` receives the step-1 gradients the optimizer is handed;
    ``nudge`` moves every input pixel one fp32 ulp up (how far rounding
    alone moves the gradients). cuDNN is used as the caller has set it."""
    import torch
    import torch.distributed as dist

    from dgtd_tpu_torch.core.config import load_config
    from dgtd_tpu_torch.ops import diffusion as D
    from dgtd_tpu_torch.parallel import space as S
    from dgtd_tpu_torch.parallel.dist import row_slice
    from dgtd_tpu_torch.train.optim import Optimizer
    from dgtd_tpu_torch.train.state import train_step

    model.load_state_dict(torch.load(weights))
    model.dtype = getattr(torch, name)
    cfg = load_config(os.path.join(ROOT, "configs", "cod.yml"), list(recipe_overrides))
    opt = Optimizer(model.named_parameters(), cfg["optim_wrapper"], int(cfg["train_cfg"]["max_epochs"]),
                    SPACE_TRAIN_STEPS, frozen_prefixes=model.frozen_param_prefixes, model_cfg=cfg["model"])

    class Grab:
        def step(self, step):
            if step == 0 and grads_path:
                torch.save({n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None},
                           grads_path)
            return opt.step(step)

    rows = slice(None) if layout is None else row_slice(TRAIN_BATCH, layout.data_index, layout.data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for step, b in enumerate(space_train_batches()[:n_steps]):
        batch = {k: v[rows].cuda() for k, v in b.items()}
        if nudge:
            batch["input"] = torch.nextafter(batch["input"], torch.full_like(batch["input"], math.inf))
        torch.cuda.synchronize()
        if layout is not None:
            dist.barrier()
            layout.reset_counts()
        reset_plane_launches(D)
        t0 = time.perf_counter()
        with S.active_space(layout):
            aux = train_step(model, Grab(), batch, step, seed=1)
        losses = {k: float(v) for k, v in aux.items()}
        torch.cuda.synchronize()
        steps.append({"losses": losses, "ms": (time.perf_counter() - t0) * 1e3, "launches": plane_launches(D),
                      "counts": None if layout is None else dict(layout.counts)})
    equal = True
    if layout is not None:
        flat = torch.cat([v.contiguous().reshape(-1).view(torch.uint8).cpu() for v in model.state_dict().values()])
        theirs = flat.clone()
        dist.broadcast(theirs, src=0)
        flag = torch.tensor([int(torch.equal(flat, theirs))])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        equal = bool(flag.item())
    return {"steps": steps, "peak_memory_bytes": torch.cuda.max_memory_allocated(), "bit_equal": equal,
            "rows": TRAIN_BATCH if layout is None else TRAIN_BATCH // layout.data}


def other_launches(D, A):
    """The NHWC stencil's and the MSDA kernels' launch counters."""
    return (D.NHWC_PLANE_LAUNCHES, D.NHWC_GRID_LAUNCHES, D.NHWC_LAUNCHES, A.LAUNCHES, A.DVALUE_LAUNCHES,
            A.DLOCW_LAUNCHES)


def reset_other_launches(D, A):
    D.NHWC_PLANE_LAUNCHES = D.NHWC_GRID_LAUNCHES = D.NHWC_LAUNCHES = 0
    A.LAUNCHES = A.DVALUE_LAUNCHES = A.DLOCW_LAUNCHES = 0


def dqnet_space_leg(weights, layout, out_dir, save):
    """Phase 27's DQnet leg in one process (``layout`` None) or on one rank
    of DQNET_SPACE_LAYOUT: full-width ``DQnet`` with seed 0's ``weights``
    served at SIZE², batch BATCH, fp32 (TF32 off) and bf16 (one warm-up
    batch, then SPACE_ITERS timed ones, every stencil, NHWC and MSDA
    counter and the layout's counts reset just before the first and read
    just after it; peak memory; ``save``: the probability gathered whole
    into ``out_dir``); then SPACE_TRAIN_STEPS fp32 train steps
    (:func:`space_train`, every counter reset before and read after; with
    ``save`` the step-1 gradients), then one fp32 step with cuDNN off
    (ATen's native convolutions; in one process its gradients against the
    cuDNN step's are the card's own spread); in one process also one cuDNN
    step on inputs nudged one ulp up (:func:`space_train`'s ``nudge``)."""
    import torch
    import torch.distributed as dist

    from dgtd_tpu_torch.models.dqnet import DQnet
    from dgtd_tpu_torch.ops import diffusion as D
    from dgtd_tpu_torch.ops import msda as A
    from dgtd_tpu_torch.parallel import space as S

    model = DQnet(seed=None)
    model.load_state_dict(torch.load(weights))
    model = model.cuda()
    img, dep = space_inputs(SIZE, BATCH)
    tag = "one" if layout is None else "space"
    out = {}
    for name in ("float32", "bfloat16"):
        model.dtype = getattr(torch, name)
        with S.active_space(layout):
            model.predict(img, dep)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = []
            for it in range(SPACE_ITERS):
                if it == 0:
                    reset_plane_launches(D)
                    reset_other_launches(D, A)
                    if layout is not None:
                        layout.reset_counts()
                if layout is not None:
                    dist.barrier()
                t0 = time.perf_counter()
                prob = model.predict(img, dep)[0]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if it == 0:
                    launches = plane_launches(D) + other_launches(D, A)
                    counts = None if layout is None else dict(layout.counts)
            peak = torch.cuda.max_memory_allocated()
            full = S.gather_map(prob, SIZE)
        if save:
            torch.save(full.float().cpu(), os.path.join(out_dir, f"dqnet_{tag}_{name}.pt"))
        out[name] = {"band": list(prob.shape), "ms": ms, "launches": launches, "counts": counts,
                     "peak_memory_bytes": peak, "peak_above_start_bytes": peak - base}
        del prob, full
    del img, dep
    torch.cuda.empty_cache()
    runs = [("train", True, False), ("native", False, False)] + ([("nudged", True, True)] if layout is None else [])
    for key, cudnn, nudge in runs:
        grads = os.path.join(out_dir, f"dqnet_{tag}_{key}_grads.pt") if save else None
        reset_other_launches(D, A)
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            out[key] = space_train(model, weights, layout, "float32", grads, 1 if key != "train" else SPACE_TRAIN_STEPS,
                                   DQNET_RECIPE_OVERRIDES, nudge)
        out[key]["other_launches"] = other_launches(D, A)
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    return out


def space_rank(rank, world, init_file, out_dir, weights, dqnet_weights):
    """One rank of phase 27: full-width ``cod`` (seed 0's ``weights``) served under each
    SPACE_CASES layout of ``world`` ranks, fp32 (TF32 off) and bf16: one
    warm-up batch, then SPACE_ITERS timed ones with the launch counters and
    the layout's counts reset just before the first and read just after it;
    peak memory; the probability gathered whole (saved by rank 0). Rank 0
    also keeps the stencil's first halo'd band and holds the fused kernel's
    output on it to the plain version. Then the train leg under each
    SPACE_TRAIN_LAYOUTS layout of ``world`` ranks (:func:`space_train`, fp32
    and bf16, then at SPACE_NATIVE_LAYOUT one fp32 step with cuDNN off;
    rank 0 saves the fp32 step-1 gradients), and rank 0 holds the
    fused backward on the first captured halo'd band to its plain
    version; on DQNET_SPACE_LAYOUT's ranks, the DQnet leg
    (:func:`dqnet_space_leg`)."""
    import torch
    import torch.distributed as dist

    from dgtd_tpu_torch.models.cod import cod
    from dgtd_tpu_torch.ops import diffusion as D
    from dgtd_tpu_torch.parallel import space as S
    from dgtd_tpu_torch.parallel import spatial as SP

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores (gloo stages every exchange there)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    model = cod(seed=None)
    model.load_state_dict(torch.load(weights))
    model = model.cuda()
    grabbed = {}
    planes = SP.diffusion_planes

    def grab(x, w, kernel, steps):
        grabbed.setdefault(x.dtype, (x.clone(), w.clone(), kernel, steps))
        return planes(x, w, kernel, steps)

    out = {}
    for i, (size, batch, (data, spc)) in enumerate(SPACE_CASES):
        if data * spc != world:
            continue
        layout = S.make_space(data, spc)
        img, dep = space_inputs(size, batch)
        for name in ("float32", "bfloat16"):
            model.dtype = getattr(torch, name)
            with S.active_space(layout):
                SP.diffusion_planes = grab
                try:
                    model.predict(img, dep)  # warm-up
                finally:
                    SP.diffusion_planes = planes
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ms = []
                for it in range(SPACE_ITERS):
                    if it == 0:
                        reset_plane_launches(D)
                        layout.reset_counts()
                    dist.barrier()
                    t0 = time.perf_counter()
                    prob = model.predict(img, dep)[0]
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    if it == 0:
                        launches, counts = plane_launches(D), dict(layout.counts)
                peak = torch.cuda.max_memory_allocated()
                full = S.gather_map(prob, size)
                peak_above = peak - base
            if rank == 0:
                torch.save(full.cpu(), os.path.join(out_dir, f"space_{i}_{name}.pt"))
            out[f"{i}_{name}"] = {"band": list(prob.shape), "ms": ms, "launches": launches, "counts": counts,
                                  "peak_memory_bytes": peak, "peak_above_start_bytes": peak_above}
            del prob, full
        del img, dep
        torch.cuda.empty_cache()
    grabbed_bwd = {}
    bwd = D.diffusion_planes_bwd

    def grab_bwd(g, xs, w, kernel):
        grabbed_bwd.setdefault(g.dtype, (g.clone(), xs.clone(), w.clone(), kernel))
        return bwd(g, xs, w, kernel)

    for data, spc in SPACE_TRAIN_LAYOUTS:
        if data * spc != world:
            continue
        layout = S.make_space(data, spc)
        for name in ("float32", "bfloat16"):
            keep = rank == 0 and name == "float32"
            grads = os.path.join(out_dir, f"space_train_grads_{data}x{spc}.pt") if keep else None
            D.diffusion_planes_bwd = grab_bwd
            try:
                out[f"train_{data}x{spc}_{name}"] = space_train(model, weights, layout, name, grads)
            finally:
                D.diffusion_planes_bwd = bwd
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        if (data, spc) == SPACE_NATIVE_LAYOUT:
            grads = os.path.join(out_dir, f"space_train_grads_native_{data}x{spc}.pt") if rank == 0 else None
            with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
                out[f"train_{data}x{spc}_native"] = space_train(model, weights, layout, "float32", grads, n_steps=1)
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
    if world == DQNET_SPACE_LAYOUT[0] * DQNET_SPACE_LAYOUT[1]:
        del model
        torch.cuda.empty_cache()
        out["dqnet"] = dqnet_space_leg(dqnet_weights, S.make_space(*DQNET_SPACE_LAYOUT), out_dir, rank == 0)
    if rank == 0:
        for dtype, (x, w, kernel, steps) in grabbed.items():
            route = D.plane_route(*x.shape[1:], kernel, dtype, steps)
            out[f"band_check_{dtype}"] = {"planes": list(x.shape), "route": route,
                                          "max_abs_err": check_kernel(D, x, w, kernel, steps,
                                                                      f"fused forward on a halo'd band {dtype}")}
        for dtype, (g, xs, w, kernel) in grabbed_bwd.items():
            route = D.plane_route(*g.shape[1:], kernel, dtype, len(xs))
            out[f"band_check_bwd_{dtype}"] = {"planes": list(g.shape), "route": route,
                                              "max_abs_err": check_bwd(D, g, xs, w, kernel,
                                                                       f"fused backward on a halo'd band {dtype}")}
    with open(os.path.join(out_dir, f"space_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def space_phase(D, card):
    """Phase 27: full-width ``cod`` served under the data×space layout on
    gloo ranks of the card (``space_rank``; NCCL refuses two ranks on one
    GPU) against one process on the same weights and inputs, each case of
    SPACE_CASES in fp32 (TF32 off) and bf16. fp32 within SPACE_FP32_ATOL of
    one process; bf16 within twice one process's own bf16-vs-fp32 gap on
    the batch, at least BF16_ATOL; the stencil a step a rank on the halo'd
    band (the fused kernel), held to its plain version on one band."""
    import torch
    import torch.multiprocessing as mp

    from dgtd_tpu_torch.models.cod import cod
    from dgtd_tpu_torch.models.dqnet import DQnet

    say("phase 27: cod served under the data×space layout (H banded over the space ranks), gloo ranks of the "
        "card vs one process, fp32 (TF32 off) and bf16: " + ", ".join(
            f"{size}² batch {batch} at (data, space) = {layout}" for size, batch, layout in SPACE_CASES)
        + f"; then trained {SPACE_TRAIN_STEPS} steps at {SIZE}², batch {TRAIN_BATCH}, at (data, space) = "
        + " and ".join(map(str, SPACE_TRAIN_LAYOUTS)) + f"; then DQnet served and trained at {DQNET_SPACE_LAYOUT}")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model = cod(seed=0)
    model_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    ranks = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_space_")
    weights = os.path.join(tmp.name, "cod_seed0.pt")
    torch.save(model.state_dict(), weights)
    model = model.cuda()
    single = {}
    for i, (size, batch, _) in enumerate(SPACE_CASES):
        if any(j < i and SPACE_CASES[j][:2] == (size, batch) for j in range(len(SPACE_CASES))):
            continue
        img, dep = space_inputs(size, batch)
        for name in ("float32", "bfloat16"):
            model.dtype = getattr(torch, name)
            model.predict(img, dep)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = []
            for _ in range(SPACE_ITERS):
                t0 = time.perf_counter()
                prob = model.predict(img, dep)[0]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            single[(size, batch, name)] = {"prob": prob.float().cpu(), "ms": ms,
                                           "peak_above_start_bytes": torch.cuda.max_memory_allocated() - base}
        del img, dep, prob
    single_train = {name: space_train(model, weights, None, name,
                                      os.path.join(tmp.name, "space_train_grads_1.pt") if name == "float32" else None)
                    for name in ("float32", "bfloat16")}
    # the card's own spread: cuDNN's fp32 convolutions (TF32 off) pick their
    # algorithm by shape, and a band is another shape than the whole level;
    # ATen's native convolutions (GEMMs) give a second fp32 gradient, the
    # one the ranks' native step is held to
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        single_train["native"] = space_train(model, weights, None, "float32",
                                             os.path.join(tmp.name, "space_train_grads_native.pt"), n_steps=1)
    model.zero_grad(set_to_none=True)
    del model
    torch.cuda.empty_cache()
    dq = DQnet(seed=0)
    dqnet_bytes = sum(t.numel() * t.element_size() for t in dq.state_dict().values())
    dqnet_weights = os.path.join(tmp.name, "dqnet_seed0.pt")
    torch.save(dq.state_dict(), dqnet_weights)
    del dq
    single_dq = dqnet_space_leg(dqnet_weights, None, tmp.name, True)
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    with tmp:
        for world in sorted({d * s for _, _, (d, s) in SPACE_CASES}):
            out = os.path.join(tmp.name, f"w{world}")
            os.makedirs(out)
            mp.spawn(space_rank, args=(world, os.path.join(out, "init"), out, weights, dqnet_weights), nprocs=world)
            ranks[world] = [read_json(os.path.join(out, f"space_{r}.json")) for r in range(world)]
            for i, (size, batch, (data, spc)) in enumerate(SPACE_CASES):
                if data * spc == world:
                    for name in ("float32", "bfloat16"):
                        single[(i, name)] = torch.load(os.path.join(out, f"space_{i}_{name}.pt")).float()
        band_checks = {k: v for k, v in ranks[min(ranks)][0].items() if k.startswith("band_check")}
        train = space_train_checks(tmp.name, ranks, single_train, card)
        dqnet = dqnet_space_checks(tmp.name, ranks, single_dq, dqnet_bytes, card)
    cases = {}
    for i, (size, batch, (data, spc)) in enumerate(SPACE_CASES):
        world = data * spc
        ref32, ref16 = single[(size, batch, "float32")], single[(size, batch, "bfloat16")]
        gap = (ref16["prob"] - ref32["prob"]).abs()
        row = {"size": size, "batch": batch, "data": data, "space": spc, "ranks": world,
               "bf16_vs_fp32_gap": {"max": float(gap.max()), "mean_abs": float(gap.mean())}}
        for name, ref in (("float32", ref32), ("bfloat16", ref16)):
            got = single[(i, name)]
            check(tuple(got.shape) == tuple(ref["prob"].shape) and bool(torch.isfinite(got).all()),
                  f"space {size}² {(data, spc)} {name}: gathered {tuple(got.shape)}")
            diff = (got - ref["prob"]).abs()
            err, mean_err = float(diff.max()), float(diff.mean())
            bar = SPACE_FP32_ATOL if name == "float32" else max(BF16_ATOL, 2 * float(gap.max()))
            per_rank = [r[f"{i}_{name}"] for r in ranks[world]]
            for r, pr in enumerate(per_rank):
                check(tuple(pr["launches"]) == launch_tuple("fused", STEPS),
                      f"space {size}² {(data, spc)} {name} rank {r}: launches {pr['launches']}")
                check(pr["counts"]["banded"] > 0 and pr["counts"]["halos"] > 0, pr["counts"])
            row[name] = {"max_abs_err": err, "mean_abs_err": mean_err, "limit": bar,
                         "one_process_ms": ref["ms"],
                         "one_process_peak_above_start_bytes": ref["peak_above_start_bytes"],
                         "model_bytes": model_bytes, "ranks": per_rank}
            c = per_rank[0]["counts"]
            say(f"  {size}² batch {batch}, (data, space) = ({data}, {spc}), {name}: max_abs_err {err:.3e} (limit "
                f"{bar:.3e}), mean abs {mean_err:.3e}; band {per_rank[0]['band']}; ms a batch a rank "
                f"{[[round(t, 1) for t in pr['ms']] for pr in per_rank]} vs one process "
                f"{[round(t, 1) for t in ref['ms']]}; peak memory of a batch above the weights and inputs a rank "
                f"{[round(pr['peak_above_start_bytes'] / 2**30, 3) for pr in per_rank]} GiB vs one process "
                f"{ref['peak_above_start_bytes'] / 2**30:.3f} (the weights {model_bytes / 2**30:.3f}); layers "
                f"banded {c['banded']}, replicated "
                f"{c['replicated']}, whole-level ops {c['full']}; gathers {c['gathers']} "
                f"({c['gather_bytes'] / 1e6:.1f} MB), halo exchanges {c['halos']} ({c['halo_bytes'] / 1e6:.2f} MB), "
                f"reductions {c['reductions']}; stencil launches a rank ({LAUNCH_NAMES}) {per_rank[0]['launches']} "
                f"[{card}]")
            check(err <= bar, f"space {size}² {(data, spc)} {name}: {err:.3e} > {bar:.3e}")
        cases[f"{size}_{data}x{spc}"] = row
    for key, bc in band_checks.items():
        check(bc["route"] == "fused", f"{key}: route {bc['route']}")
        say(f"  {key}: halo'd planes {bc['planes']} on the {bc['route']} kernel, max_abs_err {bc['max_abs_err']:.3e}")
    check({"band_check_bwd_torch.float32", "band_check_bwd_torch.bfloat16"} <= set(band_checks),
          f"no captured backward band: {sorted(band_checks)}")
    return {"model": "cod, full width (PVTv2-b2, ConvNeXt-B), seed 0", "backend": "gloo (ranks share the card)",
            "cases": cases, "train": train, "band_checks": band_checks, "dqnet": dqnet,
            "phase_s": time.perf_counter() - t_phase, "card": card}


def grad_gap(got, ref_grads):
    """How far the step-1 gradients ``got`` lie from ``ref_grads``: the
    largest difference over its parameter's scale (a floor of 1e-4 of the
    largest gradient) and that parameter, its difference and its scale over
    the largest gradient, the relative L2 norm of every gradient's
    difference, and the GRAD_GAP_TOP farthest parameters with their
    differences over their scales."""
    check(set(got) == set(ref_grads), "train: the parameters with a gradient differ")
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    each = sorted(((float((got[n] - ref).abs().max()) / max(float(ref.abs().max()), 1e-4 * scale), n)
                   for n, ref in ref_grads.items()), reverse=True)
    to_scale, name = each[0]
    ref = ref_grads[name]
    num = sum(float(((got[n] - r).double() ** 2).sum()) for n, r in ref_grads.items())
    den = sum(float((r.double() ** 2).sum()) for r in ref_grads.values())
    return {"to_scale": to_scale, "param": name,
            "param_diff_to_largest": float((got[name] - ref).abs().max()) / scale,
            "param_scale_to_largest": float(ref.abs().max()) / scale, "rel_l2": (num / den) ** 0.5,
            "top": [[n, d] for d, n in each[:GRAD_GAP_TOP]]}


def top_text(gap):
    return ", ".join(f"{n} {d:.3e}" for n, d in gap["top"])


def gap_text(gap):
    return (f"{gap['to_scale']:.3e} of their scale at the most ({gap['param']}, whose gradient is "
            f"{gap['param_scale_to_largest']:.2e} of the largest and differs by {gap['param_diff_to_largest']:.2e} "
            f"of it); relative L2 {gap['rel_l2']:.3e}")


def space_train_checks(tmp, ranks, single, card):
    """Phase 27's train leg against one process: the fp32 loss terms of
    every step within SPACE_TRAIN_LOSS_RTOL; rank 0's step-1 gradients
    (the world's average), with cuDNN on both sides and, at
    SPACE_NATIVE_LAYOUT, with it off on both, each within twice one process's own cuDNN-vs-native spread of
    its scale (at least SPACE_TRAIN_GRAD_RTOL); the bf16 losses within
    twice one process's own bf16-vs-fp32 gap (at least BF16_ATOL); every rank bit-equal after the steps, 4 fused
    forwards and 4 fused backwards a step (one process: 1 + 1). Prints
    and returns a row a layout."""
    import torch

    refs = {"cudnn": torch.load(os.path.join(tmp, "space_train_grads_1.pt")),
            "native": torch.load(os.path.join(tmp, "space_train_grads_native.pt"))}

    spread = grad_gap(refs["native"], refs["cudnn"])
    grad_bar = max(SPACE_TRAIN_GRAD_RTOL, 2 * spread["to_scale"])
    say(f"  train: one process's fp32 step-1 gradients, cuDNN vs ATen's native convolutions: {gap_text(spread)}: "
        f"the card's own spread between two fp32 convolution algorithms; the layouts' bar {grad_bar:.3e}")
    one32, one16 = single["float32"], single["bfloat16"]
    for run in (one32, one16):
        check(all(tuple(st["launches"]) == launch_tuple("fused", 1, 1) for st in run["steps"]),
              f"one process: launches {[st['launches'] for st in run['steps']]}")
    rows = {}
    for data, spc in SPACE_TRAIN_LAYOUTS:
        world, key = data * spc, f"{data}x{spc}"
        gaps = {}
        convs = ("cudnn", "native") if (data, spc) == SPACE_NATIVE_LAYOUT else ("cudnn",)
        for conv in convs:
            path = f"space_train_grads_{key}.pt" if conv == "cudnn" else f"space_train_grads_native_{key}.pt"
            gaps[conv] = grad_gap(torch.load(os.path.join(tmp, f"w{world}", path)), refs[conv])
            say(f"  train {key}: step-1 gradients with {CONV_NAMES[conv]} convolutions on both sides: "
                f"{gap_text(gaps[conv])} (bar {grad_bar:.3e})")
            check(gaps[conv]["to_scale"] <= grad_bar, f"train {key} {conv}: gradient {gaps[conv]['param']} at "
                                                      f"{gaps[conv]['to_scale']:.3e} of its scale (bar {grad_bar:.3e})")
        row = {"data": data, "space": spc, "ranks": world, "rows_a_rank": TRAIN_BATCH // data, "grad_bar": grad_bar,
               "grad_gap_cudnn": gaps["cudnn"], "grad_gap_native": gaps.get("native"),
               "one_process_cudnn_vs_native": spread,
               "native_ms": [st["ms"] for st in ranks[world][0].get(f"train_{key}_native", {}).get("steps", [])],
               "one_process_native_ms": [st["ms"] for st in single["native"]["steps"]]}
        for name, one in (("float32", one32), ("bfloat16", one16)):
            per_rank = [r[f"train_{key}_{name}"] for r in ranks[world]]
            errs = []
            for i, st in enumerate(one["steps"]):
                ref = st["losses"]["loss"]
                bar = (SPACE_TRAIN_LOSS_RTOL * abs(ref) if name == "float32" else
                       max(BF16_ATOL, 2 * abs(ref - one32["steps"][i]["losses"]["loss"])))
                for r, pr in enumerate(per_rank):
                    got = pr["steps"][i]["losses"]
                    err = abs(got["loss"] - ref)
                    errs.append(err)
                    check(err <= bar, f"train {key} {name} step {i + 1} rank {r}: loss {got['loss']} vs one "
                                      f"process {ref} (bar {bar:.3e})")
                    check(tuple(pr["steps"][i]["launches"]) == launch_tuple("fused", STEPS, STEPS),
                          f"train {key} {name} rank {r} step {i + 1}: launches {pr['steps'][i]['launches']}")
            for r, pr in enumerate(per_rank):
                check(pr["bit_equal"], f"train {key} {name}: rank {r}'s parameters or statistics differ")
            c = per_rank[0]["steps"][0]["counts"]
            check(c["banded"] > 0 and c["halos"] > 0 and c["grad_exchanges"] > 0, f"train {key} {name}: counts {c}")
            row[name] = {"max_loss_err": max(errs), "one_process": one, "ranks": per_rank}
            say(f"  train {key} {name}: {SPACE_TRAIN_STEPS} steps at batch {TRAIN_BATCH} ({TRAIN_BATCH // data} rows "
                f"a rank), losses {[round(st['losses']['loss'], 6) for st in per_rank[0]['steps']]} vs one process "
                f"{[round(st['losses']['loss'], 6) for st in one['steps']]} (largest difference {max(errs):.3e}); "
                f"ms a step a rank {[[round(st['ms'], 1) for st in pr['steps']] for pr in per_rank]} vs one process "
                f"{[round(st['ms'], 1) for st in one['steps']]}; peak memory a rank "
                f"{[round(pr['peak_memory_bytes'] / 2**30, 2) for pr in per_rank]} GiB vs one process "
                f"{one['peak_memory_bytes'] / 2**30:.2f}; a step: banded {c['banded']}, replicated {c['replicated']}, "
                f"whole-level ops {c['full']}; forward gathers {c['gathers']} ({c['gather_bytes'] / 1e6:.1f} MB), "
                f"halos {c['halos']} ({c['halo_bytes'] / 1e6:.1f} MB), reductions {c['reductions']}; backward "
                f"exchanges {c['grad_exchanges']} ({c['grad_bytes'] / 1e6:.1f} MB); stencil launches a rank a step "
                f"{per_rank[0]['steps'][0]['launches']}; the ranks bit-equal [{card}]")
        rows[key] = row
    return rows


def dqnet_space_checks(tmp, ranks, single, model_bytes, card):
    """Phase 27's DQnet leg against one process: the served fp32
    probability within SPACE_FP32_ATOL and the bf16 one within twice one
    process's own bf16-vs-fp32 gap (at least BF16_ATOL); the fp32 losses of
    every step within SPACE_TRAIN_LOSS_RTOL; rank 0's step-1 gradients
    (the world's average), with cuDNN on both sides and with ATen's native
    convolutions on both, within twice one process's own cuDNN-vs-native
    spread of their scale (at least SPACE_TRAIN_GRAD_RTOL); the ranks
    bit-equal; no stencil, NHWC or MSDA launch anywhere. Prints and
    returns the ``space`` line's ``dqnet`` entry."""
    import torch

    data, spc = DQNET_SPACE_LAYOUT
    world = data * spc
    per_rank = [r["dqnet"] for r in ranks[world]]
    none = NO_LAUNCHES + (0,) * 6
    for who, run in [("one process", single)] + [(f"rank {r}", pr) for r, pr in enumerate(per_rank)]:
        for name in ("float32", "bfloat16"):
            check(tuple(run[name]["launches"]) == none, f"DQnet served {name} {who}: launches {run[name]['launches']}")
        for key in ("train", "native"):
            check(all(tuple(st["launches"]) == NO_LAUNCHES for st in run[key]["steps"])
                  and tuple(run[key]["other_launches"]) == (0,) * 6,
                  f"DQnet {key} {who}: launches {[st['launches'] for st in run[key]['steps']]} "
                  f"{run[key]['other_launches']}")
    ref = {name: torch.load(os.path.join(tmp, f"dqnet_one_{name}.pt")) for name in ("float32", "bfloat16")}
    gap = (ref["bfloat16"] - ref["float32"]).abs()
    row = {"model": "DQnet, full width (PVTv2-b2, channel 32, cross_size 44), seed 0", "data": data, "space": spc,
           "ranks": world, "size": SIZE, "batch": BATCH, "model_bytes": model_bytes,
           "bf16_vs_fp32_gap": {"max": float(gap.max()), "mean_abs": float(gap.mean())}}
    for name in ("float32", "bfloat16"):
        got = torch.load(os.path.join(tmp, f"w{world}", f"dqnet_space_{name}.pt"))
        check(tuple(got.shape) == tuple(ref[name].shape) and bool(torch.isfinite(got).all()),
              f"DQnet space {name}: gathered {tuple(got.shape)}")
        diff = (got - ref[name]).abs()
        err = float(diff.max())
        bar = SPACE_FP32_ATOL if name == "float32" else max(BF16_ATOL, 2 * float(gap.max()))
        c = per_rank[0][name]["counts"]
        check(c["banded"] > 0 and c["halos"] > 0 and c["full"] > 0, f"DQnet {name}: counts {c}")
        row[name] = {"max_abs_err": err, "mean_abs_err": float(diff.mean()), "limit": bar,
                     "one_process": single[name], "ranks": [pr[name] for pr in per_rank]}
        say(f"  DQnet {SIZE}² batch {BATCH}, (data, space) = {DQNET_SPACE_LAYOUT}, {name}: max_abs_err {err:.3e} "
            f"(limit {bar:.3e}); band {per_rank[0][name]['band']}; ms a batch a rank "
            f"{[[round(t, 1) for t in pr[name]['ms']] for pr in per_rank]} vs one process "
            f"{[round(t, 1) for t in single[name]['ms']]}; peak memory of a batch above the weights and inputs a "
            f"rank {[round(pr[name]['peak_above_start_bytes'] / 2**30, 3) for pr in per_rank]} GiB vs one process "
            f"{single[name]['peak_above_start_bytes'] / 2**30:.3f} (the weights {model_bytes / 2**30:.3f}); layers "
            f"banded {c['banded']}, replicated {c['replicated']}, whole-level ops {c['full']}; gathers "
            f"{c['gathers']} ({c['gather_bytes'] / 1e6:.1f} MB), halo exchanges {c['halos']} "
            f"({c['halo_bytes'] / 1e6:.2f} MB), reductions {c['reductions']}; no stencil, NHWC or MSDA launch [{card}]")
        check(err <= bar, f"DQnet space {name}: {err:.3e} > {bar:.3e}")
    one, one_native = single["train"], single["native"]
    refs = {k: torch.load(os.path.join(tmp, f"dqnet_one_{k}_grads.pt")) for k in ("train", "native", "nudged")}
    spread = grad_gap(refs["native"], refs["train"])
    grad_bar = max(SPACE_TRAIN_GRAD_RTOL, 2 * spread["to_scale"])
    say(f"  DQnet train: one process's fp32 step-1 gradients, cuDNN vs ATen's native convolutions: "
        f"{gap_text(spread)}; farthest {top_text(spread)}; the bar {grad_bar:.3e}")
    nudged = grad_gap(refs["nudged"], refs["train"])
    say(f"  DQnet train: one process's cuDNN step-1 gradients, every input pixel one ulp up vs as it was: "
        f"{gap_text(nudged)}; farthest {top_text(nudged)}")
    gaps = {}
    for key, conv in (("train", "cudnn"), ("native", "native")):
        gaps[conv] = grad_gap(torch.load(os.path.join(tmp, f"w{world}", f"dqnet_space_{key}_grads.pt")), refs[key])
        say(f"  DQnet train {data}x{spc}: step-1 gradients with {CONV_NAMES[conv]} convolutions on both sides: "
            f"{gap_text(gaps[conv])}; farthest {top_text(gaps[conv])} (bar {grad_bar:.3e})")
        check(gaps[conv]["to_scale"] <= grad_bar, f"DQnet train {conv}: gradient {gaps[conv]['param']} at "
                                                  f"{gaps[conv]['to_scale']:.3e} of its scale (bar {grad_bar:.3e})")
    errs = []
    for i, st in enumerate(one["steps"]):
        want = st["losses"]["loss"]
        for r, pr in enumerate(per_rank):
            got = pr["train"]["steps"][i]["losses"]["loss"]
            errs.append(abs(got - want))
            check(errs[-1] <= SPACE_TRAIN_LOSS_RTOL * abs(want),
                  f"DQnet train step {i + 1} rank {r}: loss {got} vs one process {want}")
    for r, pr in enumerate(per_rank):
        check(pr["train"]["bit_equal"], f"DQnet train: rank {r}'s parameters or statistics differ")
    c = per_rank[0]["train"]["steps"][0]["counts"]
    check(c["banded"] > 0 and c["halos"] > 0 and c["grad_exchanges"] > 0, f"DQnet train: counts {c}")
    row["train"] = {"max_loss_err": max(errs), "grad_gap_cudnn": gaps["cudnn"], "grad_gap_native": gaps["native"],
                    "one_process_cudnn_vs_native": spread, "one_process_nudged": nudged, "grad_bar": grad_bar,
                    "one_process": one,
                    "one_process_native": one_native, "ranks": [pr["train"] for pr in per_rank],
                    "ranks_native": [pr["native"] for pr in per_rank]}
    say(f"  DQnet train {data}x{spc} float32: {SPACE_TRAIN_STEPS} steps at batch {TRAIN_BATCH}, losses "
        f"{[round(st['losses']['loss'], 6) for st in per_rank[0]['train']['steps']]} vs one process "
        f"{[round(st['losses']['loss'], 6) for st in one['steps']]} (largest difference {max(errs):.3e}); step-1 "
        f"gradients {gaps['cudnn']['to_scale']:.3e} of their scale at the most with cuDNN and "
        f"{gaps['native']['to_scale']:.3e} with native convolutions (the spread {spread['to_scale']:.3e}, bar "
        f"{grad_bar:.3e}); ms a step a rank "
        f"{[[round(st['ms'], 1) for st in pr['train']['steps']] for pr in per_rank]} vs one process "
        f"{[round(st['ms'], 1) for st in one['steps']]}; peak memory a rank "
        f"{[round(pr['train']['peak_memory_bytes'] / 2**30, 2) for pr in per_rank]} GiB vs one process "
        f"{one['peak_memory_bytes'] / 2**30:.2f} (the native step: "
        f"{[round(pr['native']['peak_memory_bytes'] / 2**30, 2) for pr in per_rank]} vs "
        f"{one_native['peak_memory_bytes'] / 2**30:.2f}); a step: banded {c['banded']}, replicated {c['replicated']}, "
        f"whole-level ops {c['full']}; forward gathers {c['gathers']} ({c['gather_bytes'] / 1e6:.1f} MB), halos "
        f"{c['halos']} ({c['halo_bytes'] / 1e6:.1f} MB), reductions {c['reductions']}; backward exchanges "
        f"{c['grad_exchanges']} ({c['grad_bytes'] / 1e6:.1f} MB); no stencil, NHWC or MSDA launch; the ranks "
        f"bit-equal [{card}]")
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    # files that outlive a phase (the trained checkpoint the val phase restores)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_keep_") as keep:
        return run(keep)


def run(keep):
    import copy

    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ROOT)
    from PIL import Image

    from dgtd_tpu_torch import predict as P
    from dgtd_tpu_torch.models import diffusion as MD
    from dgtd_tpu_torch.models.cod import cod
    from dgtd_tpu_torch.models.layers import LayerNorm, LayerNorm2d
    from dgtd_tpu_torch.ops import _build
    from dgtd_tpu_torch.ops import diffusion as D
    from dgtd_tpu_torch.ops import layernorm as L

    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()

    # ---- 1. card and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} x{count}")
    t0 = time.perf_counter()
    _build.build(SOURCES)
    say(f"built {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "ptxas" in line:
                say(f"  {name}: {line.strip()}")

    # ---- 2. kernel vs plain ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase 2: forward kernels (fused, cluster, tiled) vs plain (P={P_MAIN}, {P_LARGE} at {LARGE}, 4 steps); the "
        f"tiled kernels' planes")
    g = torch.Generator(device=dev).manual_seed(0)
    for k, (h, w) in SHAPES:
        p = planes_for((h, w), P_MAIN)
        x = torch.rand(p, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(p, k * k, h, w, generator=g, device=dev), dim=1)
        check_kernel(D, x, wt, k, STEPS, f"fp32 k={k} {h}x{w}")
        check_kernel(D, x.bfloat16(), wt.bfloat16(), k, STEPS, f"bf16 k={k} {h}x{w}")
    tiled_errs = {"fwd": 0.0, "bwd": 0.0}
    for p, (h, w), k, steps, bf16_only in TILED_CHECKS:
        p = p or P_MAIN
        x = torch.rand(p, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(p, k * k, h, w, generator=g, device=dev), dim=1)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16))[int(bf16_only):]:
            err = check_kernel(D, x.to(dt), wt.to(dt), k, steps, f"{name} k={k} ({p},{h},{w}), {steps} steps")
            tiled_errs["fwd"] = max(tiled_errs["fwd"], err)
        del x, wt
    torch.cuda.empty_cache()

    # ---- 3. the served path ----
    say(f"phase 3: serve full-width cod at {SIZE}², batch {BATCH}, {N_IMAGES} images")
    captured = {}
    run = {"name": None}
    probs = {}
    ln_calls = {}

    def capture(module, inputs, output):
        if isinstance(module, MD.MessagePassing) and run["name"] not in captured:
            captured[run["name"]] = (inputs[0].detach().clone(), inputs[1].detach().clone())
        if isinstance(module, LayerNorm):  # LayerNorm2d too, once a call
            ln_calls[run["name"]] = ln_calls.get(run["name"], 0) + 1

    predict_unspied = cod.predict

    def spy_predict(self, image, depth, out_size=None):
        out = predict_unspied(self, image, depth, out_size)
        probs.setdefault(run["name"], []).append(out[0])
        return out

    summaries, launches, ln_served = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model = cod(seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        ckpt = os.path.join(tmp, "cod_seed0.pth")
        torch.save(model.state_dict(), ckpt)
        write_inputs(tmp)
        say(f"  cod: {n_params} parameters, seeded init saved to a .pth")
        hook = torch.nn.modules.module.register_module_forward_hook(capture)
        cod.predict = spy_predict
        try:
            for name, extra in (("bf16", []), ("fp32", ["--fp32"])):
                out_dir = os.path.join(tmp, f"out_{name}")
                argv = ["--checkpoint", ckpt, "--image-dir", os.path.join(tmp, "img"),
                        "--depth-dir", os.path.join(tmp, "dep"), "--out-dir", out_dir,
                        "--size", str(SIZE), "--batch", str(BATCH)] + extra
                run["name"] = name
                reset_plane_launches(D)
                L.LAUNCHES = 0
                summaries[name] = P.main(argv)
                launches[name] = plane_launches(D)
                ln_served[name] = (L.LAUNCHES, ln_calls.get(name, 0))
                torch.cuda.synchronize()
                nb = summaries[name]["batches"]
                say(f"  {name}: {summaries[name]['images']} images in {nb} batches, "
                    f"loop {summaries[name]['loop_s']:.3f} s, stencil launches ({LAUNCH_NAMES}) {launches[name]}, "
                    f"LayerNorm kernel launches {ln_served[name][0]} for {ln_served[name][1]} LayerNorm calls")
                check(launches[name] == launch_tuple("fused", nb), (name, launches[name], nb))
                # every LayerNorm of the served forward (PVTv2-b2 and ConvNeXt-B:
                # 93 a batch) is one launch of the kernel
                check(ln_served[name][1] == LN_SERVED_CALLS * nb and ln_served[name][0] == ln_served[name][1],
                      f"{name} served: {ln_served[name][0]} LayerNorm kernel launches for {ln_served[name][1]} "
                      f"LayerNorm calls in {nb} batches")
                outs = sorted(os.listdir(out_dir))
                check(len(outs) == N_IMAGES and all(f.endswith("_output.png") for f in outs), outs)
                for f in outs:
                    with Image.open(os.path.join(out_dir, f)) as im:
                        check(im.size == (SIZE, SIZE) and im.mode == "L", (f, im.size, im.mode))
        finally:
            cod.predict = predict_unspied
            hook.remove()

    means = {}
    for name, chunks in probs.items():
        p = torch.cat(chunks)[:N_IMAGES].float()
        check(p.shape == (N_IMAGES, SIZE, SIZE, 1), p.shape)
        check(bool(torch.isfinite(p).all()) and float(p.min()) >= 0 and float(p.max()) <= 1, name)
        means[name] = float(p.mean())
    gap = abs(means["bf16"] - means["fp32"])
    say(f"  mean probability bf16 {means['bf16']:.6f} fp32 {means['fp32']:.6f} |diff| {gap:.2e} (limit {MEAN_ATOL})")
    check(gap <= MEAN_ATOL, f"bf16 vs fp32 mean probability {gap:.2e} > {MEAN_ATOL}")

    # fp32 on the card vs the same weights on the CPU (plain stencil), small input
    g_cpu = torch.Generator().manual_seed(1)
    img = torch.randn(1, 192, 192, 3, generator=g_cpu)
    depth = torch.rand(1, 192, 192, 1, generator=g_cpu)
    model32 = cod(dtype=torch.float32, seed=0)
    ref = model32.predict(img, depth)[0]
    got = model32.to(dev).predict(img.to(dev), depth.to(dev))[0].cpu()
    cpu_err = float((got - ref).abs().max())
    say(f"  fp32 card vs CPU, 1x192x192: max_abs_err {cpu_err:.3e} (limit {CPU_PROB_ATOL})")
    check(cpu_err <= CPU_PROB_ATOL, f"card vs CPU {cpu_err:.2e} > {CPU_PROB_ATOL}")

    # ---- 4. kernel vs plain on the served path's own tensors ----
    say("phase 4: fused kernel vs plain on captured MessagePassing inputs")
    served = {}
    for name in ("bf16", "fp32"):
        x, weight = captured[name]
        xp, wt = MD.affinity_planes(x, weight, KERNEL)
        check(tuple(xp.shape) == (P_MAIN, 12, 12), xp.shape)
        say(f"  {name} run: x {tuple(xp.shape)} {xp.dtype}, w {tuple(wt.shape)} {wt.dtype}")
        served[name] = (xp, wt, check_kernel(D, xp, wt, KERNEL, STEPS, f"served {name}"))
    check(served["bf16"][0].dtype == torch.bfloat16 and served["fp32"][0].dtype == torch.float32,
          "the bf16 run's stencil ran in bf16 and the fp32 run's in fp32")

    # ---- 5. timings ----
    say("phase 5: timings (CUDA events around calls back to back)")
    # (label, row, key, call, kernel name, calls): the profiler reads each
    # call's device time at the end (phase 14)
    rows, device_calls = {}, []
    for name in ("bf16", "fp32"):
        xp, wt, err = served[name]
        # (the tensors bound now: the calls run again at the end)
        fused = functools.partial(D.diffusion_planes, xp, wt, KERNEL, STEPS)
        # the per-step kernels on the same tensors, as the op ran them before
        # the fused kernel, for a comparison within one call
        per_step = lambda xp=xp, wt=wt: D._per_step_forward(xp, wt, KERNEL, STEPS, None, torch.empty_like(xp))
        ms, step_ms = cuda_time_ms(fused, 200), cuda_time_ms(per_step, 200)
        # the host layers of a call: through the autograd Function (as a call
        # that records a gradient pays it), and the launch wrapper alone
        function_ms = cuda_time_ms(lambda: D.DiffusionPlanesFn.apply(xp, wt, KERNEL, STEPS), 200)
        launch_ms = cuda_time_ms(lambda: D._fused_forward(xp, wt, KERNEL, STEPS, None, torch.empty_like(xp)), 200)
        plain_ms = cuda_time_ms(lambda: D.diffusion_planes_plain(xp, wt, KERNEL, STEPS), 200)
        bound_ms, bound_by = stencil_bound(xp, wt, KERNEL, STEPS)
        rows[name] = dict(ms=ms, function_ms=function_ms, launch_ms=launch_ms, per_step_ms=step_ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, err=err)
        say(f"  stencil {name} ({STEPS} steps, {P_MAIN}x12x12, k={KERNEL}): fused {ms:.5f} ms per call (through the "
            f"Function {function_ms:.5f}, launch wrapper alone {launch_ms:.5f}); per-step kernels {step_ms:.5f} ms "
            f"per call; plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
        device_calls += [(f"fused forward {name}", rows[name], "device_ms", fused, "stencil_fused_fwd", 200),
                         (f"per-step forward {name}", rows[name], "per_step_device_ms", per_step, "stencil_step_kernel", 200)]

    model.to(dev)
    g_dev = torch.Generator(device=dev).manual_seed(2)
    img = torch.randn(BATCH, SIZE, SIZE, 3, generator=g_dev, device=dev)
    depth = torch.rand(BATCH, SIZE, SIZE, 1, generator=g_dev, device=dev)
    served_ms = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model.dtype = dtype
        served_ms[name] = cuda_time_ms(lambda: model.predict(img, depth), 20, warmup=3)
    say(f"served: cod bf16 {served_ms['bf16']:.3f} ms/batch, {BATCH * 1e3 / served_ms['bf16']:.2f} images/s; "
        f"fp32 {served_ms['fp32']:.3f} ms/batch, {BATCH * 1e3 / served_ms['fp32']:.2f} images/s "
        f"(batch {BATCH}, {SIZE}², model.predict back to back) [{card}]")

    # ---- 6. backward kernel vs plain backward ----
    say(f"phase 6: backward kernels (fused, cluster, tiled) vs plain backward (P={P_TRAIN}, {P_LARGE} at {LARGE}); "
        f"the tiled kernels' planes")
    for k, (h, w) in SHAPES:
        p = planes_for((h, w), P_TRAIN)
        x = torch.rand(p, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(p, k * k, h, w, generator=g, device=dev), dim=1)
        gr = torch.rand(p, h, w, generator=g, device=dev)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            xd, wd, gd = x.to(dt), wt.to(dt), gr.to(dt)
            check_bwd(D, gd, [xd], wd, k, f"{name} k={k} {h}x{w}, 1 step")
            check_bwd(D, gd, step_inputs(D, xd, wd, k, STEPS), wd, k, f"{name} k={k} {h}x{w}, {STEPS} steps")
    for p, (h, w), k, steps, bf16_only in TILED_CHECKS:
        p = p or P_TRAIN
        x = torch.rand(p, h, w, generator=g, device=dev)
        wt = MD.normalize_affinity(torch.rand(p, k * k, h, w, generator=g, device=dev), dim=1)
        gr = torch.rand(p, h, w, generator=g, device=dev)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16))[int(bf16_only):]:
            xd, wd, gd = x.to(dt), wt.to(dt), gr.to(dt)
            for n in (1, steps):
                err = check_bwd(D, gd, step_inputs(D, xd, wd, k, n), wd, k,
                                f"{name} k={k} ({p},{h},{w}), {n} step{'s' if n > 1 else ''}")
                tiled_errs["bwd"] = max(tiled_errs["bwd"], err)
        del x, wt, gr, xd, wd, gd
    torch.cuda.empty_cache()
    for name, dt, tol in (("fp32", torch.float32, BWD_FP32_TOL), ("bf16", torch.bfloat16, AUTOGRAD_BF16_TOL)):
        x = torch.rand(P_TRAIN, 12, 12, generator=g, device=dev).to(dt)
        wt = MD.normalize_affinity(torch.rand(P_TRAIN, KERNEL ** 2, 12, 12, generator=g, device=dev), dim=1).to(dt)
        gout = torch.rand(P_TRAIN, 12, 12, generator=g, device=dev).to(dt)
        xa, wa = x.clone().requires_grad_(), wt.clone().requires_grad_()
        xb, wb = x.clone().requires_grad_(), wt.clone().requires_grad_()
        before = plane_launches(D)
        D.diffusion_planes(xa, wa, KERNEL, STEPS).backward(gout)
        torch.cuda.synchronize()
        check(plane_launches(D) == tuple(b + a for b, a in zip(before, launch_tuple("fused", 1, 1))),
              f"Function {name}: launches {before} -> {plane_launches(D)}")
        D.diffusion_planes_plain(xb, wb, KERNEL, STEPS).backward(gout)
        err = 0.0
        for gname, got, ref in (("dx", xa.grad, xb.grad), ("dw", wa.grad, wb.grad)):
            torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"Function {name} {gname}: {m}")
            err = max(err, float((got.float() - ref.float()).abs().max()))
        say(f"  Function {name}, {STEPS} steps, vs autograd through the plain forward: max_abs_err={err:.3e}")

    # ---- 7. tiny cod: loss and gradients, card vs CPU ----
    say("phase 7: tiny cod loss and every parameter gradient, fp32 card (TF32 off) vs CPU, grids 8, 64 and 96")
    for grid in (TINY["grid"], GRID64[0], LARGE[0]):
        m_cpu = cod(dtype=torch.float32, seed=0, **{**TINY, "grid": grid})
        m_dev = copy.deepcopy(m_cpu).to(dev)
        rng = np.random.RandomState(5)
        inputs = [torch.from_numpy(a) for a in (
            rng.randn(2, 64, 64, 3).astype(np.float32), rng.rand(2, 64, 64, 1).astype(np.float32),
            (rng.rand(2, 64, 64, 1) > 0.5).astype(np.float32))]
        loss_cpu = m_cpu.loss(*inputs)[0]
        loss_cpu.backward()
        reset_plane_launches(D)
        loss_dev = m_dev.loss(*[t.to(dev) for t in inputs])[0]
        loss_dev.backward()
        torch.cuda.synchronize()
        route = D.plane_route(grid, grid, KERNEL, torch.float32, STEPS)
        check(plane_launches(D) == launch_tuple(route, 1, 1), f"tiny cod grid {grid}: launches {plane_launches(D)}")
        loss_cpu, loss_dev = loss_cpu.item(), loss_dev.item()
        check(abs(loss_dev - loss_cpu) <= TINY_LOSS_RTOL * abs(loss_cpu), f"tiny loss card {loss_dev} vs CPU {loss_cpu}")
        grads_cpu = dict(m_cpu.named_parameters())
        scale = max(float(p.grad.abs().max()) for p in grads_cpu.values())
        worst = (0.0, "")
        for n, p in m_dev.named_parameters():
            ref = grads_cpu[n].grad
            diff = float((p.grad.cpu() - ref).abs().max())
            limit = TINY_GRAD_RTOL * max(float(ref.abs().max()), 1e-4 * scale)
            check(diff <= limit, f"grid {grid} gradient of {n}: card vs CPU {diff:.3e} > {limit:.3e}")
            worst = max(worst, (diff / limit, n))
        say(f"  grid {grid} ({route} stencil kernels, launches ({LAUNCH_NAMES}) {plane_launches(D)}): loss card "
            f"{loss_dev:.7f} CPU {loss_cpu:.7f}; {len(grads_cpu)} gradients within {TINY_GRAD_RTOL} of their "
            f"scale (closest to its limit: {worst[1]} at {worst[0]:.3f} of it)")
        del m_cpu, m_dev

    # ---- 8. full-width training through the train CLI ----
    say(f"phase 8: train full-width cod with validation through dgtd_tpu_torch.train.cli.main: configs/cod.yml, "
        f"{TRAIN_N} images at {SIZE}², batch {TRAIN_BATCH}, {TRAIN_EPOCHS} epochs, bf16")
    from dgtd_tpu_torch.core.config import load_config
    from dgtd_tpu_torch.train import cli as TC
    from dgtd_tpu_torch.train import state as S
    from dgtd_tpu_torch.train.loop import Runner
    from dgtd_tpu_torch.train.state import train_step

    model.cpu()
    del model
    torch.cuda.empty_cache()
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    grab = {}
    planes_unspied = MD.diffusion_planes

    def spy_planes(x, w, kernel, steps):
        out = planes_unspied(x, w, kernel, steps)
        if "x" not in grab and out.requires_grad:
            grab["x"], grab["w"] = x.detach().clone(), w.detach().clone()
            out.register_hook(lambda gr: grab.setdefault("g", gr.detach().clone()))
        return out

    val_unspied, val_launches, val_seconds, loader_workers = Runner.val, [], [], []

    def spy_val(self, *args, **kwargs):
        # the stencil's launches and the seconds of the val pass alone; the
        # decode threads of the train and val loaders
        loader_workers.extend(ld._pool._max_workers if ld._pool else 0 for ld in (self.train_loader, self.val_loader))
        before, t0 = plane_launches(D), time.perf_counter()
        out = val_unspied(self, *args, **kwargs)
        torch.cuda.synchronize()
        val_seconds.append(time.perf_counter() - t0)
        val_launches.append(tuple(a - b for a, b in zip(plane_launches(D), before)))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        work = os.path.join(tmp, "run")
        overrides = [
            f"work_dir={work}", f"train_cfg.max_epochs={TRAIN_EPOCHS}", f"train_cfg.val_interval={TRAIN_EPOCHS}",
            f"train_dataloader.batch_size={TRAIN_BATCH}",
            f"train_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {TRAIN_N}, 'size': {SIZE}}}",
            f"val_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {TRAIN_VAL_N}, 'size': {SIZE}, 'seed': 1}}",
            "val_dataloader.batch_size=1",
            "default_hooks.logger.interval=1", "default_hooks.checkpoint.interval=1",
        ]
        argv = [recipe] + [a for o in overrides for a in ("-o", o)]
        MD.diffusion_planes = spy_planes
        Runner.val = spy_val
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_plane_launches(D)
            hosted = S.EAGER_STEPS + S.CAPTURES
            trained = TC.main(argv)
            train_launches = plane_launches(D)
            # the steps whose kernels their wrappers launched (and counted):
            # the eager warm-up and the CUDA graphs' capture; replays call none
            hosted = S.EAGER_STEPS + S.CAPTURES - hosted
            cli_peak = torch.cuda.max_memory_allocated()
        finally:
            MD.diffusion_planes = planes_unspied
            Runner.val = val_unspied
        check(len(val_launches) == 1, f"{len(val_launches)} val passes in {TRAIN_EPOCHS} epochs (val_interval {TRAIN_EPOCHS})")
        check(loader_workers == [TRAIN_WORKERS, TRAIN_WORKERS], f"loader decode threads {loader_workers}")
        train_val_launches = val_launches[0]
        fwd_launches = train_launches[0] - train_val_launches[0]
        bwd_launches = train_launches[1]
        say(f"  {trained['steps']} steps and one val pass in {trained['loop_s']:.3f} s (the val pass "
            f"{val_seconds[0]:.3f} s); stencil launches "
            f"({LAUNCH_NAMES}) {train_launches}, of which the val pass {train_val_launches}; peak memory "
            f"{cli_peak / 2**30:.3f} GiB")
        check(trained["steps"] == TRAIN_STEPS, trained)
        check(train_val_launches == launch_tuple("fused", TRAIN_VAL_N),
              f"val launches {train_val_launches}: one fused forward a val batch of 1, {TRAIN_VAL_N} batches, no backward")
        check(hosted == 2, f"{hosted} of {TRAIN_STEPS} steps eager or captured: expected the warm-up and the capture")
        check(train_launches == launch_tuple("fused", hosted + TRAIN_VAL_N, hosted),
              f"launches {train_launches}: one fused forward and one fused backward a step in the {hosted} steps "
              f"launched from the host, and {TRAIN_VAL_N} val forwards")
        with open(os.path.join(work, "log.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r for r in records if "loss" in r]
        check(len(losses) == TRAIN_STEPS, f"{len(losses)} loss records")
        check(all(np.isfinite([r["loss"], r["loss_seg"], r["loss_ssim"]]).all() for r in losses), losses)
        say("  losses: " + ", ".join(f"{r['loss']:.5f}" for r in losses))
        val_records = [r for r in records if "COD/Smeasure" in r]
        check(len(val_records) == 1 and val_records[0]["epoch"] == TRAIN_EPOCHS, f"val records {val_records}")
        train_val = val_records[0]
        check(all(np.isfinite(train_val[f"COD/{m}{s}"]) for m in VAL_METRICS for s in ("", "_strict")), train_val)
        say("  val after epoch {}: {}".format(TRAIN_EPOCHS, ", ".join(f"{m} {train_val[f'COD/{m}']:.5f}" for m in VAL_METRICS))
            + f", {train_val['val_imgs_per_sec']} images/s [{card}]")
        ckpts = [os.path.join(work, f"epoch_{e}.pth") for e in range(1, TRAIN_EPOCHS + 1)]
        check(all(os.path.exists(c) for c in ckpts), ckpts)
        # the val phase (16) restores this checkpoint
        val_ckpt = os.path.join(keep, "epoch_2.pth")
        shutil.copyfile(ckpts[-1], val_ckpt)
        loaded, missed, unused = P.load_checkpoint(cod(seed=None), ckpts[-1])
        check(not missed and not unused, f"epoch-{TRAIN_EPOCHS} checkpoint: missed {missed[:3]} unused {unused[:3]}")

        serve = os.path.join(tmp, "serve")
        write_inputs(serve, TRAIN_BATCH)
        out_dir = os.path.join(serve, "out")
        reset_plane_launches(D)
        P.main(["--checkpoint", ckpts[-1], "--image-dir", os.path.join(serve, "img"),
                "--depth-dir", os.path.join(serve, "dep"), "--out-dir", out_dir,
                "--size", str(SIZE), "--batch", str(TRAIN_BATCH)])
        check(plane_launches(D) == launch_tuple("fused", 1), f"serving the trained checkpoint: launches {plane_launches(D)}")
        outs = sorted(os.listdir(out_dir))
        check(len(outs) == TRAIN_BATCH, outs)
        for f in outs:
            with Image.open(os.path.join(out_dir, f)) as im:
                check(im.size == (SIZE, SIZE) and im.mode == "L", (f, im.size, im.mode))
        say(f"  epoch-{TRAIN_EPOCHS} checkpoint ({len(loaded)} keys) served {len(outs)} masks")

        # one fp32 first step: same seed, weights, first batch, drop-path masks
        runner = Runner(load_config(recipe, overrides[1:]), work_dir=os.path.join(tmp, "fp32"), seed=0,
                        device=dev, dtype=torch.float32)
        first = next(iter(runner.train_loader))
        batch = {k: first[k] for k in ("input", "label", "depth")}
        loss32 = float(train_step(runner.model, runner.optimizer, batch, 0, runner.seed + 1)["loss"])
        loss16 = losses[0]["loss"]
        rel = abs(loss16 - loss32) / abs(loss32)
        say(f"  first-step loss bf16 {loss16:.5f} fp32 {loss32:.7f} (relative {rel:.2e}, limit {FIRST_LOSS_RTOL})")
        check(rel <= FIRST_LOSS_RTOL, f"bf16 vs fp32 first-step loss {rel:.2e} > {FIRST_LOSS_RTOL}")

    say("  backward kernel vs plain on the stencil inputs and gradient of a train step")
    gx, gw, gg = grab["x"], grab["w"], grab["g"]
    check(tuple(gx.shape) == (P_TRAIN, 12, 12) and gx.dtype == torch.bfloat16 and gg.dtype == torch.bfloat16,
          (gx.shape, gx.dtype, gg.dtype))
    gxs = step_inputs(D, gx, gw, KERNEL, STEPS)
    train_err = check_bwd(D, gg, gxs, gw, KERNEL, f"trained bf16, {STEPS} steps")
    train_err32 = check_bwd(D, gg.float(), [t.float() for t in gxs], gw.float(), KERNEL,
                            f"trained, as fp32, {STEPS} steps")

    # ---- 8b. preemption and the profiler hook, through a train CLI subprocess ----
    preempt_row = preempt_phase(card)

    # ---- 9. timings ----
    say("phase 9: train-step and backward-kernel timings (CUDA events)")
    bwd_rows = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        # the step inputs as the Function saves them: one (steps, P, H, W) tensor
        tg, txs, tw = gg.to(dt), torch.stack(gxs).to(dt), gw.to(dt)
        fused = functools.partial(D.diffusion_planes_bwd, tg, txs, tw, KERNEL)
        per_step = functools.partial(D._per_step_backward, tg, txs, tw, KERNEL)  # the design before, same tensors
        ms, step_ms = cuda_time_ms(fused, 200), cuda_time_ms(per_step, 200)
        launch_ms = cuda_time_ms(lambda: D._fused_backward(tg, txs, tw, KERNEL), 200)
        plain_ms = cuda_time_ms(lambda: D.diffusion_planes_bwd_plain(tg, txs, tw, KERNEL), 50)
        bound_ms, bound_by = stencil_bwd_bound(tg, txs, tw, KERNEL)
        bwd_rows[name] = dict(ms=ms, launch_ms=launch_ms, per_step_ms=step_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        say(f"  stencil backward {name} ({STEPS} steps, {P_TRAIN}x12x12, k={KERNEL}): fused {ms:.5f} ms per call "
            f"(launch wrapper alone {launch_ms:.5f}); per-step kernels {step_ms:.5f} ms per call; plain "
            f"{plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
        device_calls += [(f"fused backward {name}", bwd_rows[name], "device_ms", fused, "stencil_fused_bwd", 200),
                         (f"per-step backward {name}", bwd_rows[name], "per_step_device_ms", per_step, "stencil_bwd_kernel", 200)]
    bwd_rows["fp32"]["err"] = train_err32
    step_ms, peak = {}, {}
    counter = [1]

    def one_step():
        train_step(runner.model, runner.optimizer, batch, counter[0], runner.seed + 1)
        counter[0] += 1

    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        runner.model.dtype = dt
        torch.cuda.reset_peak_memory_stats()
        step_ms[name] = cuda_time_ms(one_step, 6, warmup=3)
        peak[name] = torch.cuda.max_memory_allocated()
        say(f"  train step {name}: {step_ms[name]:.3f} ms, {TRAIN_BATCH * 1e3 / step_ms[name]:.2f} images/s, "
            f"peak memory {peak[name] / 2**30:.3f} GiB (batch {TRAIN_BATCH}, {SIZE}², back to back) [{card}]")

    del runner, batch
    torch.cuda.empty_cache()

    # ---- 10. MSDA kernels vs plain ----
    from dgtd_tpu_torch.ops import msda as A
    from dgtd_tpu_torch.tools import profile_msda

    say("phase 10: MSDA kernels vs plain (forward, dValue, dLocation/dWeight); the forward and dLocation/dWeight "
        "kernels' plan and dValue's (staged levels, channels a load) per case")
    cases = [(c, MSDA_SMALL, dict(lq=40), False) for c in MSDA_CHANNELS]
    cases.append((32, MSDA_FOUR, dict(lq=150, m=8, p=4), False))
    cases += [(c, shapes, kw, False) for c, shapes, kw in MSDA_STAGING]
    cases.append((32, MSDA_FOUR, dict(lq=150, m=8, p=4), True))
    for i, (channels, shapes, kw, misaligned) in enumerate(cases):
        value, loc, aw, gr = msda_inputs(channels, 100 + i, shapes, dev=dev, **kw)
        for name, v, gv in (("fp32", value, gr), ("bf16", value.bfloat16(), gr.bfloat16())):
            if misaligned:
                v, gv = off_16_bytes(v), off_16_bytes(gv)
            plan = A._call_plan(v, shapes, loc, gv)
            dv_plan = A._call_plan(v, shapes, loc, gv, accumulate=True)
            label = (f"{name} D={channels} {len(shapes)} levels{', misaligned base' if misaligned else ''} "
                     f"[staged {list(plan.staged)}, {plan.vec} a load; dValue staged {list(dv_plan.staged)}, "
                     f"{dv_plan.vec} a load]")
            check((plan.vec, dv_plan.vec) == (1, 1) or not misaligned, f"{label}: a misaligned base takes the scalar route")
            errs = check_msda(A, v, loc, aw, gv, shapes, label)
            say(f"  {label}: max_abs_err " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))

    # ---- 11. the MSDeformAttn layer at Deformable DETR's encoder width ----
    say(f"phase 11: MSDeformAttn d_model {ENC_D_MODEL}, {ENC_HEADS} heads, levels {ENC_SHAPES}, {ENC_POINTS} points; "
        f"N={ENC_N}, Lq=S={ENC_S}; {ENC_ITERS} forward+backward iterations, fp32 (TF32 off)")
    layer = A.MSDeformAttn(ENC_D_MODEL, len(ENC_SHAPES), ENC_HEADS, ENC_POINTS, seed=0)
    layer_cpu = copy.deepcopy(layer)
    layer.to(dev)
    rng = np.random.RandomState(11)
    query_np = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    value_np = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    target_np = rng.randn(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)
    refs_np = [rng.rand(ENC_N, ENC_S, len(ENC_SHAPES), 2).astype(np.float32) for _ in range(ENC_ITERS)]
    query, value_in, target = (torch.from_numpy(a).to(dev) for a in (query_np, value_np, target_np))
    op_unspied, grabbed = A.ms_deform_attn, {}

    def spy_op(v, shapes, loc, aw):
        grabbed.setdefault("op", (v.detach().clone(), loc.detach().clone(), aw.detach().clone()))
        return op_unspied(v, shapes, loc, aw)

    def layer_iteration(lay, q, r, v, tgt):
        lay.zero_grad(set_to_none=True)
        q, v = q.clone().requires_grad_(), v.clone().requires_grad_()
        out = lay(q, r, v, ENC_SHAPES)
        loss = ((out.float() - tgt) ** 2).mean()
        loss.backward()
        return out.detach(), loss.detach(), q.grad, v.grad

    A.ms_deform_attn = spy_op
    try:
        first = None
        A.LAUNCHES = A.DVALUE_LAUNCHES = A.DLOCW_LAUNCHES = 0
        for it in range(ENC_ITERS):
            res = layer_iteration(layer, query, torch.from_numpy(refs_np[it]).to(dev), value_in, target)
            if first is None:
                first = (res, {n: p.grad.detach().clone() for n, p in layer.named_parameters()})
        torch.cuda.synchronize()
        msda_launches = {"msda_fwd": A.LAUNCHES, "msda_dvalue": A.DVALUE_LAUNCHES, "msda_dlocw": A.DLOCW_LAUNCHES}
    finally:
        A.ms_deform_attn = op_unspied
    say(f"  launches in {ENC_ITERS} iterations: {msda_launches}")
    for name, n_launch in msda_launches.items():
        check(n_launch == ENC_ITERS, f"{name}: {n_launch} launches in {ENC_ITERS} iterations (one per call)")
    (out_dev, loss_dev, dq_dev, dv_dev), pgrads_dev = first
    check(bool(torch.isfinite(out_dev).all()) and out_dev.shape == (ENC_N, ENC_S, ENC_D_MODEL), out_dev.shape)

    # the CPU run samples at the card's locations: cuBLAS and MKL round the
    # offsets' linear differently, which moves a few of the 1.39M samples
    # across a pixel coordinate, where dLocation jumps; the gradient still
    # flows through the CPU's own locations
    card_loc, pin = grabbed["op"][1].cpu(), {}

    def pinned_op(v, shapes, loc, aw):
        pin["max_loc_diff"] = float((card_loc - loc.detach()).abs().max())
        return op_unspied(v, shapes, loc + (card_loc - loc).detach(), aw)

    t0 = time.perf_counter()
    A.ms_deform_attn = pinned_op
    try:
        out_cpu, loss_cpu, dq_cpu, dv_cpu = layer_iteration(
            layer_cpu, torch.from_numpy(query_np), torch.from_numpy(refs_np[0]), torch.from_numpy(value_np),
            torch.from_numpy(target_np))
    finally:
        A.ms_deform_attn = op_unspied
    cpu_s = time.perf_counter() - t0
    layer_errs = {"out": max_rel_to_scale(out_dev, out_cpu), "d_query": max_rel_to_scale(dq_dev, dq_cpu),
                  "d_value": max_rel_to_scale(dv_dev, dv_cpu)}
    for n, p in layer_cpu.named_parameters():
        layer_errs[f"d_{n}"] = max_rel_to_scale(pgrads_dev[n], p.grad)
    worst = max(layer_errs.items(), key=lambda kv: kv[1])
    say(f"  card vs CPU (plain path, {cpu_s:.1f} s; locations pinned to the card's, which differed by at most "
        f"{pin['max_loc_diff']:.2e}), first iteration: loss {float(loss_dev):.7f} vs {float(loss_cpu):.7f}; "
        f"{len(layer_errs)} tensors within {LAYER_RTOL} of their scale (worst {worst[0]} at {worst[1]:.2e})")
    check(pin["max_loc_diff"] <= LOC_PIN_ATOL,
          f"MSDeformAttn locations: card vs CPU {pin['max_loc_diff']:.2e} > {LOC_PIN_ATOL} (more than rounding)")
    for name, err in layer_errs.items():
        check(err <= LAYER_RTOL, f"MSDeformAttn {name}: card vs CPU {err:.2e} of its scale > {LAYER_RTOL}")
    del layer_cpu, out_cpu, dq_cpu, dv_cpu

    with torch.autocast("cuda", dtype=torch.bfloat16):
        out16, _, dq16, dv16 = layer_iteration(layer, query, torch.from_numpy(refs_np[0]).to(dev), value_in, target)
    torch.cuda.synchronize()
    check(out16.dtype == torch.bfloat16 and bool(torch.isfinite(out16.float()).all()), f"bf16 layer output {out16.dtype}")
    check(bool(torch.isfinite(dq16).all() and torch.isfinite(dv16).all()), "bf16 layer gradients finite")
    say(f"  bf16 autocast iteration: output {out16.dtype} finite, |out - fp32 out| max "
        f"{float((out16.float() - out_dev).abs().max()):.3e} (scale {float(out_dev.abs().max()):.3e})")

    ev, el, ea = grabbed["op"]
    check(ev.shape == (ENC_N, ENC_S, ENC_HEADS, ENC_D_MODEL // ENC_HEADS) and ev.dtype == torch.float32, ev.shape)
    eg = torch.from_numpy(np.random.RandomState(12).rand(ENC_N, ENC_S, ENC_D_MODEL).astype(np.float32)).to(dev)
    enc_errs = check_msda(A, ev, el, ea, eg, ENC_SHAPES, "encoder shape fp32", scale_atol=MSDA_SCALE_ATOL)
    say("  kernels vs plain on the layer's captured tensors: " + ", ".join(f"{k} {e:.3e}" for k, e in enc_errs.items()))
    # the second location set: Deformable DETR's encoder reference points
    # (each level's pixel centres, a query's own point on every level) with
    # the layer's own offsets; the forward and dLocation/dWeight kernels on
    # both sets in fp32 and bf16, each held to the plain versions
    with torch.no_grad():
        grid_set = tuple(t.contiguous() for t in layer.sampling(
            query, profile_msda.encoder_grid_refs(ENC_SHAPES, ENC_N).to(dev), value_in, ENC_SHAPES))
    msda_sets = {}  # (set, dtype) -> kernel -> row; random_reference fp32 is the row timed below
    for set_name, (sv, sl, sa) in (("random_reference", (ev, el, ea)), ("encoder_grid", grid_set)):
        for dt_name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            if (set_name, dt_name) == ("random_reference", "fp32"):
                continue
            v_, g_ = sv.to(dt), eg.to(dt)
            errs = check_msda(A, v_, sl, sa, g_, ENC_SHAPES, f"encoder shape {set_name} {dt_name}",
                              scale_atol=MSDA_SCALE_ATOL)
            rows_, calls_ = msda_timings(A, v_, sl, sa, g_, f"{set_name} {dt_name}", card)
            rows_["msda_fwd"]["err"] = errs["out"]
            rows_["msda_dvalue"]["err"] = errs["dvalue"]
            rows_["msda_dlocw"]["err"] = max(errs["dloc"], errs["daw"])
            msda_sets[(set_name, dt_name)] = rows_
            device_calls += calls_
            say(f"  {set_name} {dt_name} vs plain: " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    del grid_set
    msda_bound = msda_bounds(ev, el, ea, ENC_SHAPES)
    msda_plans = {name: msda_plan_row(A, ev, el, eg, accumulate=name == "msda_dvalue")
                  for name in ("msda_fwd", "msda_dvalue", "msda_dlocw")}
    msda_rows = {}
    # the kernel calls bind their tensors (phase 18 calls them again, after
    # this phase's names are gone)
    timed = {
        "msda_fwd": (functools.partial(A.ms_deform_attn_fwd, ev, ENC_SHAPES, el, ea),
                     lambda: A.ms_deform_attn_plain(ev, ENC_SHAPES, el, ea), ("out",)),
        "msda_dvalue": (functools.partial(A.ms_deform_attn_dvalue, eg, ev, ENC_SHAPES, el, ea),
                        lambda: A.ms_deform_attn_dvalue_plain(eg, ev, ENC_SHAPES, el, ea), ("dvalue",)),
        "msda_dlocw": (functools.partial(A.ms_deform_attn_dlocw, eg, ev, ENC_SHAPES, el, ea),
                       lambda: A.ms_deform_attn_dlocw_plain(eg, ev, ENC_SHAPES, el, ea), ("dloc", "daw")),
    }
    for name, (kern, plain, outs) in timed.items():
        ms = cuda_time_ms(kern, 100)
        plain_ms = cuda_time_ms(plain, 10, warmup=2)
        bound_ms, bound_by = msda_bound[name]
        msda_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               err=max(enc_errs[o] for o in outs))
        device_calls.append((f"{name} random_reference fp32 (phase 11 row)", msda_rows[name], "device_ms", kern,
                             f"{name}_kernel", 100, "per launch"))
        say(f"  {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    grid_sample_ms = cuda_time_ms(lambda: profile_msda.grid_sample_composition(ev, ENC_SHAPES, el, ea), 10, warmup=2)
    say(f"  the reference's per-level F.grid_sample composition (a yardstick, on no path of the port): "
        f"{grid_sample_ms:.5f} ms [{card}]")
    vr, lr, ar = (t.clone().requires_grad_() for t in (ev, el, ea))
    op_fwd_ms = cuda_time_ms(lambda: A.ms_deform_attn(ev, ENC_SHAPES, el, ea), 100)
    op_step_ms = cuda_time_ms(lambda: torch.autograd.grad(A.ms_deform_attn(vr, ENC_SHAPES, lr, ar), (vr, lr, ar), eg), 50)
    op_out = A.ms_deform_attn(vr, ENC_SHAPES, lr, ar)
    op_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(op_out, (vr, lr, ar), eg, retain_graph=True), 50)
    refs1 = torch.from_numpy(refs_np[1]).to(dev)
    layer_step_ms = cuda_time_ms(lambda: layer_iteration(layer, query, refs1, value_in, target), 20, warmup=3)
    say(f"  op forward {op_fwd_ms:.5f} ms, op backward {op_bwd_ms:.5f} ms, op forward+backward {op_step_ms:.5f} ms, layer iteration "
        f"(4 linears, softmax, op, MSE, backward) {layer_step_ms:.5f} ms [{card}]")
    del layer, ev, el, ea, eg, vr, lr, ar, op_out, query, value_in, target, refs1
    torch.cuda.empty_cache()

    # ---- 12. NHWC stencil on tap-major weights ----
    say("phase 12: NHWC stencil (tap-major weights) vs plain: the plane and grid kernels (all the steps of a call in "
        "one launch) and the per-step kernel (k >= 13); gradient through the plane backward kernel; times at "
        f"{', '.join(str(v) for v in NHWC_SHAPES.values())}")

    def nhwc_counts():
        return D.NHWC_PLANE_LAUNCHES, D.NHWC_GRID_LAUNCHES, D.NHWC_LAUNCHES

    def reset_nhwc_counts():
        D.NHWC_PLANE_LAUNCHES = D.NHWC_GRID_LAUNCHES = D.NHWC_LAUNCHES = 0

    def nhwc_want(route):
        return {"plane": (1, 0, 0), "grid": (0, 1, 0), "per_step": (0, 0, STEPS)}[route]

    nhwc_errs = {"plane": 0.0, "grid": 0.0, "per_step": 0.0}
    nhwc_step_launches = None
    for k, (h, w) in SHAPES + NHWC_PER_STEP_SHAPES:
        x = torch.rand(8, h, w, 24, generator=g, device=dev)
        nw = MD.normalize_affinity(torch.rand(8, h, w, 24, k * k, generator=g, device=dev), dim=-1)
        wt = D.to_tap_major(nw)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            route = D.nhwc_route(h, w, k, dt)
            reset_nhwc_counts()
            out = D.diffusion_nhwc_tap_major(x.to(dt), wt.to(dt), k, STEPS)
            torch.cuda.synchronize()
            n = nhwc_counts()
            check(n == nhwc_want(route), f"NHWC {name} k={k} {h}x{w} [{route}]: launches (plane, grid, per-step) {n}, "
                                         f"expected {nhwc_want(route)}")
            if route == "per_step" and dt == torch.bfloat16 and (h, w) == (12, 12):
                nhwc_step_launches = n[2]
            ref = D.diffusion_nhwc_plain(x.to(dt).float(), wt.to(dt).float(), k, STEPS)
            tol = FP32_TOL if dt == torch.float32 else dict(rtol=0, atol=BF16_ATOL)
            torch.testing.assert_close(out.float(), ref, **tol, msg=lambda m: f"NHWC {name} k={k} {h}x{w}: {m}")
            err = float((out.float() - ref).abs().max())
            nhwc_errs[route] = max(nhwc_errs[route], err)
            say(f"  {name} k={k} {h}x{w} [{route}]: launches (plane, grid, per-step) {n}; max_abs_err={err:.3e}")
        del x, nw, wt
    check(nhwc_step_launches == STEPS, f"NHWC per-step route: {nhwc_step_launches} launches for {STEPS} steps")
    x = torch.rand(8, 12, 12, 24, generator=g, device=dev)
    nw = MD.normalize_affinity(torch.rand(8, 12, 12, 24, KERNEL ** 2, generator=g, device=dev), dim=-1)
    gout = torch.rand(8, 12, 12, 24, generator=g, device=dev)
    nhwc_grad_err = {}
    for name, dt, tol in (("fp32", torch.float32, BWD_FP32_TOL), ("bf16", torch.bfloat16, AUTOGRAD_BF16_TOL)):
        xa, wa, xb, wb = (t.to(dt).clone().requires_grad_() for t in (x, nw, x, nw))
        reset_nhwc_counts()
        reset_plane_launches(D)
        D.diffusion_nhwc(xa, wa, KERNEL, STEPS).backward(gout.to(dt))
        torch.cuda.synchronize()
        # one plane-kernel launch for the forward's steps; the backward's
        # 12x12 planes take the fused plane backward: one launch
        nhwc_launches = (D.NHWC_PLANE_LAUNCHES, D.FUSED_BWD_LAUNCHES)
        check(nhwc_launches == (1, 1) and nhwc_counts() == (1, 0, 0) and plane_launches(D) == launch_tuple("fused", 0, 1),
              f"NHWC {name} forward+backward launches {nhwc_launches}, NHWC (plane, grid, per-step) {nhwc_counts()}, "
              f"plane stencil {plane_launches(D)}")
        D.diffusion_nhwc_plain(xb, D.to_tap_major(wb), KERNEL, STEPS).backward(gout.to(dt))
        err = 0.0
        for gname, got, ref in (("dx", xa.grad, xb.grad), ("dw", wa.grad, wb.grad)):
            torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"NHWC {name} {gname}: {m}")
            err = max(err, float((got.float() - ref.float()).abs().max()))
        nhwc_grad_err[name] = err
        say(f"  NHWC {name} x (8,12,12,24), k={KERNEL}, {STEPS} steps: launches forward {nhwc_launches[0]}, "
            f"backward {nhwc_launches[1]}; gradients vs autograd through the plain forward max_abs_err={err:.3e}")
    del x, nw, gout, xa, wa, xb, wb
    # the plane kernel at the served stencil's work, the grid kernel at the
    # grid-96 stencil's and at serving_check's block, each beside the
    # per-step kernel called directly on the same tensors, the launches of
    # a call read around its check; device times in phase 18
    nhwc_rows = {}
    for key, shape, dt, iters in (("bf16", NHWC_SHAPES["served"], torch.bfloat16, 200),
                                  ("fp32", NHWC_SHAPES["served"], torch.float32, 200),
                                  ("grid96_bf16", NHWC_SHAPES["grid96"], torch.bfloat16, 50),
                                  ("serving_check_bf16", NHWC_SHAPES["serving_check"], torch.bfloat16, 10)):
        b_, h, w, c = shape
        xt = torch.rand(shape, generator=g, device=dev).to(dt)
        wt = D.to_tap_major(MD.normalize_affinity(torch.rand(b_, h, w, c, KERNEL ** 2, generator=g, device=dev),
                                                  dim=-1)).to(dt)
        route = D.nhwc_route(h, w, KERNEL, dt)
        reset_nhwc_counts()
        out = D.diffusion_nhwc_tap_major(xt, wt, KERNEL, STEPS)
        torch.cuda.synchronize()
        nhwc_n = nhwc_counts()
        check(nhwc_n == nhwc_want(route), f"NHWC {key} {shape} [{route}]: launches (plane, grid, per-step) {nhwc_n}")
        ref = D.diffusion_nhwc_plain(xt.float(), wt.float(), KERNEL, STEPS)
        tol = FP32_TOL if dt == torch.float32 else dict(rtol=0, atol=BF16_ATOL)
        torch.testing.assert_close(out.float(), ref, **tol, msg=lambda m: f"NHWC {key} {shape}: {m}")
        err = float((out.float() - ref).abs().max())
        del out, ref
        fn = functools.partial(D.diffusion_nhwc_tap_major, xt, wt, KERNEL, STEPS)
        per_step = functools.partial(D._nhwc_per_step_forward, xt, wt, KERNEL, STEPS, None, torch.empty_like(xt))
        plain = functools.partial(D.diffusion_nhwc_plain, xt, wt, KERNEL, STEPS)
        ms, per_step_ms = cuda_time_ms(fn, iters), cuda_time_ms(per_step, iters)
        plain_ms = cuda_time_ms(plain, min(iters, 50), warmup=2)
        bound_ms, bound_by = stencil_bound(xt, wt, KERNEL, STEPS)
        nhwc_rows[key] = row = dict(ms=ms, per_step_ms=per_step_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, err=err, shape=list(shape), kernel_route=route,
                                    launches=nhwc_n[{"plane": 0, "grid": 1}[route]])
        device_calls.extend([(f"NHWC {route} {key} {shape}", row, "device_ms", fn, f"stencil_nhwc_{route}", iters),
                             (f"NHWC per-step {key} {shape}", row, "per_step_device_ms", per_step,
                              "stencil_step_nhwc", iters)])
        say(f"  NHWC stencil {key} x {shape}, w ({b_},{h},{w},{KERNEL ** 2}*{c}), {STEPS} steps [{route}]: kernel "
            f"{ms:.5f} ms, per-step kernel {per_step_ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}), max_abs_err {err:.3e} [{card}]")
        del xt, wt, fn, per_step, plain
        torch.cuda.empty_cache()
    # the per-step kernel on its own route: k = 13 at the served shape
    xt = torch.rand(NHWC_SHAPES["served"], generator=g, device=dev).bfloat16()
    wt = D.to_tap_major(MD.normalize_affinity(torch.rand(*NHWC_SHAPES["served"], K13 ** 2, generator=g, device=dev),
                                              dim=-1)).bfloat16()
    fn = functools.partial(D.diffusion_nhwc_tap_major, xt, wt, K13, STEPS)
    ref = D.diffusion_nhwc_plain(xt.float(), wt.float(), K13, STEPS)
    bound_ms, bound_by = stencil_bound(xt, wt, K13, STEPS)
    nhwc_step_row = dict(ms=cuda_time_ms(fn, 200), plain_ms=cuda_time_ms(
        functools.partial(D.diffusion_nhwc_plain, xt, wt, K13, STEPS), 50), bound_ms=bound_ms, bound_by=bound_by,
        err=float((fn().float() - ref).abs().max()))
    device_calls.append((f"NHWC per-step k={K13} {NHWC_SHAPES['served']}", nhwc_step_row, "device_ms", fn,
                         "stencil_step_nhwc", 200))
    say(f"  NHWC per-step kernel (its own route, k={K13}) bf16 x {NHWC_SHAPES['served']}: {nhwc_step_row['ms']:.5f} ms, "
        f"plain {nhwc_step_row['plain_ms']:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    del ref

    # ---- 13. LayerNorm ----
    say("phase 13: LayerNorm kernel vs plain on each route (lane-group, scalar, block); forward+backward and times "
        "(L2-warm and L2-cold) at served stage-1 shapes")
    ln_routes = {}
    for c in LN_ROUTE_CS:
        for mean in (0.0, 100.0):
            xl = torch.randn(LN_CHECK_ROWS, c, generator=g, device=dev) * 3 + mean
            sc, bi = torch.randn(c, generator=g, device=dev), torch.randn(c, generator=g, device=dev)
            for name, dt, tol in (("fp32", torch.float32, LN_FP32_TOL[mean]), ("bf16", torch.bfloat16, LN_BF16_TOL)):
                for aligned in (True, False):
                    xin = xl.to(dt) if aligned else off_16_bytes(xl.to(dt))
                    out = torch.empty_like(xin)
                    route = L.ln_route(c, dt, xin.data_ptr(), out.data_ptr())
                    check(route == L.kernel_route(c, dt, xin.data_ptr(), out.data_ptr()),
                          f"LayerNorm C={c} {name}: ln_route {route} differs from the kernel's")
                    want = "block" if c > L.WARP_MAX_C else "group" if aligned and c != 130 else "scalar"
                    check(route == want, f"LayerNorm C={c} {name} aligned={aligned}: route {route}, expected {want}")
                    L.launch(xin, sc, bi, out, 1e-6)
                    torch.cuda.synchronize()
                    ref = L.layer_norm_plain(xin, sc, bi, 1e-6)
                    torch.testing.assert_close(out.float(), ref.float(), **tol,
                                               msg=lambda m: f"LayerNorm {name} C={c} mean {mean} {route}: {m}")
                    ln_routes.setdefault(route, set()).add(c)
        say(f"  C={c}: fp32 and bf16, mean 0 and 100, 16-byte aligned and one element off: within tolerance")
    check(set(ln_routes) == {"group", "scalar", "block"}, f"LayerNorm routes driven: {sorted(ln_routes)}")
    say("  routes: " + "; ".join(f"{r} C {sorted(cs)}" for r, cs in sorted(ln_routes.items())))
    ln_module = {}
    for shape_name, (shape, permuted) in LN_MODULE_SHAPES.items():
        # the models' LayerNorm (LayerNorm2d on the NCHW map) under
        # inference_mode: one launch a call, held to the plain version
        c = shape[1] if permuted else shape[-1]
        sc, bi = torch.randn(c, generator=g, device=dev), torch.randn(c, generator=g, device=dev)
        mods = [LayerNorm(c, eps=1e-6)] + ([LayerNorm2d(c, eps=1e-6)] if permuted else [])
        for m in mods:
            with torch.no_grad():
                m.to(dev).weight.copy_(sc)
                m.bias.copy_(bi)
        xm = (torch.randn(*shape, generator=g, device=dev) * 3 + 1).bfloat16()
        xin = xm.permute(0, 2, 3, 1) if permuted else xm
        ref = L.layer_norm_plain(xin, sc, bi, 1e-6)
        errs = []
        for m, arg, unpermute in zip(mods, (xin, xm), (False, True)):
            L.LAUNCHES = 0
            with torch.inference_mode():
                out = m(arg)
            torch.cuda.synchronize()
            out = out.permute(0, 2, 3, 1) if unpermute else out
            check(L.LAUNCHES == 1 and out.dtype == torch.bfloat16 and out.shape == ref.shape,
                  f"LayerNorm module {shape_name} ({type(m).__name__}): {L.LAUNCHES} launches, {out.dtype}")
            torch.testing.assert_close(out.float(), ref.float(), **LN_BF16_TOL,
                                       msg=lambda msg: f"LayerNorm module {shape_name} ({type(m).__name__}): {msg}")
            errs.append(float((out.float() - ref.float()).abs().max()))
        ln_module[shape_name] = dict(shape=list(shape), permuted=permuted, dtype="bfloat16", max_abs_err=max(errs),
                                     modules=[type(m).__name__ for m in mods])
        say(f"  LayerNorm module {shape_name} {tuple(shape)} bf16{' permuted' if permuted else ''} "
            f"({', '.join(type(m).__name__ for m in mods)}) under inference_mode: one launch a call, max_abs_err "
            f"{max(errs):.3e} against the plain version (limit one bf16 ulp)")
        del xm, xin, ref, out
        torch.cuda.empty_cache()
    ln_rows, ln_launches = {}, 0
    for shape_name, (rows_n, c) in LN_SHAPES.items():
        xl = (torch.randn(rows_n, c, generator=g, device=dev) * 3 + 1).bfloat16()
        # fp32 scale and bias whose values bf16 holds exactly, so that
        # F.layer_norm below takes the same values (see there)
        sc = torch.randn(c, generator=g, device=dev).bfloat16().float()
        bi = torch.randn(c, generator=g, device=dev).bfloat16().float()
        xr, sr, br = xl.clone().requires_grad_(), sc.clone().requires_grad_(), bi.clone().requires_grad_()
        L.LAUNCHES = 0
        L.layer_norm(xr, sr, br, 1e-6).float().pow(2).mean().backward()
        torch.cuda.synchronize()
        check(L.LAUNCHES == 1 and xr.grad is not None and bool(torch.isfinite(xr.grad.float()).all()),
              f"LayerNorm {shape_name}: {L.LAUNCHES} launches")
        ln_launches += L.LAUNCHES
        out = L.layer_norm_fwd(xl, sc, bi, 1e-6)
        route = L.ln_route(c, xl.dtype, xl.data_ptr(), out.data_ptr())
        err = float((out.float() - L.layer_norm_plain(xl, sc, bi, 1e-6).float()).abs().max())
        ms = cuda_time_ms(lambda: L.layer_norm_fwd(xl, sc, bi, 1e-6), 200)
        plain_ms = cuda_time_ms(lambda: L.layer_norm_plain(xl, sc, bi, 1e-6), 100)
        # one PyTorch call computes the same function: F.layer_norm refuses a
        # bf16 x with fp32 scale and bias on CUDA ("expected scalar type
        # BFloat16"), so it gets them in bf16, which holds their values
        # exactly; it computes its statistics and the affine in fp32 as the
        # kernel does, so the outputs agree to one bf16 ulp
        sl, bl = sc.to(xl.dtype), bi.to(xl.dtype)
        check(torch.equal(sl.float(), sc) and torch.equal(bl.float(), bi), "LayerNorm: scale or bias not bf16-exact")
        torch.testing.assert_close(F.layer_norm(xl, (c,), sl, bl, 1e-6).float(), out.float(), **LN_BF16_TOL,
                                   msg=lambda m: f"F.layer_norm vs the kernel, {shape_name}: {m}")
        library_ms = cuda_time_ms(lambda: F.layer_norm(xl, (c,), sl, bl, 1e-6), 200)
        # L2-cold: LN_ROTATION input/output pairs (more bytes than the 50 MB
        # L2), one pair a call in turn, so that each call reads x from HBM
        xs = [xl] + [(torch.randn(rows_n, c, generator=g, device=dev) * 3 + 1).bfloat16()
                     for _ in range(LN_ROTATION - 1)]
        outs = [torch.empty_like(t) for t in xs]
        rotation_mb = sum(t.numel() * t.element_size() for t in xs + outs) / 1e6
        check(rotation_mb > 2 * L2_BYTES / 1e6, f"LayerNorm rotation of {rotation_mb:.0f} MB does not exceed L2")
        cold = in_turn(lambda i, xs=xs, outs=outs, sc=sc, bi=bi: L.launch(xs[i], sc, bi, outs[i], 1e-6))
        cold_ms = cuda_time_ms(cold, 200)
        launch_ms = cuda_time_ms(functools.partial(L.launch, xl, sc, bi, outs[0], 1e-6), 200)
        library_cold = in_turn(lambda i, xs=xs, c=c, sl=sl, bl=bl: F.layer_norm(xs[i], (c,), sl, bl, 1e-6))
        library_cold_ms = cuda_time_ms(library_cold, 200)
        bound_ms, bound_by = layer_norm_bound(xl)
        ln_rows[shape_name] = dict(ms=ms, cold_ms=cold_ms, launch_ms=launch_ms, plain_ms=plain_ms,
                                   library_ms=library_ms, library_cold_ms=library_cold_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, err=err, shape=[rows_n, c], dtype="bfloat16", route=route,
                                   group_shape=list(L.ln_group_shape(c, xl.dtype)), rotation_mb=rotation_mb)
        device_calls += [
            (f"LayerNorm {shape_name} ({rows_n}, {c}) bf16, L2-warm", ln_rows[shape_name], "device_ms",
             functools.partial(L.layer_norm_fwd, xl, sc, bi, 1e-6), "ln_", 200),
            (f"LayerNorm {shape_name} ({rows_n}, {c}) bf16, L2-cold", ln_rows[shape_name], "cold_device_ms", cold,
             "ln_", 200),
            (f"F.layer_norm {shape_name} L2-warm", ln_rows[shape_name], "library_device_ms",
             functools.partial(F.layer_norm, xl, (c,), sl, bl, 1e-6), TORCH_LN_KERNELS, 200),
            (f"F.layer_norm {shape_name} L2-cold", ln_rows[shape_name], "library_cold_device_ms", library_cold,
             TORCH_LN_KERNELS, 200)]
        say(f"  LayerNorm {shape_name} ({rows_n}, {c}) bf16, route {route} {L.ln_group_shape(c, xl.dtype)}: kernel "
            f"{ms:.5f} ms L2-warm, {cold_ms:.5f} ms L2-cold ({LN_ROTATION} pairs, {rotation_mb:.0f} MB), launch "
            f"alone {launch_ms:.5f}; plain {plain_ms:.5f} ms; F.layer_norm {library_ms:.5f} ms L2-warm, "
            f"{library_cold_ms:.5f} L2-cold; bound {bound_ms:.6f} ms ({bound_by}), max_abs_err {err:.3e} [{card}]")

    # ---- 14. planes above the fused limit: the cluster kernels, then the tiled kernels ----
    gh, gw = GRID64
    lh, lw = LARGE
    say(f"phase 14: the op forward and backward on ({P_MAIN},{gh},{gw}) planes (cluster kernels), on "
        f"({P_MAIN},{lh},{lw}) and ({SERVING_P},{SERVING_GRID[0]},{SERVING_GRID[1]}) planes (tiled kernels)")
    for dt in (torch.bfloat16, torch.float32):
        check(D.stencil_route(gh, gw, KERNEL, dt) == "cluster" and D.plane_route(lh, lw, KERNEL, dt, STEPS) == "tiled"
              and D.plane_route(*SERVING_GRID, KERNEL, dt, STEPS) == "tiled", f"routes of {GRID64}, {LARGE} and "
              f"{SERVING_GRID} in {dt}")

    def drive_planes(shape, dt, label, p=P_MAIN):
        """The op forward and backward through the autograd Function on
        (p, *shape) planes, the launch counts read around it; forward
        and backward held to the plain versions. Returns the tensors
        (x, w, g, step inputs), the launches and the max abs errors."""
        xl = torch.rand(p, *shape, generator=g, device=dev).to(dt)
        wl = MD.normalize_affinity(torch.rand(p, KERNEL ** 2, *shape, generator=g, device=dev), dim=1).to(dt)
        gl = torch.rand(p, *shape, generator=g, device=dev).to(dt)
        xa, wa = xl.clone().requires_grad_(), wl.clone().requires_grad_()
        reset_plane_launches(D)
        out = D.diffusion_planes(xa, wa, KERNEL, STEPS)
        out.backward(gl)
        torch.cuda.synchronize()
        n = plane_launches(D)
        route = D.plane_route(*shape, KERNEL, dt, STEPS)
        per_call = STEPS if route == "per_step" else 1
        check(n == launch_tuple(route, per_call, per_call), f"{label}: launches ({LAUNCH_NAMES}) {n}")
        fp32 = dt == torch.float32
        ref = D.diffusion_planes_plain(xl.float(), wl.float(), KERNEL, STEPS)
        torch.testing.assert_close(out.detach().float(), ref, **(FP32_TOL if fp32 else dict(rtol=0, atol=BF16_ATOL)),
                                   msg=lambda m: f"{label} forward: {m}")
        errs = {"fwd": float((out.detach().float() - ref).abs().max())}
        del ref, out
        # the backward against the plain backward on the step inputs the kernel made
        _, lxs = D._forward_steps(xl, wl, KERNEL, STEPS, keep=True)
        rdx, rdw = D.diffusion_planes_bwd_plain(gl, lxs, wl, KERNEL)
        for gname, got, want in (("dx", xa.grad, rdx), ("dw", wa.grad, rdw)):
            torch.testing.assert_close(got.float(), want.float(), **(BWD_FP32_TOL if fp32 else BWD_BF16_TOL),
                                       msg=lambda m: f"{label} {gname}: {m}")
        errs["bwd"] = max(float((xa.grad.float() - rdx.float()).abs().max()),
                          float((wa.grad.float() - rdw.float()).abs().max()))
        say(f"  {label} [{route}]: launches ({LAUNCH_NAMES}) {n}; max_abs_err forward {errs['fwd']:.3e}, "
            f"backward {errs['bwd']:.3e}")
        return (xl, wl, gl, lxs), n, errs

    def time_planes(tensors, n, errs, part_names, label, rows, iters, plain_iters):
        """The all-steps kernels (the op on these tensors) timed beside the
        per-step kernels called directly on the same tensors and the plain
        versions; their device time is read in phase 18. Fills rows[part]
        for part in ("fwd", "bwd")."""
        xl, wl, gl, lxs = tensors
        for part, fn, per_step, plain, match, bound in (
            ("fwd", functools.partial(D.diffusion_planes, xl, wl, KERNEL, STEPS),
             lambda xl=xl, wl=wl: D._per_step_forward(xl, wl, KERNEL, STEPS, None, torch.empty_like(xl)),
             functools.partial(D.diffusion_planes_plain, xl, wl, KERNEL, STEPS),
             part_names[0], stencil_bound(xl, wl, KERNEL, STEPS)),
            ("bwd", functools.partial(D.diffusion_planes_bwd, gl, lxs, wl, KERNEL),
             functools.partial(D._per_step_backward, gl, lxs, wl, KERNEL),
             functools.partial(D.diffusion_planes_bwd_plain, gl, lxs, wl, KERNEL),
             part_names[1], stencil_bwd_bound(gl, lxs, wl, KERNEL)),
        ):
            ms, per_step_ms = cuda_time_ms(fn, iters), cuda_time_ms(per_step, iters)
            plain_ms = cuda_time_ms(plain, plain_iters, warmup=1)
            row = dict(ms=ms, per_step_ms=per_step_ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                       err=errs[part], launches_per_call=n[part_names[2] + (part == "bwd")])
            rows[part] = row
            say(f"  {label} {part} ({STEPS} steps, k={KERNEL}): {ms:.5f} ms per call; per-step kernels "
                f"{per_step_ms:.5f} ms per call; plain {plain_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}) [{card}]")
            device_calls.extend([(f"{label} {part}", row, "device_ms", fn, match, iters),
                                 (f"per-step {part}, {label}'s tensors", row, "per_step_device_ms", per_step,
                                  "stencil_step_kernel" if part == "fwd" else "stencil_bwd_kernel", iters)])

    # the cluster kernels at the paper's grid-64 planes, bf16 and fp32, timed
    # beside the per-step kernels called directly on the same tensors
    cluster_rows = {"fwd": {}, "bwd": {}}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        tensors, n, errs = drive_planes(GRID64, dt, f"{name} ({P_MAIN},{gh},{gw})")
        rows_ = {}
        time_planes(tensors, n, errs, ("stencil_cluster_fwd", "stencil_cluster_bwd", 2), f"cluster {name} "
                    f"({P_MAIN},{gh},{gw})", rows_, 100, 5)
        for part in ("fwd", "bwd"):
            cluster_rows[part][name] = rows_[part]
        del tensors
    # how many clusters the card runs at once: the 8 strips of 8 rows of the
    # grid-64 plane, and a non-portable 16 strips of 4 rows
    occupancy = {}
    for part in ("fwd", "bwd"):
        for blocks, rows_per in ((8, gh // 8), (16, gh // 16)):
            try:
                occupancy[f"{part}_{blocks}"] = D.cluster_occupancy(blocks, rows_per, gw, part == "bwd")
            except RuntimeError as exc:
                occupancy[f"{part}_{blocks}"] = str(exc)
    say(f"  max active clusters (k={KERNEL}, bf16, {gh}x{gw} in 8 strips of {gh // 8} rows or 16 of {gh // 16}): "
        f"{occupancy} [{card}]")

    # the tiled kernels beyond a cluster's reach: (192, 96, 96) in bf16 and
    # fp32, and serving_check's (24, 512, 512) in bf16, timed beside the
    # per-step kernels on the same tensors
    tiled_rows = {"fwd": {}, "bwd": {}}
    for key, p_, shape, dt, iters in (("bf16", P_MAIN, LARGE, torch.bfloat16, 50), ("fp32", P_MAIN, LARGE, torch.float32, 50),
                                      ("serving_bf16", SERVING_P, SERVING_GRID, torch.bfloat16, 10)):
        label = f"tiled {key} ({p_},{shape[0]},{shape[1]})"
        tensors, n, errs = drive_planes(shape, dt, label, p=p_)
        rows_ = {}
        time_planes(tensors, n, errs, ("stencil_tiled_fwd", "stencil_tiled_bwd", 6), label, rows_, iters, 3)
        for part in ("fwd", "bwd"):
            rows_[part]["plan"] = D.tiled_plan(*shape, KERNEL, STEPS, dt, part == "bwd")
            tiled_rows[part][key] = rows_[part]
        if dt == torch.bfloat16:
            # one step a call (the iter1 ablation beyond a cluster's reach):
            # the tiled kernels held to the plain versions and timed beside
            # one per-step launch each way, on the same tensors
            xl, wl, gl, lxs = tensors
            xs1 = lxs[:1]
            one_errs = {"fwd": check_kernel(D, xl, wl, KERNEL, 1, f"{label}, 1 step"),
                        "bwd": check_bwd(D, gl, xs1, wl, KERNEL, f"{label}, 1 step")}
            for part, fn, per_step, match, step_match in (
                ("fwd", functools.partial(D.diffusion_planes, xl, wl, KERNEL, 1),
                 lambda xl=xl, wl=wl: D._per_step_forward(xl, wl, KERNEL, 1, None, torch.empty_like(xl)),
                 "stencil_tiled_fwd", "stencil_step_kernel"),
                ("bwd", functools.partial(D.diffusion_planes_bwd, gl, xs1, wl, KERNEL),
                 functools.partial(D._per_step_backward, gl, xs1, wl, KERNEL), "stencil_tiled_bwd",
                 "stencil_bwd_kernel"),
            ):
                one = dict(ms=cuda_time_ms(fn, iters), per_step_ms=cuda_time_ms(per_step, iters), err=one_errs[part],
                           plan=D.tiled_plan(*shape, KERNEL, 1, dt, part == "bwd"))
                tiled_rows[part][key]["one_step"] = one
                say(f"  {label} {part}, 1 step: {one['ms']:.5f} ms per call; one per-step launch "
                    f"{one['per_step_ms']:.5f} ms [{card}]")
                device_calls.extend([(f"{label} {part}, 1 step", one, "device_ms", fn, match, iters),
                                     (f"per-step {part}, 1 step, {label}'s tensors", one, "per_step_device_ms",
                                      per_step, step_match, iters)])
            del xl, wl, gl, lxs, xs1
        del tensors
        torch.cuda.empty_cache()

    # ---- 15. cod at grid 64: served and trained through the CLIs ----
    grid = GRID64[0]
    say(f"phase 15: cod at grid {grid} (the paper's scale{grid} ablation): served through predict.main -o grid={grid} "
        f"(bf16, batch {BATCH}), trained through train.cli.main -o model.grid={grid} ({GRID_TRAIN_N} images, batch "
        f"{TRAIN_BATCH}, 1 epoch, bf16)")
    grab64 = {}

    def capture64(module, inputs, output):
        if isinstance(module, MD.MessagePassing) and "served" not in grab64:
            grab64["served"] = (inputs[0].detach().clone(), inputs[1].detach().clone())

    def spy_planes64(x, w, kernel, steps):
        out = planes_unspied(x, w, kernel, steps)
        if "x" not in grab64 and out.requires_grad:
            grab64["x"], grab64["w"] = x.detach().clone(), w.detach().clone()
            out.register_hook(lambda gr: grab64.setdefault("g", gr.detach().clone()))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid64_") as tmp:
        model = cod(seed=0)
        ckpt = os.path.join(tmp, "cod_seed0.pth")
        torch.save(model.state_dict(), ckpt)
        write_inputs(tmp)
        out_dir = os.path.join(tmp, "out")
        hook = torch.nn.modules.module.register_module_forward_hook(capture64)
        try:
            reset_plane_launches(D)
            served64 = P.main(["--checkpoint", ckpt, "--image-dir", os.path.join(tmp, "img"),
                               "--depth-dir", os.path.join(tmp, "dep"), "--out-dir", out_dir,
                               "--size", str(SIZE), "--batch", str(BATCH), "-o", f"grid={grid}"])
            torch.cuda.synchronize()
            served64_launches = plane_launches(D)
        finally:
            hook.remove()
        nb = served64["batches"]
        say(f"  served: {served64['images']} images in {nb} batches, loop {served64['loop_s']:.3f} s, stencil "
            f"launches ({LAUNCH_NAMES}) {served64_launches}")
        check(served64_launches == launch_tuple("cluster", nb), f"served grid {grid}: launches {served64_launches}")
        outs = sorted(os.listdir(out_dir))
        check(len(outs) == N_IMAGES, outs)
        for f in outs:
            with Image.open(os.path.join(out_dir, f)) as im:
                check(im.size == (SIZE, SIZE) and im.mode == "L", (f, im.size, im.mode))
        xp, wt = MD.affinity_planes(*grab64["served"], KERNEL)
        check(tuple(xp.shape) == (P_MAIN, grid, grid) and xp.dtype == torch.bfloat16, (xp.shape, xp.dtype))
        served64_err = check_kernel(D, xp, wt, KERNEL, STEPS, f"served grid {grid} bf16 stencil inputs")

        # fp32 on the card vs the same weights on the CPU (plain stencil), small input
        model32 = cod(dtype=torch.float32, seed=0, grid=grid)
        g_cpu = torch.Generator().manual_seed(3)
        img = torch.randn(1, 192, 192, 3, generator=g_cpu)
        depth = torch.rand(1, 192, 192, 1, generator=g_cpu)
        ref = model32.predict(img, depth)[0]
        reset_plane_launches(D)
        got = model32.to(dev).predict(img.to(dev), depth.to(dev))[0].cpu()
        check(plane_launches(D) == launch_tuple("cluster", 1), f"fp32 grid {grid} predict: launches {plane_launches(D)}")
        cpu64_err = float((got - ref).abs().max())
        say(f"  fp32 card vs CPU, 1x192x192 at grid {grid}: max_abs_err {cpu64_err:.3e} (limit {CPU_PROB_ATOL})")
        check(cpu64_err <= CPU_PROB_ATOL, f"grid {grid} card vs CPU {cpu64_err:.2e} > {CPU_PROB_ATOL}")
        del model32

        work = os.path.join(tmp, "run")
        overrides64 = [
            f"work_dir={work}", "train_cfg.max_epochs=1", "train_cfg.val_interval=0",
            f"train_dataloader.batch_size={TRAIN_BATCH}",
            f"train_dataloader.dataset={{'type': 'SyntheticSODDataset', 'n': {GRID_TRAIN_N}, 'size': {SIZE}}}",
            "default_hooks.logger.interval=1", f"model.grid={grid}",
        ]
        MD.diffusion_planes = spy_planes64
        try:
            reset_plane_launches(D)
            trained64 = TC.main([recipe] + [a for o in overrides64 for a in ("-o", o)])
            torch.cuda.synchronize()
            train64_launches = plane_launches(D)
        finally:
            MD.diffusion_planes = planes_unspied
        steps64 = GRID_TRAIN_N // TRAIN_BATCH
        say(f"  trained: {trained64['steps']} steps in {trained64['loop_s']:.3f} s; stencil launches ({LAUNCH_NAMES}) "
            f"{train64_launches}")
        check(trained64["steps"] == steps64, trained64)
        check(train64_launches == launch_tuple("cluster", steps64, steps64),
              f"launches {train64_launches}: one cluster forward and one cluster backward a step in {steps64} steps")
        with open(os.path.join(work, "log.jsonl")) as f:
            losses64 = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        check(len(losses64) == steps64 and bool(np.isfinite(losses64).all()), losses64)
        say("  losses: " + ", ".join(f"{v:.5f}" for v in losses64))
        gx, gw64, gg = grab64["x"], grab64["w"], grab64["g"]
        check(tuple(gx.shape) == (P_TRAIN, grid, grid) and gx.dtype == torch.bfloat16, (gx.shape, gx.dtype))
        train64_err = check_bwd(D, gg, step_inputs(D, gx, gw64, KERNEL, STEPS), gw64, KERNEL,
                                f"trained grid {grid} bf16, {STEPS} steps")

        # end to end: served ms per batch and train ms per step, grid 12 and
        # grid 64 in turns (12, 64, 64, 12) on the same weights and batch
        m64 = cod(seed=None, grid=grid)
        m64.load_state_dict(model.state_dict())
        nets = {12: model.to(dev), grid: m64.to(dev)}
        g_dev = torch.Generator(device=dev).manual_seed(4)
        img = torch.randn(BATCH, SIZE, SIZE, 3, generator=g_dev, device=dev)
        depth = torch.rand(BATCH, SIZE, SIZE, 1, generator=g_dev, device=dev)
        served_turns = {12: [], grid: []}
        for gs in (12, grid, grid, 12):
            served_turns[gs].append(cuda_time_ms(lambda: nets[gs].predict(img, depth), 5, warmup=2))
        del nets, m64, model
        torch.cuda.empty_cache()
        runners = {gs: Runner(load_config(recipe, [o for o in overrides64[1:] if not o.startswith("model.grid")]
                                          + [f"model.grid={gs}"]),
                              work_dir=os.path.join(tmp, f"steps{gs}"), seed=0, device=dev, dtype=torch.bfloat16)
                   for gs in (12, grid)}
        first = next(iter(runners[grid].train_loader))
        batch = {k: first[k] for k in ("input", "label", "depth")}
        step_turns, counter = {12: [], grid: []}, [1]

        def grid_step(gs):
            r = runners[gs]
            train_step(r.model, r.optimizer, batch, counter[0], r.seed + 1)
            counter[0] += 1

        for gs in (12, grid, grid, 12):
            step_turns[gs].append(cuda_time_ms(lambda: grid_step(gs), 3, warmup=2))
        del runners, batch, first
        torch.cuda.empty_cache()
    say(f"  served bf16 ms per batch (batch {BATCH}, {SIZE}², in turns 12, {grid}, {grid}, 12): grid 12 "
        f"{served_turns[12]}, grid {grid} {served_turns[grid]} [{card}]")
    say(f"  train bf16 ms per step (batch {TRAIN_BATCH}, {SIZE}², in turns): grid 12 {step_turns[12]}, grid {grid} "
        f"{step_turns[grid]} [{card}]")

    # cod at grid 96: the tiled kernels' main path (a plane beyond a cluster's reach)
    grid96 = LARGE[0]
    say(f"  cod at grid {grid96}: served through predict.main -o grid={grid96} (bf16, batch {BATCH}), trained through "
        f"train.cli.main -o model.grid={grid96} ({GRID_TRAIN_N} images, batch {TRAIN_BATCH}, 1 epoch, bf16)")
    grab96 = {}

    def capture96(module, inputs, output):
        if isinstance(module, MD.MessagePassing) and "served" not in grab96:
            grab96["served"] = (inputs[0].detach().clone(), inputs[1].detach().clone())

    def spy_planes96(x, w, kernel, steps):
        out = planes_unspied(x, w, kernel, steps)
        if "x" not in grab96 and out.requires_grad:
            grab96["x"], grab96["w"] = x.detach().clone(), w.detach().clone()
            out.register_hook(lambda gr: grab96.setdefault("g", gr.detach().clone()))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid96_") as tmp:
        model = cod(seed=0)
        ckpt = os.path.join(tmp, "cod_seed0.pth")
        torch.save(model.state_dict(), ckpt)
        del model
        write_inputs(tmp)
        out_dir = os.path.join(tmp, "out")
        hook = torch.nn.modules.module.register_module_forward_hook(capture96)
        try:
            reset_plane_launches(D)
            served96 = P.main(["--checkpoint", ckpt, "--image-dir", os.path.join(tmp, "img"),
                               "--depth-dir", os.path.join(tmp, "dep"), "--out-dir", out_dir,
                               "--size", str(SIZE), "--batch", str(BATCH), "-o", f"grid={grid96}"])
            torch.cuda.synchronize()
            served96_launches = plane_launches(D)
        finally:
            hook.remove()
        nb96 = served96["batches"]
        say(f"  served grid {grid96}: {served96['images']} images in {nb96} batches, loop {served96['loop_s']:.3f} s, "
            f"stencil launches ({LAUNCH_NAMES}) {served96_launches}")
        check(served96_launches == launch_tuple("tiled", nb96), f"served grid {grid96}: launches {served96_launches}")
        outs = sorted(os.listdir(out_dir))
        check(len(outs) == N_IMAGES, outs)
        xp, wt = MD.affinity_planes(*grab96["served"], KERNEL)
        check(tuple(xp.shape) == (P_MAIN, grid96, grid96) and xp.dtype == torch.bfloat16, (xp.shape, xp.dtype))
        served96_err = check_kernel(D, xp, wt, KERNEL, STEPS, f"served grid {grid96} bf16 stencil inputs")
        del xp, wt, grab96["served"]

        work = os.path.join(tmp, "run")
        overrides96 = [o if not o.startswith(("work_dir", "model.grid")) else None for o in overrides64]
        overrides96 = [f"work_dir={work}"] + [o for o in overrides96 if o] + [f"model.grid={grid96}"]
        MD.diffusion_planes = spy_planes96
        try:
            reset_plane_launches(D)
            trained96 = TC.main([recipe] + [a for o in overrides96 for a in ("-o", o)])
            torch.cuda.synchronize()
            train96_launches = plane_launches(D)
        finally:
            MD.diffusion_planes = planes_unspied
        say(f"  trained grid {grid96}: {trained96['steps']} steps in {trained96['loop_s']:.3f} s; stencil launches "
            f"({LAUNCH_NAMES}) {train96_launches}")
        check(trained96["steps"] == steps64, trained96)
        check(train96_launches == launch_tuple("tiled", steps64, steps64),
              f"launches {train96_launches}: one tiled forward and one tiled backward a step in {steps64} steps")
        with open(os.path.join(work, "log.jsonl")) as f:
            losses96 = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        check(len(losses96) == steps64 and bool(np.isfinite(losses96).all()), losses96)
        say("  losses: " + ", ".join(f"{v:.5f}" for v in losses96))
        gx, gw96, gg = grab96["x"], grab96["w"], grab96["g"]
        check(tuple(gx.shape) == (P_TRAIN, grid96, grid96) and gx.dtype == torch.bfloat16, (gx.shape, gx.dtype))
        train96_err = check_bwd(D, gg, step_inputs(D, gx, gw96, KERNEL, STEPS), gw96, KERNEL,
                                f"trained grid {grid96} bf16, {STEPS} steps")
        del gx, gw96, gg, grab96
        torch.cuda.empty_cache()

    # ---- 16. the val pass ----
    val_row = val_phase(D, val_ckpt, card)
    val_fwd_launches, val_batches = val_row.pop("_fwd_launches"), val_row.pop("_batches")

    # ---- 17. the model variants ----
    variants_row = variants_phase(D, MD, P, card)
    k11, k13 = variants_row.pop("_kernel11"), variants_row.pop("_kernel13")
    device_calls += k11.pop("calls")

    # ---- 18. device time per call ----
    # from the profiler, read last, so that its tracing cannot touch the
    # per-call and end-to-end timings above, which are host-bound
    say("phase 18: device time per call (torch.profiler key_averages):")
    for label, row, key, fn, match, iters, *per_launch in device_calls:
        row[key] = device_ms(fn, iters, match, bool(per_launch))
        say(f"    {label}: {row[key] if row[key] is not None else 'no device time recorded'} ms [{card}]")
    del device_calls
    torch.cuda.empty_cache()

    # ---- 19-21. data parallelism, the CLI under torchrun, spatial diffusion ----
    # in processes of their own (two ranks share the card), after the
    # profiler phase, which cannot touch their timings
    dp_row = dp_phase(card)
    torchrun_row = torchrun_phase(card)
    spatial_row = spatial_phase(D, card)

    # ---- 22-23. the offline depther, serving_check ----
    depther_row = depther_phase(card)
    serving_row = serving_check_phase(D, card)

    # ---- 24-26. serving bundles, the exported MSDA layer, the NHWC layout ----
    bundle_row = bundle_phase(D, card)
    dqnet_row = dqnet_msda_bundle_phase(card)
    layout_row = layout_phase(D, card)

    # ---- 27. serving under the data×space layout ----
    space_row = space_phase(D, card)

    b = rows["bf16"]
    bb = bwd_rows["bf16"]
    n_batches = summaries["bf16"]["batches"]
    large_shape = f"({P_MAIN},{lh},{lw}), w ({P_MAIN},{KERNEL * KERNEL},{lh},{lw}), {STEPS} steps"
    kernel_rows = [{
        "name": "diffusion_stencil_fused",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:263",
        "launches": launches["bf16"][0],
        "max_abs_err": b["err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
        "device_ms": b["device_ms"],
        "function_ms": b["function_ms"],
        "launch_ms": b["launch_ms"],
        "per_step_ms": b["per_step_ms"],
        "per_step_device_ms": b["per_step_device_ms"],
        "dtype": "bfloat16",
        "shape": f"x ({P_MAIN},12,12), w ({P_MAIN},{KERNEL * KERNEL},12,12), {STEPS} steps",
        "launches_per_batch": launches["bf16"][0] / n_batches,
        "launches_train": fwd_launches,
        "launches_per_step": fwd_launches / TRAIN_STEPS,
        "launches_val_in_training": train_val_launches[0],
        "launches_val": val_fwd_launches,
        "launches_per_val_batch": val_fwd_launches / val_batches,
        "fp32": rows["fp32"],
        "card": card,
    }, {
        "name": "diffusion_stencil_fused_bwd",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil_bwd.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:162",
        "launches": bwd_launches,
        "launches_per_step": bwd_launches / TRAIN_STEPS,
        "max_abs_err": train_err,
        "ms": bb["ms"],
        "plain_ms": bb["plain_ms"],
        "bound_ms": bb["bound_ms"],
        "bound_by": bb["bound_by"],
        "library_ms": None,
        "device_ms": bb["device_ms"],
        "launch_ms": bb["launch_ms"],
        "per_step_ms": bb["per_step_ms"],
        "per_step_device_ms": bb["per_step_device_ms"],
        "dtype": "bfloat16",
        "shape": f"g, x ({P_TRAIN},12,12), w, dw ({P_TRAIN},{KERNEL * KERNEL},12,12), {STEPS}-step backward",
        "fp32": bwd_rows["fp32"],
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgtd_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": n_launch,
        "max_abs_err": max(main_err, cluster_rows[part]["bf16"]["err"]),
        "ms": cluster_rows[part]["bf16"]["ms"],
        "plain_ms": cluster_rows[part]["bf16"]["plain_ms"],
        "bound_ms": cluster_rows[part]["bf16"]["bound_ms"],
        "bound_by": cluster_rows[part]["bf16"]["bound_by"],
        "library_ms": None,
        "device_ms": cluster_rows[part]["bf16"]["device_ms"],
        "per_step_ms": cluster_rows[part]["bf16"]["per_step_ms"],
        "per_step_device_ms": cluster_rows[part]["bf16"]["per_step_device_ms"],
        "launches_per_call": cluster_rows[part]["bf16"]["launches_per_call"],
        "dtype": "bfloat16",
        "shape": f"{'x' if part == 'fwd' else 'g, step inputs, dw'} ({P_MAIN},{gh},{gw}), w ({P_MAIN},"
                 f"{KERNEL * KERNEL},{gh},{gw}), {STEPS} steps",
        "main_path": main_path,
        "max_active_clusters": {n: v for n, v in occupancy.items() if n.startswith(part)},
        "fp32": cluster_rows[part]["fp32"],
        "card": card,
    } for name, source, replaces, part, n_launch, main_err, main_path in (
        ("diffusion_stencil_cluster", "diffusion_stencil", "dgtd_tpu/ops/diffusion_pallas.py:263", "fwd",
         served64_launches[2], served64_err,
         f"{served64_launches[2]} launches in {nb} served batches and {train64_launches[2]} in {steps64} train "
         f"steps of cod at grid {grid}"),
        ("diffusion_stencil_cluster_bwd", "diffusion_stencil_bwd", "dgtd_tpu/ops/diffusion_pallas.py:162", "bwd",
         train64_launches[3], train64_err,
         f"{train64_launches[3]} launches in {steps64} train steps of cod at grid {grid}"),
    )] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgtd_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": n_launch,
        "main_path": main_path,
        "max_abs_err": max(tiled_errs[part], main_err, k11["err"][part],
                           *(tiled_rows[part][key]["err"] for key in tiled_rows[part])),
        **{k: tiled_rows[part]["bf16"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "per_step_ms",
                                                     "per_step_device_ms", "launches_per_call", "plan")},
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"{'x' if part == 'fwd' else 'g, step inputs, dw'} {large_shape}",
        "one_step": tiled_rows[part]["bf16"]["one_step"],
        "fp32": tiled_rows[part]["fp32"],
        "serving_check": {**tiled_rows[part]["serving_bf16"],
                          "shape": f"({SERVING_P},{SERVING_GRID[0]},{SERVING_GRID[1]}), k={KERNEL}, {STEPS} steps"},
        "kernel11": {**k11["rows"][part], "shape": f"({P_MAIN if part == 'fwd' else P_TRAIN},12,12), k={K11}, "
                                                   f"{STEPS} steps: the kernel11 variant's own tensors"},
        "card": card,
    } for name, source, replaces, part, n_launch, main_err, main_path in (
        ("diffusion_stencil_tiled", "diffusion_stencil", "dgtd_tpu/ops/diffusion_pallas.py:263", "fwd",
         served96_launches[6] + train96_launches[6] + k11["fwd"], max(served96_err, 0.0),
         f"{served96_launches[6]} launches in {nb96} served batches and {train96_launches[6]} in {steps64} train steps "
         f"of cod at grid {grid96}; {k11['fwd']} in the kernel11 variant's {VARIANT_STEPS} train steps and "
         f"{VARIANT_SERVE // BATCH} served batches"),
        ("diffusion_stencil_tiled_bwd", "diffusion_stencil_bwd", "dgtd_tpu/ops/diffusion_pallas.py:162", "bwd",
         train96_launches[7] + k11["bwd"], train96_err,
         f"{train96_launches[7]} launches in {steps64} train steps of cod at grid {grid96}; {k11['bwd']} in the "
         f"kernel11 variant's {VARIANT_STEPS} train steps"),
    )] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgtd_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": k13[part],
        "main_path": (f"{k13[part]} launches in the kernel13 variant's {VARIANT_STEPS} train steps"
                      + (f" and {VARIANT_SERVE // BATCH} served batches" if part == "fwd" else "")
                      + f" (k={K13}, beyond the tiled kernels' templates; {STEPS} steps a call)"),
        "max_abs_err": k11["err13"][part],
        **{k: k13["rows"][part][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms")},
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"({P_MAIN if part == 'fwd' else P_TRAIN},12,12), k={K13}, {STEPS} steps: the kernel13 variant's "
                 "own tensors",
        "tiled_tensors": {"shape": large_shape, "ms": tiled_rows[part]["bf16"]["per_step_ms"],
                          "device_ms": tiled_rows[part]["bf16"]["per_step_device_ms"]},
        "kernel11_tensors": {k: k11["rows"][part][k] for k in ("per_step_ms", "per_step_device_ms")},
        "card": card,
    } for name, source, replaces, part in (
        ("diffusion_stencil", "diffusion_stencil", "dgtd_tpu/ops/diffusion_pallas.py:263", "fwd"),
        ("diffusion_stencil_bwd", "diffusion_stencil_bwd", "dgtd_tpu/ops/diffusion_pallas.py:162", "bwd"),
    )] + [{
        "name": "diffusion_stencil_nhwc",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:55",
        "launches": nhwc_launches[0],
        "main_path": f"{nhwc_launches[0]} launch of the plane kernel for the {STEPS} steps of a forward+backward "
                     "through diffusion_nhwc on x (8,12,12,24)",
        "max_abs_err": max(nhwc_errs["plane"], nhwc_rows["bf16"]["err"], nhwc_rows["fp32"]["err"]),
        **{k: nhwc_rows["bf16"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "per_step_ms",
                                              "per_step_device_ms", "kernel_route")},
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"x (8,12,12,24), w (8,12,12,{KERNEL * KERNEL}*24) tap-major, {STEPS} steps",
        "backward_launches": nhwc_launches[1],
        "grad_max_abs_err": nhwc_grad_err,
        "fp32": nhwc_rows["fp32"],
        "card": card,
    }, {
        "name": "diffusion_stencil_nhwc_grid",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:55",
        "launches": nhwc_rows["grid96_bf16"]["launches"],
        "main_path": f"{nhwc_rows['grid96_bf16']['launches']} launch of the grid kernel for the {STEPS} steps of "
                     "diffusion_nhwc_tap_major on x (8,96,96,24)",
        "max_abs_err": max(nhwc_errs["grid"], nhwc_rows["grid96_bf16"]["err"], nhwc_rows["serving_check_bf16"]["err"]),
        **{k: nhwc_rows["grid96_bf16"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                                     "per_step_ms", "per_step_device_ms", "kernel_route")},
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"x (8,96,96,24), w (8,96,96,{KERNEL * KERNEL}*24) tap-major, {STEPS} steps",
        "serving_check": nhwc_rows["serving_check_bf16"],
        "card": card,
    }, {
        "name": "diffusion_stencil_nhwc_step",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/diffusion_stencil.cu",
        "replaces": "dgtd_tpu/ops/diffusion_pallas.py:55",
        "launches": nhwc_step_launches,
        "main_path": f"{nhwc_step_launches} launches for the {STEPS} steps of diffusion_nhwc_tap_major on x "
                     f"(8,12,12,24) at k={K13} (beyond the plane and grid kernels' templates)",
        "max_abs_err": max(nhwc_errs["per_step"], nhwc_step_row["err"]),
        **{k: nhwc_step_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms")},
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": f"x (8,12,12,24), w (8,12,12,{K13 * K13}*24) tap-major, {STEPS} steps",
        "card": card,
    }, {
        "name": "layer_norm",
        "route": "cuda",
        "source": "dgtd_tpu_torch/csrc/layernorm.cu",
        "replaces": "dgtd_tpu/ops/layernorm_pallas.py:50",
        "launches": sum(n for n, _ in ln_served.values()),
        "main_path": " and ".join(f"{n} launches for the {calls} LayerNorm calls of phase 3's {name} cod predict.main "
                                  f"run" for name, (n, calls) in ln_served.items())
                     + f" ({summaries['bf16']['batches']} batches of {BATCH} at {SIZE}² each)",
        "standalone_launches": ln_launches,
        "module": ln_module,
        "max_abs_err": max(ln_rows["pvt_b2_stage1"]["err"], *(r["max_abs_err"] for r in ln_module.values())),
        "ms": ln_rows["pvt_b2_stage1"]["ms"],
        "plain_ms": ln_rows["pvt_b2_stage1"]["plain_ms"],
        "bound_ms": ln_rows["pvt_b2_stage1"]["bound_ms"],
        "bound_by": ln_rows["pvt_b2_stage1"]["bound_by"],
        "library_ms": ln_rows["pvt_b2_stage1"]["library_ms"],
        **{k: ln_rows["pvt_b2_stage1"][k] for k in ("device_ms", "cold_ms", "cold_device_ms", "launch_ms",
                                                    "library_cold_ms", "library_device_ms", "library_cold_device_ms",
                                                    "route", "group_shape", "rotation_mb")},
        "routes_checked": {r: sorted(cs) for r, cs in ln_routes.items()},
        "dtype": "bfloat16",
        "shape": "x (8*96*96, 64)",
        "convnext_b_stage1": ln_rows["convnext_b_stage1"],
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgtd_tpu_torch/csrc/{'msda_fwd' if name == 'msda_fwd' else 'msda_bwd'}.cu",
        "replaces": replaces,
        "launches": msda_launches[name],
        "max_abs_err": msda_rows[name]["err"],
        "ms": msda_rows[name]["ms"],
        "plain_ms": msda_rows[name]["plain_ms"],
        "bound_ms": msda_rows[name]["bound_ms"],
        "bound_by": msda_rows[name]["bound_by"],
        "library_ms": None,
        "device_ms": msda_rows[name]["device_ms"],
        "dtype": "float32",
        "shape": f"value ({ENC_N},{ENC_S},{ENC_HEADS},{ENC_D_MODEL // ENC_HEADS}), Lq {ENC_S}, levels {ENC_SHAPES}, {ENC_POINTS} points",
        "locations": "random_reference",
        "plan": msda_plans[name],
        "bf16": msda_sets[("random_reference", "bf16")][name],
        "encoder_grid": {dt: msda_sets[("encoder_grid", dt)][name] for dt in ("fp32", "bf16")},
        "card": card,
    } for name, replaces in (("msda_fwd", "dgtd_tpu/ops/msda.py:165"), ("msda_dvalue", "dgtd_tpu/ops/msda.py:255"),
                             ("msda_dlocw", "dgtd_tpu/ops/msda.py:353"))]
    # the launches of phases 19 and 21: each rank's fused forward and
    # backward a step; the spatial shards' launches by route (STEPS a call)
    by_name = {row["name"]: row for row in kernel_rows}
    for name, slot in (("diffusion_stencil_fused", 0), ("diffusion_stencil_fused_bwd", 1)):
        by_name[name]["data_parallel_launches"] = {
            "one_process": sum(st["launches"][slot] for st in dp_row["fp32_one_process"]),
            "per_rank": [sum(st["launches"][slot] for run in (r_fp32, r_bf16) for st in run["steps"])
                         for r_fp32, r_bf16 in zip(dp_row["fp32_ranks"], dp_row["bf16_ranks"])],
            "main_path": f"{DP_STEPS} fp32 steps in one process; {DP_STEPS} fp32 and {DP_STEPS} bf16 steps on each of "
                         f"{DP_RANKS} ranks"}
    for name, slot in (("diffusion_stencil_fused", 0), ("diffusion_stencil_cluster", 2),
                       ("diffusion_stencil_tiled", 6)):
        by_name[name]["spatial_launches"] = {
            f"{tuple(case['shape'])} {case['dtype']}": [rk["launches"][slot] for rk in case["ranks"]]
            for case in spatial_row["cases"].values() if case["ranks"][0]["launches"][slot]}
    # phase 23's launches: the fused forward under cod at 704² and 1024²,
    # the tiled forward in the 512² block's two kernel legs
    for name, slot in (("diffusion_stencil_fused", 0), ("diffusion_stencil_tiled", 6)):
        by_name[name]["serving_check_launches"] = {
            "launches": serving_row["launches"][slot],
            "main_path": "serving_check: cod predict at " + " and ".join(f"{s}²" for s in SERVING_SIZES)
                         + f" (bf16, batch 1) and the {SERVING_CHECK_GRID}² diffusion block's nhwc_wrapper and "
                           "planes legs (warm-up and 3 timed runs of 4 calls each)"}
    # phases 24-26: the fused forward in the cod bundle's calls, the MSDA
    # forward in the exported layer's call, the NHWC plane forward and the
    # fused backward under diffusion_plane_layout=False
    by_name["diffusion_stencil_fused"]["bundle_launches"] = {
        "launches": bundle_row["launches"],
        "main_path": f"the bf16 cod bundle's program at {SIZE}² (batch 1): a {SIZE}² and a "
                     f"{BUNDLE_ODD_HW[0]}x{BUNDLE_ODD_HW[1]} call through ServingModel and one on the card's tensors"}
    by_name["msda_fwd"]["exported_launches"] = {
        "launches": dqnet_row["msdeformattn"]["launches"],
        "main_path": f"one call of the MSDeformAttn layer exported with torch.export (N=1, Lq=S={ENC_S})"}
    by_name["diffusion_stencil_nhwc"]["layout_false_launches"] = {
        "served": layout_row["served_launches"][8], "train": layout_row["train_launches"][8],
        "main_path": f"cod under diffusion_plane_layout=False: one served batch of {BATCH} and one train step at "
                     f"batch {TRAIN_BATCH}, {SIZE}², bf16"}
    by_name["diffusion_stencil_fused_bwd"]["layout_false_launches"] = {
        "train": layout_row["train_launches"][1],
        "main_path": "the NHWC stencil's backward in one train step of cod under diffusion_plane_layout=False"}
    # phase 27: the fused forward a stencil step a rank on the halo'd bands
    by_name["diffusion_stencil_fused"]["space_launches"] = {
        "launches": {f"{key} {name}": [rk["launches"][0] for rk in case[name]["ranks"]]
                     for key, case in space_row["cases"].items() for name in ("float32", "bfloat16")},
        "max_abs_err_on_a_band": {k: v["max_abs_err"] for k, v in space_row["band_checks"].items()},
        "main_path": f"one served batch of each phase-27 case and dtype a rank, {STEPS} steps on the halo'd band"}
    train_launches = {f"{key} {name}": [[st["launches"] for st in rk["steps"]] for rk in row[name]["ranks"]]
                      for key, row in space_row["train"].items() for name in ("float32", "bfloat16")}
    by_name["diffusion_stencil_fused"]["space_train_launches"] = {
        "launches": {k: [[st[0] for st in rk] for rk in v] for k, v in train_launches.items()},
        "main_path": f"each train step of phase 27's train leg a rank, {STEPS} steps on the halo'd band"}
    by_name["diffusion_stencil_fused_bwd"]["space_train_launches"] = {
        "launches": {k: [[st[1] for st in rk] for rk in v] for k, v in train_launches.items()},
        "max_abs_err_on_a_band": {k: v["max_abs_err"] for k, v in space_row["band_checks"].items()
                                  if k.startswith("band_check_bwd")},
        "main_path": f"each train step of phase 27's train leg a rank, {STEPS} steps on the halo'd band"}
    say(json.dumps({"kernels": kernel_rows}))
    say(json.dumps({"trained": {
        "model": "cod, full width (PVTv2-b2, ConvNeXt-B), seeded random weights",
        "size": SIZE, "batch": TRAIN_BATCH,
        "step_ms": step_ms,
        "images_per_s": {k: TRAIN_BATCH * 1e3 / v for k, v in step_ms.items()},
        "peak_memory_bytes": peak,
        "cli_steps": trained["steps"],
        "cli_s_per_step": (trained["loop_s"] - val_seconds[0]) / trained["steps"],
        "cli_val_s": val_seconds[0],
        "cli_peak_memory_bytes": cli_peak,
        "cli_num_workers": TRAIN_WORKERS,
        "preemption": preempt_row,
        "first_step_loss": {"bf16": loss16, "fp32": loss32},
        "card": card,
    }}))
    say(json.dumps({"grid64": {
        "model": f"cod, full width, seeded random weights, grid {grid} (-o grid={grid} / -o model.grid={grid})",
        "size": SIZE,
        "served": {"batch": BATCH, "batches": nb, "launches": served64_launches, "loop_s": served64["loop_s"],
                   "fp32_card_vs_cpu": cpu64_err},
        "trained": {"batch": TRAIN_BATCH, "steps": trained64["steps"], "launches": train64_launches,
                    "losses": losses64, "loop_s": trained64["loop_s"]},
        "launch_order": LAUNCH_NAMES,
        "served_ms_per_batch": {"grid12": served_turns[12], f"grid{grid}": served_turns[grid]},
        "train_ms_per_step": {"grid12": step_turns[12], f"grid{grid}": step_turns[grid]},
        "card": card,
    }}))
    say(json.dumps({"val": {**val_row, "trained_val": {
        "images": TRAIN_VAL_N, "batch": 1, "launches": train_val_launches,
        **{k: train_val[k] for k in train_val if k.startswith("COD/") or k == "val_imgs_per_sec"}}, "card": card}}))
    say(json.dumps({"variants": variants_row}))
    say(json.dumps({"data_parallel": {**dp_row, "torchrun": torchrun_row}}))
    say(json.dumps({"spatial": spatial_row}))
    say(json.dumps({"depther": depther_row}))
    say(json.dumps({"serving_check": serving_row}))
    say(json.dumps({"bundle": bundle_row}))
    say(json.dumps({"dqnet_bundle": dqnet_row}))
    say(json.dumps({"layout": layout_row}))
    say(json.dumps({"space": space_row}))
    say(json.dumps({"msda": {
        "layer": f"MSDeformAttn(d_model={ENC_D_MODEL}, n_levels={len(ENC_SHAPES)}, n_heads={ENC_HEADS}, "
                 f"n_points={ENC_POINTS}), seeded weights",
        "n": ENC_N, "lq": ENC_S, "levels": ENC_SHAPES,
        "iterations": ENC_ITERS, "launches": msda_launches,
        "op_fwd_ms": op_fwd_ms, "op_bwd_ms": op_bwd_ms, "op_fwd_bwd_ms": op_step_ms,
        "layer_iteration_ms": layer_step_ms,
        "grid_sample_ms": grid_sample_ms,
        "card_vs_cpu_rel": layer_errs,
        "card": card,
    }}))
    say(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
