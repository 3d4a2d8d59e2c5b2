#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dgmesh_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

    python3 chip_smoke.py --kernels-only   # phases 1-3, then stop (no result)
    python3 chip_smoke.py --profile        # profile a float32 and a fused step
    python3 chip_smoke.py --multi-device-only   # phases 1, 2, 3t, 9 and 10, then stop

Phases; any failure exits non-zero and prints no result:
  1. card     — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds every kernel of the render and training paths
                from dgmesh_torch/csrc (one nvcc per source, in parallel);
                kernel 6's weight-gradient pass must be wgmma only (HGMMA
                and no HMMA in cuobjdump's SASS);
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the main path's full-width shapes, on seeded random rows with
                the edge cases (invalid rows, alpha-clamped rows, slivers
                below AREA_MIN, back faces, exact z ties; for the backward
                kernels random cotangents, and built ties where the shade
                backward splits gradients in half; the splat backward with
                and without kernel 1's residuals, launched twice for
                identical bits, and at COMPOSITE_EDGE_SHAPES, where kernel
                1 is held too (with and without S, launched twice for
                identical bits, as on the random, view 0 and step rows),
                and kernel 1 also at 12x12 tiles; the shade
                forward with and without its residuals, launched twice for
                identical bits, on random rows, on rows with built ties
                and at SHADE_EDGE_SHAPES, where the shade backward is held
                too); the fused trunk
                (kernels 5 and 6) at 131,072 and 479,966 (ragged) rows,
                each launched twice there for identical bits and kernel
                6's two passes timed apart (its weight-gradient pass
                beside its floor and cuBLAS's nine products), then at the
                shapes their tiling makes special (MLP_EDGE_SHAPES), kernel
                6 launched twice there too; wherever the trunk is held
                (here, 5f and 8), every group of equal input rows must
                come out with the same bits, and the norm ratios weigh
                each group once (trunk_measures);
     3t: kernels 1-4 on the tiles [T/2, T) alone, launched with tile0 =
                T/2 (a rank's block of tiles): the same bits as those tiles
                of the whole launch, and each against its twin given tile0;
  4. render   — configs/synthetic-quality-288.yaml with bench.py's shell
                state (100k Gaussians, radius 0.45, seed 0) and seeded random
                nets: render_frame for 4 orbit views at 800², grid 288, with
                the launch counters zeroed just before and read just after;
                then render_frame on the first view again with each function
                it calls wrapped to time it (where the time goes) and to keep
                the kernels' inputs, on which the kernels are held against
                their twins again and timed; then one render at the YAML's own
                gaussian_ratio and init_density_threshold, reported only;
  5. train    — the mesh-phase training step (train/step.py::train_step,
                bench.py's flags, densify statistics on) on bench.py's view
                with a random GT image: 1 warm-up and 5 timed steps, each
                from the same frozen state, every step finite with
                mesh_overflow 0 and no non-finite gradient leaf, the four
                launch counters zeroed just before and read just after; then
                two steps with forward / backward / optimizer timed, and the
                backward kernels held against their twins on the rows and
                cotangents they got inside the step (each cotangent scaled
                to a largest |value| of 1), the splat backward through kernel
                1's residuals as the step calls it, both backward kernels
                launched twice there for identical bits, and the shade
                forward held on the step's rows too; all four kernels
                timed, each
                beside the bound of the work its function needs on these
                rows;
     5f: the same in the fused configuration (tpu.mlp_bf16 and
                tpu.mlp_fused set here): every kernel counted, kernels 5 and
                6 six times a step; the stages; kernels 5 and 6 held against
                their twins on every trunk call of a step (cotangents scaled
                to 1), kernel 5 launched twice on the largest for identical
                bits, both timed on it beside their bound and the bf16
                mode's chain of cuBLAS GEMMs;
     5g: the bf16 (cuBLAS) configuration, bench.py's own precision:
                the same steps and checks and the stages, reported; then the
                three steps side by side;
     5s: the structural ops (train/densify.py, train/loop.py) at the same
                state with the Adam moments and densify statistics of one
                training step from it: the one-shot normal init at the config's
                occ_res (128; a first call, then a timed one) and, measured
                only, at the reference's 256, each part timed; one anchor iteration through run_iteration
                with float32 nets and one with fused ones (the launch
                counters zeroed just before and read just after, every
                kernel of the step launched); densify/prune with and without
                the size threshold, and on a varied copy of the state where
                clone, split and prune all fire; the opacity reset.  Gates: finite
                outputs, mesh_overflow 0, zero moments on every slot an op
                touched, and on the anchor iteration an unchanged g_count
                and updated nets;
  6. check    — render, and a training step from each of SMALL_SEEDS
                states, on the card and on the CPU (the plain twins) at a
                small size with room in the mesh caps must agree; the
                training step again in the fused configuration, from
                SMALL_SEEDS_FUSED states; normal init, anchor_step and
                densify/prune with the same CPU-made draws on both (discrete
                outputs equal, floats within TOL_STRUCT); render_mesh_shape
                of the small view's mesh (face_id equal, TOL_SHAPE_RENDER);
  7. driver   — the port's trainer, data and CLIs (module 3) at full width:
                generate_mesh_dataset at 800² (DRIVER_FRAMES training and
                DRIVER_TEST test frames, an icosphere of subdiv 5, and
                DRIVER_EVAL_FRAMES GT meshes for phase 7e), then
                cli.train.main on a copy of configs/synthetic-quality-288.yaml
                whose schedule keys are DRIVER_SCHEDULE (every width, cap and
                K as the YAML has them): warm-up, a densify iteration, normal
                init at dpsr_iter, mesh iterations, an anchor iteration, the
                tripwire check at 25, checkpoints at DRIVER_SAVE and the end,
                the test pass; once with float32 nets and once fused, the
                launch counters zeroed just before each and read just after
                (kernels 1-4, and 5-6 fused, must have launched).  Gates:
                every iteration's loss finite, mesh_overflow 0,
                nonfinite_grad_leaves 0, no tripwire, the files written.
                A fresh Trainer resumed from the DRIVER_SAVE checkpoint runs
                the next iteration, held to the uninterrupted run's (its
                checkpoint and logged metrics) within TOL_RESUME_*; then
                cli.render_test on the final checkpoint (kernels 1 and 3);
     7e: evaluation (module 4) on the fused run's final checkpoint,
                loaded as render_test loads it: export_dynamic_meshes of
                DRIVER_EVAL_FRAMES frames (each mesh_overflow 0 and finite,
                its parts timed apart); cli.mesh_evaluation with JAX's
                recipe (tools/run_quality.sh: --transforms, the default
                --method, 8192 EMD samples), every CD and EMD finite, its
                chamfer, sampling and EMD timed, once more in the dataset's
                own frame (--method none, no --transforms: the recipe's
                alignment suits the reference's captures), and frame 0 on
                the card against the CPU (the EMD at EVAL_CHECK_SAMPLES);
                cli.render_trajectory with TRAJ_VIEWS views at 800², the
                launch counters zeroed just before and read just after
                (kernel 1 once a view, kernel 3 twice: the render and the
                shape render), then view 0's panel timed with kernel 3 held
                to its twin on the shape render's rows; run_testing with
                LPIPS on random AlexNet and VGG weights (written under
                build/, found through DGMESH_LPIPS_DIR for this phase only),
                the four columns finite, each net timed at 800² and held
                card vs CPU on a 256² crop;
     7f: evaluation from a checkpoint: cli.evaluate (tools/
                eval_from_checkpoint.py's port) on a copy of the fused run's
                config and final checkpoint, loaded afresh, with
                EVALUATE_MESHES 2 (t = 0 and 1, 7e's first and last frames,
                against their two GT meshes) at EVALUATE_EMD_SAMPLES; the
                launch counters zeroed just before and read just after
                (kernels 1 and 3 once a test view: the render path and the
                export apply the nets in float32, as JAX's, so a fused
                checkpoint's nets launch no kernel 5 here); test_result.txt holds
                run_testing's keys, all finite; the two meshes' V and F
                within TOL_EVALUATE_MESH and their CD within TOL_EVALUATE_CD
                of 7e's; its time;
     7b: the converging regime of tests/test_mesh_phase_learns.py
                (420 iterations at 64², grid 24) trained by the port's
                Trainer, with that test's four properties;
  8. capture  — the real-capture data path (module 3's remainder) at the
                shipped real-data configs' widths: the GT-mesh scene
                rendered at 540x960 through off-centre pinhole cameras and
                written in the Nerfies, iPhone and NeuralActor layouts
                (generate_capture_datasets: DEVA palette masks, SAM
                greyscale ones); cli.train.main on the Nerfies layout under
                a copy of configs/nerfies/tail.yaml whose schedule keys are
                DRIVER_SCHEDULE (is_blender false, white background, grid
                288, K 768/192, 262,144 / 524,288 / 1,048,576 slots, and
                its gaussian_ratio and init_density_threshold as the YAML
                has them), fused nets, the six launch counters zeroed just before and
                read just after (each must have launched); cli.render_test
                on the validation frames; the iPhone and NeuralActor layouts
                read through Scene under configs/iphone/tiger.yaml's and
                configs/neural-actor/D2_vlad.yaml's data_type with Pillow
                made unimportable, and one view
                of each rendered from the run's final state (Scene and the
                render timed); kernels 1-4 held against their twins on one
                fused step's rows at K 768/192 (the last tile column
                partial) and kernels 5-6 on its trunk calls at din 84, each
                timed; render_frame of a 72x56 off-centre camera on the card
                and the CPU (TOL_SMALL, faces equal); lanczos_resize of a
                2704x2028 frame to 1600x1200 on the host, timed; a 540x960
                capture frame written as PNG with every row Paeth, every
                row Average and Adam7-interlaced (png_file) and read by
                utils_io.read_png through Pillow where it imports and with
                PIL blocked (decode_png), each read timed and every array
                equal to the frame.  Gates:
                the driver's, mesh_overflow 0, every kernel within its
                tolerance, all six launched;
  9. multi    — the multi-device step (dgmesh_torch/parallel) on bench.py's
                full-width state, fused nets: the kernels built here first,
                then SHARD_RANKS ranks on this one card (gloo with CUDA
                tensors; a collective gloo refuses them for goes through the
                host, counted), each running train_step on its part of the
                state: one step with every rank's launch counters zeroed
                just before and read just after (kernels 1-6 each launched
                on every rank), SHARD_STEPS timed, one more with each
                collective timed; the gathered loss, mesh size, gradients
                and new state held to the unsharded step on the card (loss
                terms within TOL_SHARD_LOSS, V, F and the overflow counters
                equal, gradients and parameters within SHARD_LIMITS); then
                the same with one rank under NCCL, the backend of a machine
                with a card a rank;
 10. 6-DoF    — the is_6dof deformation head: render and training steps on
                the card and on the CPU at the small size, and one fused
                full-width step (kernels 1-6 launched, finite);
 11. result   — one JSON line of per-kernel numbers, then the last line
                {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib.util
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DRIVER_DIR = os.path.join(ROOT, "build", "chip_smoke_driver")   # phases 7 and 7b's files
MULTI_DIR = os.path.join(ROOT, "build", "chip_smoke_multi")     # phase 9's profiles
CONFIG = os.path.join(ROOT, "configs", "synthetic-quality-288.yaml")

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and device memory bandwidth.  Used only for bound_ms.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# ... and the dense bf16 tensor-core rate (NVIDIA H100 SXM data sheet,
# without sparsity), the bound of kernels 5 and 6
PEAK_BF16_TC = 989e12

# Float32 operations the function needs, counted from the kernels' source
# (an exp, log1p, sqrt, division, compare or select counts as one
# operation; a sum over the tile's pixels as one add per summand).  The
# forward, per (pixel, row) pair:
COMPOSITE_TEST_OPS = 16     # every valid row: power, exp, clamp, the tests
COMPOSITE_ACCUM_OPS = 11    # rows that pass the tests: log1p, exp, rgb sums
SHADE_OPS = 118             # every valid row: edges, barycentrics, z, soft
# The backward functions: the forward's recompute once (the counts above),
# then partials and their tile sums only where they are not zero:
COMPOSITE_BWD_PASS_OPS = 18   # pairs that pass the alpha tests: log1p, the
                              # transmittance, w, u, u w and its running sum,
                              # d rgb + 3 sums
COMPOSITE_BWD_LIVE_OPS = 31   # of these, pairs below the 0.99 clamp: the
                              # suffix, d alpha, d power, the six partials + 6 sums
COMPOSITE_BWD_PIXEL_OPS = 6   # every pixel, given the forward's residuals:
                              # T_fin = exp(S) and the total g_rgb . rgb
SHADE_BWD_SOFT_OPS = 159      # pairs with a non-zero soft gradient: picks, the
                              # gates, three edges' clip weights and partials + 6 sums
SHADE_BWD_RGB_OPS = 117       # pixels with a winner and a non-zero g_rgb: the
                              # normaliser, u, dq, the winner row's 18 partials + 18 sums

SOURCES = {"composite_tiles": "dgmesh_torch/csrc/composite.cu",
           "composite_bwd": "dgmesh_torch/csrc/composite_bwd.cu",
           "shade_tiles": "dgmesh_torch/csrc/shade.cu",
           "shade_bwd": "dgmesh_torch/csrc/shade_bwd.cu",
           "trunk_fwd": "dgmesh_torch/csrc/mlp_fwd.cu",
           "trunk_bwd": "dgmesh_torch/csrc/mlp_bwd.cu"}
REPLACES = {"composite_tiles": "dgmesh_tpu/ops/splat_pallas.py:34",
            "composite_bwd": "dgmesh_tpu/ops/splat_pallas.py:116",
            "shade_tiles": "dgmesh_tpu/ops/mesh_raster_pallas.py:40",
            "shade_bwd": "dgmesh_tpu/ops/mesh_raster_pallas.py:164",
            "trunk_fwd": "dgmesh_tpu/ops/mlp_pallas.py:36",
            "trunk_bwd": "dgmesh_tpu/ops/mlp_pallas.py:62"}

DEVICE = "cuda"
KERNELS_ONLY = "--kernels-only" in sys.argv[1:]   # build and check, then stop
PROFILE = "--profile" in sys.argv[1:]             # profile one training step, then stop
MULTI_ONLY = "--multi-device-only" in sys.argv[1:]   # phases 1, 2, 3t, 9 and 10, then stop
IMG = 800             # 800x800 views, 16x16 tiles: T = 2500
N_GAUSS = 100_000     # live Gaussians in the config's 131,072 slots
N_VIEWS = 4
REPEATS = 3
TRAIN_STEPS = 5       # timed training steps, after one warm-up, each from the same state
KERNEL_TIMING_LAUNCHES = 20
TOL_COMPOSITE = 1e-4  # rgb/alpha: sequential vs cumsum/einsum summation order
TOL_SHADE = 1e-5      # rgb/soft; hard and fid must agree exactly
TOL_SMALL = 1e-4      # card vs CPU at the small size: images
TOL_BWD_REL = 1e-4    # backward kernels vs twins, per lane group: relative to
TOL_BWD_ABS = 1e-6    # the group's largest |twin| value, plus an absolute floor
TOL_SMALL_LOSS = 1e-4  # card vs CPU training step: loss terms, relative
TOL_SMALL_GP = 5e-3    # ... Gaussian gradient leaves, relative to the leaf's max
TOL_SMALL_HEAD = 1e-4  # ... the appearance net's output head (kernel 4's colour
                       #     gradient, no ReLU on the way), relative to the leaf's max
TOL_SMALL_NET = 3e-2   # ... the other net leaves, ‖Δ‖/‖CPU‖ per leaf (a ReLU at
                       #     float32 rounding of 0 may take the other side, and
                       #     every layer below it moves: tests/test_torch_train.py);
                       #     ~3x the largest of eight sound card runs (0.0047-0.0108)
SMALL_SEEDS = 6        # states (points and nets) of the small training check
# Kernels 5 and 6 against their twins.  Both sum exact bf16 products in
# float32 but in another order, so now and then an activation rounds to the
# neighbouring bf16 value and the change runs down the later layers, where
# it may move a pre-activation across 0 and flip a ReLU mask (the row's
# gradient then differs at that unit by its whole value).  The limits are
# at least twice how far summation order alone moves the twins on these
# weights and rows: the float32 twins against twins that sum in float64
# (tests/test_torch_mlp_fused.py::test_twins_summation_order_spread).  dx
# is not held element by element: a mask flip changes whole elements.
TOL_MLP_FWD_MAX = 2e-2    # output: max |Δ| / max |twin|
TOL_MLP_FWD_NORM = 2e-3   # output: ‖Δ‖ / ‖twin‖
TOL_MLP_BWD_NORM = 3e-2   # dx, dW, db: ‖Δ‖ / ‖twin‖
TOL_MLP_BWD_MAX = 1e-1    # dW, db: max |Δ| / max |twin|
MLP_ROWS = (131_072, 479_966)   # the step's Gaussian slots and mesh vertices
MLP_DIN = 93                    # blender nets: 63 position + 30 timenet lanes
# kernels 5 and 6's special shapes: (rows, din).  1, 37 and 64 rows leave
# the second warpgroup of the only CTA with no row; 65 and 129 rows a ragged
# last CTA; din 1 and 256 the narrowest and the widest input; din 64, 65,
# 128, 129 and 192 either side of the 64-lane blocks of x that kernel 5
# multiplies (ceil(din/64) of them), last so that the shapes before them
# keep their random rows; then NaN in one lane of every seventh row, which
# stays NaN through every ReLU (jnp.maximum and torch.relu keep it) and
# reaches every weight gradient the row meets.  For kernel 6's
# weight-gradient pass (S row splits of whole 64-row stages, S = 8 for the
# 16 jobs at din <= 128 on 132 SMs, 128-row dW tiles, those of dW[0] and
# dW[8] wholly past din skipped: din 1, 64, 65, 128, 129 and 256 above): 1, 37,
# 129 and 300 rows leave splits with no stage, 511 and 513 rows lie either
# side of S x 64 rows (one stage a split, then two for some), and the main
# path's 479,966
MLP_EDGE_SHAPES = ((1, 93), (37, 93), (64, 93), (65, 93), (129, 93), (131_072 + 37, 93),
                   (129, 1), (129, 256), (129, 64), (129, 65), (129, 128), (129, 129),
                   (129, 192), (129, 93, "NaN rows"), (300, 93), (511, 93), (513, 93),
                   (479_966, 93))
TRUNKS = 6    # fused trunks per step: deform, deform_normal, the two cycle nets,
              # deform_back and appearance on the mesh vertices
# The small card-vs-CPU step in the fused configuration.  Card and CPU sum
# the trunk's bf16 products in other orders, so an activation may round to
# the neighbouring bf16 value and tip the ReLU masks below it (TOL_MLP_*).
# The loss limit is the float32 step's.  The appearance head sees the bf16
# trunk output, where a flip is one bf16 ulp of one element; the other net
# leaves move with every mask a flip tips; the Gaussian leaves take the
# appearance trunk's input gradient (kernel 6's dx) through the mesh
# vertices, where a tipped mask changes whole elements.  Each limit is
# 3-4x the worst of seeds 0-5 in the first card run of this check (head
# 2.89e-3, other leaves 4.69e-2, Gaussian leaves 6.93e-3: the float32
# step's 5e-3 for these, taken over unexamined, failed on one seed).
# Seeds 6-11 were added after the limits were set, as held-out states.
TOL_SMALL_HEAD_FUSED = 1e-2
TOL_SMALL_NET_FUSED = 2e-1
TOL_SMALL_GP_FUSED = 2e-2
SMALL_SEEDS_FUSED = 2 * SMALL_SEEDS
# The structural ops.  The scene extent of bench.py's view: the camera at
# distance 2.5, times 1.1 as the reference's getNerfppNorm pads it.
# phase 7 (the driver): the dataset, the schedule that replaces the YAML's
# (every width, cap and K stay the YAML's), and the resume check.  200
# iterations fit the Gaussians before the mesh phase opens (the shipped
# schedule fits 5000); the two fields phase 5 takes from bench.py's
# Config() (gaussian_ratio 1.5, init_density_threshold 0.05) replace the
# YAML's 1.2 and 0.0 here too: with those the mesh of this fit overflows
# the caps (PERF.md §6)
DRIVER_FRAMES, DRIVER_TEST, DRIVER_SUBDIV = 8, 2, 5
DRIVER_SCHEDULE = dict(iterations=240, warm_up=30, densify_from_iter=20, densify_until_iter=160,
                       densification_interval=20, dpsr_iter=200, normal_warm_up=10,
                       normal_net_warmup=20, anchor_iter=220, anchor_interval=230,
                       position_lr_max_steps=240, deform_lr_max_steps=240, log_every=1,
                       opacity_reset_interval=100_000, gaussian_ratio=1.5,
                       init_density_threshold=0.05)
DRIVER_SAVE = 212           # resumed from; the uninterrupted run also saves DRIVER_SAVE + 1
DRIVER_EVAL_FRAMES = 10     # the dataset's GT meshes; phase 7e exports as many frames
_S = DRIVER_SCHEDULE           # the schedule's first densify, normal-init and anchor iterations
DRIVER_ITERS = {"densify": _S["densification_interval"]
                * (_S["densify_from_iter"] // _S["densification_interval"] + 1),
                "normal init": _S["dpsr_iter"],
                "anchor": _S["anchor_interval"] * (_S["anchor_iter"] // _S["anchor_interval"] + 1)}
# A resumed iteration against the uninterrupted run's on the card: the
# card's scatter sums (index_add_, autograd's scatters, DPSR) run in another
# order run to run (PERF.md §6 (f)).  Loss terms relative; V and F
# relative; each Gaussian group's and net leaf's gradient (from the Adam
# first moments) as ‖Δ‖/‖g‖, at the card-vs-CPU check's TOL_SMALL_GP and
# TOL_SMALL_NET (max |Δ| over max |g| is reported only: it reached 3.6e-3
# against 5e-5 between two resumes on an H100); every
# parameter within two learning rates (an element whose gradient is noise
# moves by ~±lr either way, as tests/test_torch_train.py bounds it)
TOL_RESUME_LOSS = 1e-4
TOL_RESUME_MESH = 1e-3
CONVERGE_ITERS = 420        # phase 7b: tests/test_mesh_phase_learns.py's regime
# phase 7e (eval): JAX's quality recipe (tools/run_quality.sh) on the fused
# run's final checkpoint.  Card vs CPU on frame 0, at sizes the CPU takes
# in seconds (the whole frame's chamfer took it 33 s): the chamfer of the
# GT against every EVAL_CHECK_STRIDE-th predicted vertex within
# TOL_EVAL_CD_REL (the distance expansion's sums in another order, averaged
# over ~10k and ~75k points) and the EMD at EVAL_CHECK_SAMPLES within
# TOL_EVAL_EMD_REL (logsumexp sums in another order over 600 iterations;
# 1.7e-7 between the CPU and JAX at 128 points); LPIPS on a LPIPS_CROP²
# crop within tests/test_lpips_torch_agreement.py's 1e-4; the shape render
# at phase 6's size within the CPU test's TOL_SHAPE_RENDER, face_id equal
EVAL_EMD_SAMPLES = 8192
EVAL_CHECK_SAMPLES = 1024
EVAL_CHECK_STRIDE = 8       # the CPU's chamfer of frame 0 on every 8th predicted vertex
TRAJ_VIEWS = 4
LPIPS_CROP = 256
TOL_EVAL_CD_REL = 1e-5
TOL_EVAL_EMD_REL = 1e-4
TOL_LPIPS_REL = 1e-4
TOL_SHAPE_RENDER = 1e-5
# phase 7f: cli.evaluate on the same checkpoint exports EVALUATE_MESHES 2
# meshes, t = 0 and 1 (7e's first and last frames), held to 7e's V, F and CD:
# the card's scatter order moves DPSR's phi by an ulp from run to run, which
# can flip a tet's sign at the surface, so V and F within TOL_EVALUATE_MESH
# relative (as TOL_RESUME_MESH) and the CD within TOL_EVALUATE_CD relative
EVALUATE_MESHES = 2
EVALUATE_EMD_SAMPLES = 2048
TOL_EVALUATE_MESH = 1e-3
TOL_EVALUATE_CD = 1e-3

# phase 8 (real capture): the GT-mesh scene written in the layouts of the
# real-capture readers at a portrait 540x960 (a width that is no multiple
# of 16, the principal point off centre), trained through cli.train under
# configs/nerfies/tail.yaml's model and capacities (is_blender false, white
# background, grid 288, K 768/192, 262,144 / 524,288 / 1,048,576 slots)
# with DRIVER_SCHEDULE, fused nets; the iPhone and NeuralActor layouts read
# through Scene under their YAMLs' data_type; kernels 1-4 held on the run's
# rows at K 768/192 and kernels 5-6 at din 84; card vs CPU on a 72x56
# off-centre camera (TOL_SMALL, faces equal); the LANCZOS resize of a
# PlenopticVideo frame (2704x2028 to 1600x1200, resolution -1) timed
CAPTURE_CONFIG = os.path.join(ROOT, "configs", "nerfies", "tail.yaml")
CAPTURE_YAMLS = {"iPhone": os.path.join(ROOT, "configs", "iphone", "tiger.yaml"),
                 "NeuralActor": os.path.join(ROOT, "configs", "neural-actor", "D2_vlad.yaml")}
CAPTURE_DIR = os.path.join(ROOT, "build", "chip_smoke_capture")
CAPTURE_W, CAPTURE_H = 540, 960
CAPTURE_TRAIN, CAPTURE_VAL = 8, 2
CAPTURE_DIN = 84          # real-capture nets: 63 position + 21 time lanes, no timenet
CAPTURE_SMALL = (72, 56)  # the card-vs-CPU camera: neither side a multiple of 16
RESIZE_FROM, RESIZE_TO = (2704, 2028), (1600, 1200)
# ... and the host's PNG reads of a frame of that size, each file read
# through Pillow where it imports and with PIL blocked (utils_io.decode_png)
PNG_FILES = {"Paeth": (4, False), "Average": (3, False), "Adam7 Paeth": (4, True)}

STRUCT_EXTENT = 2.75
REFERENCE_OCC_RES = 256   # the reference's normal-init grid (VERDICT r5 #8), timed only
# card vs CPU at the small size: float leaves within abs + rel of the CPU's
# (the same tolerances as the CPU parity tests against JAX,
# tests/test_torch_structural.py); normals abs 1e-4 (a face normal turns
# with its vertices, which move with the occupancy's float32 sums)
TOL_STRUCT_ABS, TOL_STRUCT_REL, TOL_STRUCT_NORMAL = 1e-5, 1e-4, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def sass_mma_counts(lib, func: str):
    """(HGMMA, HMMA) instructions in the SASS of the kernels of the built
    library ``lib`` whose names contain ``func``, from the toolkit's
    cuobjdump; None where it lists no such kernel."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=120).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = [0, 0]
        elif name is not None and "HGMMA" in line:
            counts[name][0] += 1
        elif name is not None and "HMMA" in line:
            counts[name][1] += 1
    hits = [v for k, v in counts.items() if func in k]
    return tuple(map(sum, zip(*hits))) if hits else None


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# seeded random kernel inputs with the edge cases


def random_composite_attrs(rng, T, K, tiles_x, tile):
    a = np.zeros((T, K, 16), np.float32)
    t = np.arange(T)
    ox = ((t % tiles_x) * tile)[:, None].astype(np.float32)
    oy = ((t // tiles_x) * tile)[:, None].astype(np.float32)
    a[..., 0] = ox + rng.uniform(-12, 28, (T, K))
    a[..., 1] = oy + rng.uniform(-12, 28, (T, K))
    ca = rng.uniform(0.005, 0.5, (T, K))
    cc = rng.uniform(0.005, 0.5, (T, K))
    a[..., 2] = ca
    a[..., 3] = rng.uniform(-0.9, 0.9, (T, K)) * np.sqrt(ca * cc)
    a[..., 4] = cc
    a[..., 5] = rng.uniform(0.0, 1.0, (T, K))
    a[..., 5][rng.random((T, K)) < 0.1] = 1.5          # alpha clamped at 0.99
    a[..., 6:9] = rng.uniform(0.0, 1.5, (T, K, 3))
    a[..., 9] = rng.random((T, K)) < 0.85              # invalid rows inside
    a[:, K - K // 8:, 9] = 0.0                         # and a padded tail
    return a


def random_shade_attrs(rng, T, K, tiles_x, tile):
    a = np.zeros((T, K, 24), np.float32)
    t = np.arange(T)
    ox = ((t % tiles_x) * tile)[:, None, None].astype(np.float32)
    oy = ((t // tiles_x) * tile)[:, None, None].astype(np.float32)
    a[..., 0:6:2] = ox + rng.normal(8, 10, (T, K, 3))  # both windings: back faces
    a[..., 1:6:2] = oy + rng.normal(8, 10, (T, K, 3))
    sliver = rng.random((T, K)) < 0.05                 # |area| < AREA_MIN
    a[..., 4][sliver] = a[..., 0][sliver] + 1e-6 * (a[..., 2][sliver] - a[..., 0][sliver])
    a[..., 5][sliver] = a[..., 1][sliver] + 1e-6 * (a[..., 3][sliver] - a[..., 1][sliver])
    a[..., 6:9] = rng.uniform(0.2, 2.0, (T, K, 3))
    a[..., 9] = rng.random((T, K)) < 0.8
    a[..., 10:19] = rng.random((T, K, 9))
    a[..., 19] = rng.integers(0, 1 << 20, (T, K))
    tie = np.nonzero(rng.random(K - 1) < 0.1)[0]       # exact z ties: a copy
    a[:, tie + 1, :19] = a[:, tie, :19]                # with another face id
    a[:, K - K // 8:, 9] = 0.0
    return a


def shade_tie_attrs(rng, T, K, tiles_x, tile):
    """random_shade_attrs with built ties in every eighth row: a vertex on a
    pixel centre (uu exactly 0 and 1 on its two edges, d2 ties between
    them, and ties at every pixel whose nearest edge point is that vertex),
    a pixel centre in the middle of an edge (d2 exactly 0), and a triangle
    symmetric about a column of pixel centres (d2 ties between its two
    slanted edges).  Every edge has a power-of-two squared length and every
    coordinate is a pixel centre plus an integer, so d2, uu and the ties
    come out exact in float32 whatever the rounding of the arithmetic
    (with or without fused multiply-adds)."""
    a = random_shade_attrs(rng, T, K, tiles_x, tile)
    t = np.arange(T)
    ox = ((t % tiles_x) * tile).astype(np.float32)
    oy = ((t // tiles_x) * tile).astype(np.float32)
    for k in range(0, K - K // 8, 8):
        x0 = ox + rng.integers(0, tile, T) + 0.5
        y0 = oy + rng.integers(0, tile, T) + 0.5
        kind = (k // 8) % 3
        if kind == 0:      # vertex a on the pixel centre
            tri = [x0, y0, x0 + 4, y0 + 4, x0, y0 + 8]
        elif kind == 1:    # pixel centre in the middle of edge a-b
            tri = [x0 - 4, y0, x0 + 4, y0, x0, y0 + 4]
        else:              # symmetric about the column x0
            tri = [x0, y0 - 4, x0 - 4, y0, x0 + 4, y0]
        a[:, k, 0:6] = np.stack(tri, -1)
        a[:, k, 9] = 1.0
    return a


# kernel 4's special shapes, (case, K) over SHADE_EDGE_TILES tiles of 16x16
# (CPU tests hold the twin to JAX at the same shapes): one row; a ragged K;
# a tile with no valid row beside a tile with some; every row valid; valid
# rows interleaved with invalid ones (the first invalid, so the valid rows
# are no prefix); one small triangle, so most pixels have no winner; then,
# after them so that those keep their rows, valid rows of the first tile
# with a NaN corner coordinate, with a NaN colour, or with two corners at
# +inf (a live, infinite area whose edge between them has a NaN squared
# length): a NaN where the twin has one
SHADE_EDGE_SHAPES = (("one row", 1), ("37 rows", 37), ("all invalid", 40),
                     ("all valid", 48), ("interleaved", 48), ("no winner", 3),
                     ("NaN corner", 20), ("NaN colour", 21), ("NaN edge", 22))
SHADE_NAN_CASES = ("NaN corner", "NaN colour", "NaN edge")
SHADE_EDGE_TILES = 2


def shade_edge_attrs(rng, case, K, T, tiles_x, tile):
    """shade_tie_attrs's rows (built ties in rows 0, 8, ...) recut into one
    of SHADE_EDGE_SHAPES's cases."""
    a = shade_tie_attrs(rng, T, K, tiles_x, tile)
    if case == "all invalid":
        a[0, :, 9] = 0.0
    elif case == "all valid":
        a[..., 9] = 1.0
    elif case == "interleaved":
        a[:, 0::2, 9] = 0.0
        a[:, 1::2, 9] = 1.0
    elif case == "no winner":
        a[:, 1:, 9] = 0.0           # row 0 alone: a built triangle of area 16
    elif case in SHADE_NAN_CASES:   # every fifth row of tile 0, from row 2
        r = slice(2, None, 5)
        a[0, r, 9] = 1.0
        if case == "NaN corner":
            a[0, r, 0] = np.nan
        elif case == "NaN colour":
            a[0, r, 11] = np.nan
        else:                       # b and c at x = +inf, by < ay < cy
            a[0, r, 2] = a[0, r, 4] = np.inf
            a[0, r, 3] = a[0, r, 1] - 3.0
            a[0, r, 5] = a[0, r, 1] + 5.0
    return a


# kernel 2's special shapes, (case, K) over COMPOSITE_EDGE_TILES tiles of
# 16x16 (CPU tests hold the twin to JAX at the same shapes): one row; a
# ragged K; a tile with no valid row beside a tile with some; every row
# valid; valid rows interleaved with invalid ones (the first invalid, so the
# valid rows are no prefix); rows whose o e^power is exactly 0.99 at a pixel
# (alpha at its clamp: d alpha gated off there); opaque rows stacked on the
# tile's centre until T falls to 0 there; then, after them so that those
# keep their rows, rows whose o e^power is NaN at every pixel (a NaN
# opacity) or at every pixel but the one under the mean (an infinite
# opacity and a conic so narrow that e^power is exactly 0 one pixel away:
# inf times 0; inf, clamped to 0.99, at the mean): a NaN fails the gate, as
# in JAX
COMPOSITE_EDGE_SHAPES = (("one row", 1), ("37 rows", 37), ("all invalid", 40),
                         ("all valid", 48), ("interleaved", 48), ("at the clamp", 32),
                         ("T to 0", 64), ("NaN opacity", 24), ("inf times 0", 20))
COMPOSITE_EDGE_TILES = 2


def composite_edge_attrs(rng, case, K, T, tiles_x, tile):
    """random_composite_attrs's rows recut into one of COMPOSITE_EDGE_SHAPES's
    cases."""
    a = random_composite_attrs(rng, T, K, tiles_x, tile)
    t = np.arange(T)
    ox = ((t % tiles_x) * tile)[:, None].astype(np.float32)
    oy = ((t // tiles_x) * tile)[:, None].astype(np.float32)
    if case in ("one row", "all valid"):
        a[..., 9] = 1.0
    elif case == "all invalid":
        a[0, :, 9] = 0.0
    elif case == "interleaved":
        a[:, 0::2, 9] = 0.0
        a[:, 1::2, 9] = 1.0
    elif case == "at the clamp":
        # every fourth row on a pixel centre (power exactly -0 there) with
        # opacity 0.99 in float32: o e^power is exactly ALPHA_MAX
        n = len(range(0, K, 4))
        a[:, 0::4, 0] = ox + rng.integers(0, tile, (T, n))
        a[:, 0::4, 1] = oy + rng.integers(0, tile, (T, n))
        a[:, 0::4, 5] = np.float32(0.99)
        a[:, 0::4, 9] = 1.0
    elif case == "T to 0":
        # the first half of the rows broad, opaque (0.98, below the clamp)
        # and centred on the tile: 32 of them take T below float32's range
        h = K // 2
        a[:, :h, 0] = ox + tile / 2
        a[:, :h, 1] = oy + tile / 2
        a[:, :h, 2] = a[:, :h, 4] = 0.005
        a[:, :h, 3] = 0.0
        a[:, :h, 5] = 0.98
        a[:, :h, 9] = 1.0
    elif case == "NaN opacity":
        a[..., 9] = 1.0
        a[:, 0::3, 5] = np.nan
    elif case == "inf times 0":
        # every fourth row on a pixel centre, power -5000 one pixel away
        n = len(range(0, K, 4))
        a[..., 9] = 1.0
        a[:, 0::4, 0] = ox + rng.integers(0, tile, (T, n))
        a[:, 0::4, 1] = oy + rng.integers(0, tile, (T, n))
        a[:, 0::4, 2] = a[:, 0::4, 4] = 1e4
        a[:, 0::4, 3] = 0.0
        a[:, 0::4, 5] = np.inf
    return a


def random_trunk(torch, din, device, seed):
    """A flax-initialised 8x256 trunk (lecun-normal kernels) with seeded
    N(0, 0.05) biases in place of flax's zeros, so the bias add is
    exercised; with its bf16 pack and float32 biases."""
    from dgmesh_torch.models.mlp import MLPTrunk
    from dgmesh_torch.ops import mlp_fused as MF
    gen = torch.Generator().manual_seed(seed)
    trunk = MLPTrunk(din, gen=gen)
    with torch.no_grad():
        for layer in trunk.layers:
            layer.bias.normal_(0.0, 0.05, generator=gen)
    trunk = trunk.to(device)
    wpack, bpack = MF.pack_trunk(trunk, din)
    return trunk, wpack.detach().to(torch.bfloat16).contiguous(), bpack.detach().contiguous()


def row_groups(torch, key):
    """The groups of equal rows of key (N, k), float32: for every row the
    index of its group's first row, and those first rows in row order.
    Rows are equal when their bits are; a row holding a NaN is a group of
    its own (NaN is equal to nothing)."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    alone = torch.where(torch.isnan(key).any(1), idx, -1).to(torch.int32)
    _, inv = torch.unique(torch.cat([key.contiguous().view(torch.int32), alone[:, None]], 1),
                          dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), n, dtype=idx.dtype, device=key.device)
    first.scatter_reduce_(0, inv, idx, "amin")
    return first[inv], first.sort().values


def trunk_measures(torch, x, g, got, want):
    """Kernels 5 and 6's (out, dx, dW, db) ``got`` against their twins'
    ``want`` on rows x and cotangent g, on any device: every NaN and
    infinity where the twin has one, over all rows, and the limits on the
    elements where the twin is finite.  The rows of out are grouped by their
    input row x and those of dx by (x, g) (row_groups): every row of a group
    must have the bits of the group's first row, and the norm ratio weighs
    each group once, by that row, so that one input repeated on most rows
    (the dead Gaussian slots) does not set it alone; on distinct rows it is
    the ratio over all rows, to the bit.  The max ratios run over all rows;
    dW and db are sums over the rows, as the step uses them.  Returns (ok,
    rep, groups): rep {output: (max |Δ| / max |twin|, ‖Δ‖ / ‖twin‖, max |Δ|,
    ‖Δ‖ / ‖twin‖ over all rows)}, groups {"out" and "dx": (distinct rows,
    every group the same bits)}."""
    keys = {"out": x, "dx": torch.cat([x, g], 1)}
    rep, groups, same_nonfinite = {}, {}, True
    for name, a, b in zip(("out", "dx", "dW", "db"), got, want):
        fin = torch.isfinite(b)
        same_nonfinite &= (torch.equal(torch.isfinite(a), fin)
                           and torch.equal(torch.isnan(a), torch.isnan(b)))
        d = torch.where(fin, a.double() - b.double(), 0.0)
        bf = torch.where(fin, b.double(), 0.0)
        worst = (float(d.abs().max()) / max(float(bf.abs().max()), 1e-30), float(d.abs().max()))
        norm_all = float(d.norm()) / max(float(bf.norm()), 1e-30)
        norm = norm_all
        if name in keys:
            first, reps = row_groups(torch, keys[name])
            bits = a.view(torch.int32)
            groups[name] = (reps.numel(), torch.equal(bits[first], bits))
            norm = float(d[reps].norm()) / max(float(bf[reps].norm()), 1e-30)
        rep[name] = (worst[0], norm, worst[1], norm_all)
    ok = same_nonfinite and all(same for _, same in groups.values()) and trunk_limits(rep)
    return ok, rep, groups


def trunk_limits(rep):
    """Whether the ratios (max, norm, ...) of rep are within TOL_MLP_*."""
    return (rep["out"][0] <= TOL_MLP_FWD_MAX and rep["out"][1] <= TOL_MLP_FWD_NORM
            and all(rep[k][1] <= TOL_MLP_BWD_NORM for k in ("dx", "dW", "db"))
            and all(rep[k][0] <= TOL_MLP_BWD_MAX for k in ("dW", "db")))


def compare_trunk(torch, MF, x, wb, bp, g):
    """Kernels 5 and 6 against their twins on the card, on rows x and
    cotangent g (trunk_measures)."""
    got = [MF.trunk_fwd(x, wb, bp), *MF.trunk_bwd(x, wb, bp, g)]
    want = [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]
    torch.cuda.synchronize()
    return trunk_measures(torch, x, g, got, want)


def trunk_pass_times(torch, MF, x, wb, bp, g):
    """Kernel 6's two passes timed apart on these rows (the launches go
    straight to the passes and are not counted), as one log line with each
    pass's rate on the products it needs: twice the forward's for the row
    pass (the recompute and the products with Wᵀ), once for the
    weight-gradient pass; that pass's share of its floor (the larger of its
    products at the bf16 peak and the bytes they need at the memory rate:
    x's din lanes and the workspace's 15 other buffers over the n rows read
    once, the row blocks' db sums read, dW and db written) and, as a
    yardstick, the same nine products as cuBLAS computes them from the same
    workspace (torch.bmm of the stacked buffers' transposes, float32 out)."""
    n, din = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty((9, 256, 256), dtype=torch.float32, device=x.device)
    db = torch.empty((8, 256), dtype=torch.float32, device=x.device)
    ws, db_part, dw_part = MF._bwd_buffers(n, din, x.device)
    wt = MF.transpose_pack(wb)
    rows_ms = time_cuda(torch, lambda: MF._bwd_rows(x, wb, wt, bp, g, dx, ws, db_part), 5)
    wgrad_ms = time_cuda(torch, lambda: MF._bwd_wgrad(ws, db_part, dw_part, dw, db, din), 5)
    flops = 2 * n * (7 * 256 * 256 + 2 * din * 256)
    nbytes = (n * ((MF.BWD_BUFFERS - 1) * 256 + din) * 2 + db_part.numel() * 4
              + (dw.numel() + db.numel()) * 4)
    floor_ms = max(flops / PEAK_BF16_TC, nbytes / PEAK_BYTES) * 1e3
    lib_ms = library_wgrad_ms(torch, ws)
    return (f"# timing/passes trunk_bwd ({n},{din}): row pass {rows_ms:.4f} ms "
            f"({2 * flops / rows_ms / 1e9:.1f} TFLOP/s), weight-gradient pass + reductions "
            f"{wgrad_ms:.4f} ms ({flops / wgrad_ms / 1e9:.1f} TFLOP/s; {dw_part.shape[0]} row "
            f"splits), {floor_ms / wgrad_ms:.1%} of its floor {floor_ms:.4f} ms "
            f"({'bytes' if nbytes / PEAK_BYTES > flops / PEAK_BF16_TC else 'operations'}); "
            f"the nine products by cuBLAS (bf16 in, float32 out) {lib_ms:.4f} ms")


def library_wgrad_ms(torch, ws):
    """ms of the weight-gradient pass's nine products Aᵀ·G by cuBLAS on the
    workspace ws (16, npad, 256) bf16, float32 out: one torch.bmm for e =
    0..7 (A the buffers 0..7, G 8..15) and one torch.mm for e = 8 (x and
    gmb_5)."""
    a, g = ws[:8].transpose(1, 2), ws[8:]

    def run():
        torch.bmm(a, g, out_dtype=torch.float32)
        torch.mm(ws[0].t(), ws[13], out_dtype=torch.float32)
    return time_cuda(torch, run, 5)


def trunk_report(rep, groups):
    return (", ".join(f"{k} max {v[0]:.3g} norm {v[1]:.3g}" for k, v in rep.items())
            + f" (norms over {groups['out'][0]} distinct rows for out, {groups['dx'][0]} "
            f"distinct (x, g) rows for dx; every group of equal rows the same bits: "
            f"{'yes' if all(same for _, same in groups.values()) else 'NO'})")


def cotangents(rng, T, P):
    """Seeded random cotangents (T,P,3) and (T,P)."""
    return (rng.normal(size=(T, P, 3)).astype(np.float32),
            rng.normal(size=(T, P)).astype(np.float32))


# lane groups of d_attrs held to a tolerance each (the per-row sums over the
# tile's pixels run in another order in the kernels than in the twins)
COMPOSITE_GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "opacity": [5], "rgb": [6, 7, 8]}
SHADE_GROUPS = {"screen": list(range(6)), "inv_w": [6, 7, 8], "colour": list(range(10, 19))}
ZERO_LANES = {"composite": list(range(9, 16)), "shade": [9] + list(range(19, 24))}


def compare_bwd(torch, got, want, groups, zero_lanes, invalid):
    """Per lane group: max |kernel - twin| against 1e-4·max|twin| + 1e-6
    where both are finite, and a NaN (or inf) exactly where the twin has
    one; the zero lanes and the invalid rows must be exactly 0 in the
    kernel's output.  Returns (max abs err, ok, {group: (err, tol)})."""
    torch.cuda.synchronize()
    rep, ok = {}, nonfinite_match(torch, got, want)
    for name, lanes in groups.items():
        g, w = got[..., lanes].double(), want[..., lanes].double()
        err = max_err((g,), (w,))
        tol = TOL_BWD_REL * max_err((w,), (torch.zeros_like(w),)) + TOL_BWD_ABS
        rep[name] = (err, tol)
        ok = ok and err <= tol
    ok = ok and not bool(got[..., zero_lanes].any()) and not bool(got[invalid].any())
    return max(e for e, _ in rep.values()), ok, rep


def check_composite_bwd(torch, SK, attrs, g, ga, geo, what, errs, failures, res=None):
    """Kernel 2 against its twin, without the forward's residuals and with
    them (kernel 1's, or ``res``: rgb and S), each twin given the same; with
    them launched twice: the same bits."""
    res = res if res is not None else SK.composite_tiles(attrs, *geo, residuals=True)[0::2]
    invalid = attrs[..., 9] < 0.5
    got = SK.composite_bwd(attrs, g, ga, *geo)
    e, ok, rep = compare_bwd(torch, got, SK.composite_bwd_ref(attrs, g, ga, *geo),
                             COMPOSITE_GROUPS, ZERO_LANES["composite"], invalid)
    got = SK.composite_bwd(attrs, g, ga, *geo, *res)
    same = bool(torch.equal(SK.composite_bwd(attrs, g, ga, *geo, *res), got))
    e_r, ok_r, rep_r = compare_bwd(
        torch, got, SK.composite_bwd_ref(attrs, g, ga, *geo, rgb=res[0], S=res[1]),
        COMPOSITE_GROUPS, ZERO_LANES["composite"], invalid)
    errs["composite_bwd"] += [e, e_r]
    log(f"# kernels/{what} {tuple(attrs.shape)} "
        + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
        + f" {'ok' if ok else 'FAIL'}; with kernel 1's residuals "
        + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep_r.items())
        + f" {'ok' if ok_r else 'FAIL'}, twice {'identical' if same else 'DIFFERENT'}")
    if not (ok and ok_r and same):
        failures.append(f"composite_bwd vs twin ({what})")


def check_shade_bwd(torch, MK, attrs, g, gs, geo, what, errs, failures, res=None):
    """Kernel 4 against its twin, and given the forward's residuals (kernel
    3's, or ``res``) against itself without them: the same bits."""
    got = MK.shade_bwd(attrs, g, gs, *geo)
    res = res if res is not None else MK.shade_tiles(attrs, *geo, residuals=True)[4:]
    same = same_bits(torch, MK.shade_bwd(attrs, g, gs, *geo, *res), got)
    want = MK.shade_bwd_ref(attrs, g, gs, *geo)
    e, ok, rep = compare_bwd(torch, got, want, SHADE_GROUPS, ZERO_LANES["shade"],
                             attrs[..., 9] < 0.5)
    errs["shade_bwd"].append(e)
    log(f"# kernels/{what} {tuple(attrs.shape)} "
        + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
        + f"; {nan_report(torch, (got,), (want,))}"
        + f" {'ok' if ok else 'FAIL'}; with kernel 3's residuals "
        f"{'the same bits' if same else 'DIFFERENT'}")
    if not (ok and same):
        failures.append(f"shade_bwd vs twin ({what})")


# ---------------------------------------------------------------------------
# the work these rows need, for bound_ms


def composite_pairs(torch, SK, attrs, sc, chunk=100):
    """(pixel, row) pairs of composite rows, counted in tile chunks: of
    valid rows; of those the ones that pass the alpha tests (power <= 0,
    alpha >= 1/255); and of these the ones below the 0.99 clamp, whose
    d alpha the backward does not gate off."""
    T = attrs.shape[0]
    n_valid = int((attrs[..., 9] > 0.5).sum()) * sc.tile_h * sc.tile_w
    n_pass = n_live = 0
    px, py = SK.tile_pixels(T, sc.tiles_x, sc.tile_h, sc.tile_w, 0.0, attrs.device)
    with torch.no_grad():
        for s in range(0, T, chunk):
            at = attrs[s:s + chunk]
            dx = at[..., 0:1] - px[s:s + chunk, None]
            dy = at[..., 1:2] - py[s:s + chunk, None]
            pw = -0.5 * (at[..., 2:3] * dx * dx + at[..., 4:5] * dy * dy) - at[..., 3:4] * dx * dy
            raw = at[..., 5:6] * torch.exp(pw)
            ok = ((at[..., 9:10] > 0.5) & (pw <= 0)
                  & (torch.clamp_max(raw, SK.ALPHA_MAX) >= SK.ALPHA_MIN))
            n_pass += int(ok.sum())
            n_live += int((ok & (raw < SK.ALPHA_MAX)).sum())
    return n_valid, n_pass, n_live


def shade_pairs(torch, SK, attrs, g_rgb, g_soft, mc, chunk=16):
    """What the shade backward must compute on these rows and cotangents,
    counted in tile chunks with the plain twin's formulas: the (pixel, row)
    pairs of valid rows; those whose soft-path gradient is not zero
    (g_soft·e^M·s, gated by s <= 1 - 1e-6); and the pixels with a z-buffer
    winner and a non-zero g_rgb, where the rgb path runs."""
    T = attrs.shape[0]
    n_valid = int((attrs[..., 9] > 0.5).sum()) * mc.tile_h * mc.tile_w
    n_soft = n_rgb = 0
    px_all, py_all = SK.tile_pixels(T, mc.tiles_x, mc.tile_h, mc.tile_w, 0.5, attrs.device)
    with torch.no_grad():
        for s in range(0, T, chunk):
            a = attrs[s:s + chunk]
            px, py = px_all[s:s + chunk, None, :], py_all[s:s + chunk, None, :]
            ax, ay, bx, by, cx, cy = (a[..., i:i + 1] for i in range(6))
            valid = a[..., 9:10] > 0.5
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            live = area.abs() >= 1e-4
            area = torch.where(live, area, 1.0)
            inside = valid & live
            d2min = None
            for vx0, vy0, vx1, vy1 in ((ax, ay, bx, by), (bx, by, cx, cy), (cx, cy, ax, ay)):
                # the edge function of the vertex opposite this edge, and
                # the squared distance to the segment
                inside = inside & (((vx1 - vx0) * (py - vy0) - (vy1 - vy0) * (px - vx0))
                                   / area >= 0.0)
                ex, ey, qx, qy = vx1 - vx0, vy1 - vy0, px - vx0, py - vy0
                t = torch.clamp((qx * ex + qy * ey) / torch.clamp_min(ex * ex + ey * ey, 1e-12),
                                0.0, 1.0)
                d2 = (qx - t * ex) ** 2 + (qy - t * ey) ** 2
                d2min = d2 if d2min is None else torch.minimum(d2min, d2)
            dist = torch.sqrt(d2min + 1e-12)
            sg = torch.where(valid, torch.sigmoid(torch.where(inside, dist, -dist) / mc.sigma),
                             0.0)
            m = torch.log1p(-torch.clamp(sg, 0.0, 1.0 - 1e-6)).sum(1, keepdim=True)
            gs = -g_soft[s:s + chunk, None, :] * torch.exp(m) / mc.sigma
            n_soft += int(((gs * sg * ((sg <= 1.0 - 1e-6) & valid)) != 0).sum())
            n_rgb += int((inside.any(1) & (g_rgb[s:s + chunk] != 0).any(-1)).sum())
    return n_valid, n_soft, n_rgb


# ---------------------------------------------------------------------------
# timing


def time_cuda(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_err(a, b):
    """max |x - y| over the pairs of tensors, at the places where both are
    finite."""
    out = 0.0
    for x, y in zip(a, b):
        both = x.isfinite() & y.isfinite()
        if bool(both.any()):
            out = max(out, float((x.double() - y.double())[both].abs().max()))
    return out


def nonfinite_match(torch, a, b):
    """NaN where the other has NaN, and ±inf where the other has ±inf."""
    return (bool(torch.equal(a.isnan(), b.isnan()))
            and bool(torch.equal(a.isposinf(), b.isposinf()))
            and bool(torch.equal(a.isneginf(), b.isneginf())))


def nan_report(torch, got, want):
    """How the kernel's NaNs sit against the twin's, over pairs of tensors:
    'NaN n as the twin's, m missing, k extra'."""
    both = miss = extra = 0
    for x, y in zip(got, want):
        both += int((x.isnan() & y.isnan()).sum())
        miss += int((~x.isnan() & y.isnan()).sum())
        extra += int((x.isnan() & ~y.isnan()).sum())
    return f"NaN {both} as the twin's, {miss} missing, {extra} extra"


def same_bits(torch, a, b):
    """The same bits, NaNs of any payload or sign counted as equal."""
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    na, nb = a.isnan(), b.isnan()
    return (bool(torch.equal(na, nb))
            and bool(torch.equal(a.masked_fill(na, 0).view(torch.int32),
                                 b.masked_fill(nb, 0).view(torch.int32))))


def compare_composite(torch, SK, attrs, geo):
    """Kernel 1 against its twin; with its residual S against without: rgb
    and alpha the same bits, S within TOL_COMPOSITE of the twin's relative
    to max(1, |S|); and launched twice with S: the same bits.  Returns (max
    abs err of rgb and alpha, ok, residual ok, twice identical)."""
    got = SK.composite_tiles(attrs, *geo)
    res = SK.composite_tiles(attrs, *geo, residuals=True)
    again = SK.composite_tiles(attrs, *geo, residuals=True)
    want = SK.composite_tiles_ref(attrs, *geo, residuals=True)
    torch.cuda.synchronize()
    err = max_err(got, want[:2])
    ok = all(bool(torch.isfinite(x).all()) for x in got) and err <= TOL_COMPOSITE
    s_tol = TOL_COMPOSITE * want[2].abs().clamp_min(1.0)
    res_ok = (all(bool(torch.equal(x, y)) for x, y in zip(got, res[:2]))
              and bool(((res[2] - want[2]).abs() <= s_tol).all()))
    same = all(bool(torch.equal(x, y)) for x, y in zip(res, again))
    return err, ok, res_ok, same


def check_composite(torch, SK, attrs, geo, what, errs, failures):
    """compare_composite, logged; a failure of any part is recorded."""
    e, ok, res_ok, same = compare_composite(torch, SK, attrs, geo)
    errs["composite_tiles"].append(e)
    log(f"# kernels/{what} {tuple(attrs.shape)} max_abs_err {e:.3g} (tol {TOL_COMPOSITE}) "
        f"{'ok' if ok else 'FAIL'}; with residuals: "
        f"{'the same outputs, S ok' if res_ok else 'FAIL'}; twice "
        f"{'identical' if same else 'DIFFERENT'}")
    if not ok:
        failures.append(f"composite_tiles vs twin ({what})")
    if not res_ok:
        failures.append(f"composite_tiles residuals ({what})")
    if not same:
        failures.append(f"composite_tiles not deterministic ({what})")


def compare_shade(torch, MK, attrs, geo, sigma):
    """Kernel 3 against its twin (a NaN where the twin has one, the finite
    values within TOL_SHADE); and with its residuals against without:
    the four outputs the same bits, the winner rows equal to the twin's,
    M within TOL_SHADE of the twin's relative to max(1, |M|); and launched
    twice with its residuals: the same bits.  Returns (max abs err of rgb
    and soft, ok, fid mismatches, residuals ok, twice identical)."""
    got = MK.shade_tiles(attrs, *geo, sigma)
    res = MK.shade_tiles(attrs, *geo, sigma, residuals=True)
    again = MK.shade_tiles(attrs, *geo, sigma, residuals=True)
    want = MK.shade_tiles_ref(attrs, *geo, sigma, residuals=True)
    torch.cuda.synchronize()
    err = max_err((got[0], got[2]), (want[0], want[2]))
    exact = bool(torch.equal(got[1], want[1])) and bool(torch.equal(got[3], want[3]))
    n_fid = int((got[3] != want[3]).sum())
    ok = (all(nonfinite_match(torch, x, y) for x, y in zip(got, want[:4]))
          and err <= TOL_SHADE and exact)
    m_tol = TOL_SHADE * want[5].abs().clamp_min(1.0)
    res_ok = (all(same_bits(torch, x, y) for x, y in zip(got, res[:4]))
              and bool(torch.equal(res[4], want[4]))
              and nonfinite_match(torch, res[5], want[5])
              and bool(((res[5] - want[5]).abs() <= m_tol)[want[5].isfinite()].all()))
    same = all(same_bits(torch, x, y) for x, y in zip(res, again))
    return err, ok, n_fid, res_ok, same, nan_report(torch, res, want)


def check_shade(torch, MK, attrs, geo, sigma, what, errs, failures):
    """compare_shade, logged; a failure of any part is recorded."""
    e, ok, nf, res_ok, same, nans = compare_shade(torch, MK, attrs, geo, sigma)
    errs["shade_tiles"].append(e)
    log(f"# kernels/{what} {tuple(attrs.shape)} max_abs_err {e:.3g} (tol {TOL_SHADE}; {nans}; "
        f"hard/fid exact, {nf} fid mismatches) {'ok' if ok else 'FAIL'}; with residuals: "
        f"{'the same outputs, residuals ok' if res_ok else 'FAIL'}; twice "
        f"{'identical' if same else 'DIFFERENT'}")
    if not ok:
        failures.append(f"shade_tiles vs twin ({what})")
    if not res_ok:
        failures.append(f"shade_tiles residuals ({what})")
    if not same:
        failures.append(f"shade_tiles not deterministic ({what})")


# ---------------------------------------------------------------------------
# state


def perturb_heads(torch, nets, gen, std=1e-4):
    """Seeded noise on the zero-initialised offset heads, so the deformation
    is not identically zero."""
    with torch.no_grad():
        for net in nets:
            for name, mod in net.named_modules():
                if name.startswith("head_") and not mod.weight.any():
                    mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen,
                                                 device=gen.device) * std)
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen,
                                               device=gen.device) * std)


def build_shell_state(torch, cfg, n_gauss, device, seed=0):
    """bench.py's frozen mesh-phase state: a noisy spherical shell of radius
    0.45-0.5 with outward normals and log-scale 0.01 (bench.py:100-114)."""
    from dgmesh_torch.train.state import init_state

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_gauss, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 0.45 + 0.05 * rng.random((n_gauss, 1))
    pts = (d * r).astype(np.float32)
    cols = rng.random((n_gauss, 3)).astype(np.float32)
    st = init_state(cfg, pts, cols, seed=seed, device=device)
    alive = st.gs.alive[:, None]
    normal = torch.zeros_like(st.gp.normal)
    normal[:n_gauss] = torch.as_tensor(d, dtype=torch.float32)
    gp = st.gp._replace(normal=normal * alive,
                        scaling=torch.where(alive, math.log(0.01), st.gp.scaling))
    st = st._replace(gp=gp)
    perturb_heads(torch, st.nets, torch.Generator(device=device).manual_seed(seed))
    return st


def call_by_stage(torch, targets, call, repeats, what="render_frame", per_call=None,
                  keep=None):
    """Run ``call`` ``repeats`` times with each ``(owner, attribute, stage)``
    of ``targets`` replaced by a wrapper that times its call between two
    synchronisations and keeps its arguments; the originals are put back
    after.  Returns ({stage: median over the repeats of its ms per call},
    median ms of the whole call, {stage: arguments of its last call}).  A
    stage is called once per call, or ``per_call[stage]`` times; otherwise
    this fails: the targets no longer match what ``what`` calls.  With a
    dict ``keep``, keep[stage] lists the arguments of each of its calls in
    the last repeat."""
    per_call = per_call or {}
    times = {stage: [] for _, _, stage in targets}
    args = {}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]

    def timed(stage, fn):
        # functools.wraps carries a kernel wrapper's launch counter across:
        # the wrapper counts by its module-global name, which is ours here
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            times[stage].append((time.perf_counter() - t0) * 1e3)
            args[stage] = a
            if keep is not None:
                keep.setdefault(stage, []).append(a)
            return res
        return wrapper

    totals = []
    try:
        for (owner, attr, fn), (_, _, stage) in zip(saved, targets):
            setattr(owner, attr, timed(stage, fn))
        for r in range(repeats):
            if keep is not None:
                keep.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            totals.append((time.perf_counter() - t0) * 1e3)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    missing = [k for k, ts in times.items() if len(ts) != repeats * per_call.get(k, 1)]
    if missing:
        raise RuntimeError(f"{what} did not call {missing} "
                           f"{[per_call.get(k, 1) for k in missing]} times per call")
    per_repeat = {k: [sum(ts[i * per_call.get(k, 1):(i + 1) * per_call.get(k, 1)])
                      for i in range(repeats)] for k, ts in times.items()}
    return ({k: statistics.median(ts) for k, ts in per_repeat.items()},
            statistics.median(totals), args)


def bench_batch(W, H, device, seed=0):
    """bench.py's training view: the frontal camera at distance 2.5, fovx
    0.8, fid 0.5, time interval 0.01, a seeded random GT image and an
    all-ones mask (bench.py:116-121)."""
    from dgmesh_torch.cameras import camera_from_c2w_blender
    from dgmesh_torch.train.step import make_batch

    rng = np.random.default_rng(seed)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    img = rng.random((H, W, 3)).astype(np.float32)
    cam = camera_from_c2w_blender(0, c2w, 0.8, W, H, 0.5, image=img,
                                  alpha_mask=np.ones((H, W, 1), np.float32))
    return make_batch(cam, 0.01, np.zeros(3, np.float32), device=device)


def train_flags(step, sh_degree):
    """bench.py's mesh-phase flags, with the densify statistics on."""
    return step.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                          densify_stats=True, sh_degree=sh_degree)


def step_problems(torch, m):
    """What is wrong with one training step's metrics, as a list."""
    bad = [k for k in ("loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss",
                       "img_loss") if not bool(torch.isfinite(m[k]))]
    bad += [f"{k} {int(m[k])}" for k in ("mesh_overflow", "nonfinite_grad_leaves")
            if int(m[k]) != 0]
    bad += [f"{k} 0" for k in ("mesh_n_verts", "mesh_n_faces") if int(m[k]) == 0]
    return bad


def view_batches(cfg_w, cfg_h, n, device, radius=2.5, fovx=0.8):
    from dgmesh_torch.cameras import camera_from_c2w_blender, orbit_camera_poses
    from dgmesh_torch.train.step import make_batch

    poses = orbit_camera_poses(n, radius=radius, elevation=0.35)
    out = []
    for i, c2w in enumerate(poses):
        fid = i / max(n - 1, 1)
        cam = camera_from_c2w_blender(i, c2w, fovx, cfg_w, cfg_h, fid)
        out.append(make_batch(cam, 0.01, np.zeros(3, np.float32), device=device))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import dgmesh_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    from dgmesh_torch.config import Config
    from dgmesh_torch.device import resolve_device
    from dgmesh_torch.eval import testing
    from dgmesh_torch.eval.testing import render_frame_with_aux
    from dgmesh_torch.ops import cuda_build
    from dgmesh_torch.ops import mesh_raster as MR
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.ops import splat
    from dgmesh_torch.ops import splat_kernels as SK
    from dgmesh_torch.train import step
    from dgmesh_torch.train.step import StepContext

    dev = resolve_device(DEVICE)
    failures = []

    # 1. card ----------------------------------------------------------------
    card = card_line()
    log(card)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"# build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{n} {s:.2f} s" for n, s in cuda_build.build_seconds.items()))
    for n, text in cuda_build.build_log.items():
        for line in text.splitlines():
            # ptxas reports a serialised wgmma pipeline as info C7515
            if any(k in line for k in ("registers", "spill", "warning", "C75")):
                log(f"#   {n}: {line.strip()}")
    # every product of kernel 6's weight-gradient pass on wgmma: HGMMA and no
    # HMMA (mma.sync) in its SASS
    mma = sass_mma_counts(cuda_build._target("mlp_bwd"), "mlp_bwd_wgrad")
    log(f"# sass: mlp_bwd_wgrad HGMMA, HMMA {mma}")
    if mma is None or mma[0] == 0 or mma[1] != 0:
        failures.append(f"kernel 6's weight-gradient pass: HGMMA, HMMA {mma} in its SASS")

    cfg = load_cfg()
    if PROFILE:
        return profile_train(torch, cfg, dev)

    # 3. kernels vs twins on seeded random rows at full width ----------------
    t = cfg.tpu
    W = H = IMG
    ctx = StepContext(cfg, W, H, device=dev)
    sc, mc = ctx.splat_cfg, ctx.mr_cfg
    geo_s = (sc.tiles_x, sc.tile_h, sc.tile_w)
    geo_m = (mc.tiles_x, mc.tile_h, mc.tile_w)
    rng = np.random.default_rng(0)
    errs = {"composite_tiles": [], "shade_tiles": []}
    a1 = torch.as_tensor(random_composite_attrs(rng, sc.num_tiles, sc.max_per_tile,
                                                sc.tiles_x, sc.tile_w), device=dev)
    check_composite(torch, SK, a1, geo_s, "random: composite_tiles", errs, failures)
    a2 = torch.as_tensor(random_shade_attrs(rng, mc.num_tiles, mc.max_per_tile,
                                            mc.tiles_x, mc.tile_w), device=dev)
    check_shade(torch, MK, a2, geo_m, mc.sigma, "random: shade_tiles", errs, failures)
    P = sc.tile_h * sc.tile_w
    errs["composite_bwd"], errs["shade_bwd"] = [], []
    g1, g2 = (torch.as_tensor(x, device=dev) for x in cotangents(rng, sc.num_tiles, P))
    check_composite_bwd(torch, SK, a1, g1, g2, geo_s, "random: composite_bwd", errs, failures)
    # ... and, with kernel 1, at the shapes that are special to their
    # compaction, gates and sums
    for case, K in COMPOSITE_EDGE_SHAPES:
        nt = COMPOSITE_EDGE_TILES
        erng = np.random.default_rng(K)   # the CPU test's rows
        ae = torch.as_tensor(composite_edge_attrs(erng, case, K, nt, 2, sc.tile_w), device=dev)
        ge, gae = (torch.as_tensor(x, device=dev) for x in cotangents(erng, nt, P))
        check_composite(torch, SK, ae, (2, sc.tile_h, sc.tile_w), f"edge: composite_tiles {case}",
                        errs, failures)
        check_composite_bwd(torch, SK, ae, ge, gae, (2, sc.tile_h, sc.tile_w),
                            f"edge: composite_bwd {case}", errs, failures)
    # ... and kernel 1 at 12x12 tiles: 144 pixel threads, not whole warps, in
    # rows, over two batches of valid rows
    a12 = torch.as_tensor(random_composite_attrs(np.random.default_rng(12), COMPOSITE_EDGE_TILES,
                                                 200, 2, 12), device=dev)
    check_composite(torch, SK, a12, (2, 12, 12), "edge: composite_tiles 12x12 tiles", errs,
                    failures)
    a3 = torch.as_tensor(shade_tie_attrs(rng, mc.num_tiles, mc.max_per_tile,
                                         mc.tiles_x, mc.tile_w), device=dev)
    g3, g4 = (torch.as_tensor(x, device=dev) for x in cotangents(rng, mc.num_tiles, P))
    check_shade(torch, MK, a3, geo_m, mc.sigma, "random: shade_tiles with built ties", errs,
                failures)
    check_shade_bwd(torch, MK, a3, g3, g4, geo_m + (mc.sigma,),
                    "random: shade_bwd with built ties", errs, failures)
    # ... and at the shapes that are special to its compaction and row sums
    for case, K in SHADE_EDGE_SHAPES:
        nt = SHADE_EDGE_TILES
        erng = np.random.default_rng(K)   # the CPU test's rows
        ae = torch.as_tensor(shade_edge_attrs(erng, case, K, nt, 2, mc.tile_w), device=dev)
        ge, gse = (torch.as_tensor(x, device=dev) for x in cotangents(erng, nt, P))
        check_shade(torch, MK, ae, (2, mc.tile_h, mc.tile_w), mc.sigma,
                    f"edge: shade_tiles {case}", errs, failures)
        check_shade_bwd(torch, MK, ae, ge, gse, (2, mc.tile_h, mc.tile_w, mc.sigma),
                        f"edge: shade_bwd {case}", errs, failures)
    # ... and at 12x12 tiles: 144 pixel threads, not whole warps, in rows
    # (kernel 3 takes 8x4 pixel blocks a warp only where the tile divides)
    a12 = torch.as_tensor(random_shade_attrs(np.random.default_rng(12), SHADE_EDGE_TILES, 40,
                                             2, 12), device=dev)
    check_shade(torch, MK, a12, (2, 12, 12), mc.sigma, "edge: shade_tiles 12x12 tiles", errs,
                failures)
    # 3t. kernels 1-4 on a rank's block of tiles (tile0 = T/2)
    check_tile0(torch, SK, MK, a1, g1, g2, geo_s, a3, g3, g4, geo_m, mc.sigma, errs, failures)
    from dgmesh_torch.ops import mlp_fused as MF
    if MULTI_ONLY:
        counters = (SK.composite_tiles, SK.composite_bwd, MK.shade_tiles, MK.shade_bwd,
                    MF.trunk_fwd, MF.trunk_bwd)
        del a1, a2, a3, g1, g2, g3, g4
        t0 = time.perf_counter()
        multi_device_phase(torch, dev, failures)
        log(f"# phase 9 (multi-device): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        six_dof_phase(torch, dev, failures, counters)
        log(f"# phase 10 (6-DoF): {time.perf_counter() - t0:.2f} s")
        if failures:
            print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
            return 1
        log("# --multi-device-only: stopping after phases 9 and 10; no result line")
        return 0
    # kernels 5 and 6 (the fused trunk) at the step's row counts, din 93
    errs["trunk_fwd"], errs["trunk_bwd"] = [], []
    _, wb, bp = random_trunk(torch, MLP_DIN, dev, seed=0)
    for n in MLP_ROWS:
        x = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, MLP_DIN)).astype(np.float32), device=dev)
        g = torch.as_tensor(rng.normal(size=(n, 256)).astype(np.float32), device=dev)
        ok, rep, groups = compare_trunk(torch, MF, x, wb, bp, g)
        errs["trunk_fwd"].append(rep["out"][2])
        errs["trunk_bwd"].append(max(rep[k][2] for k in ("dx", "dW", "db")))
        log(f"# kernels/random: trunk_fwd/trunk_bwd ({n},{MLP_DIN}): "
            f"{trunk_report(rep, groups)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"trunk kernels vs twins (random, {n} rows)")
        # kernels 5 and 6 twice on the same inputs: fixed-order sums, the same bits
        same_fwd = torch.equal(MF.trunk_fwd(x, wb, bp), MF.trunk_fwd(x, wb, bp))
        first, again = MF.trunk_bwd(x, wb, bp, g), MF.trunk_bwd(x, wb, bp, g)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        log(f"# kernels/random: ({n},{MLP_DIN}) twice: trunk_fwd "
            f"{'identical' if same_fwd else 'DIFFERENT'} out; trunk_bwd "
            f"{'identical' if same else 'DIFFERENT'} dx, dW, db")
        if not same_fwd:
            failures.append(f"trunk_fwd not deterministic ({n} rows)")
        if not same:
            failures.append(f"trunk_bwd not deterministic ({n} rows)")
        del first, again
        log(trunk_pass_times(torch, MF, x, wb, bp, g))
        if KERNELS_ONLY:
            ws = MF.stage_pack(MF.transpose_pack(wb))
            for name, fk in (("trunk_fwd", lambda: MF.trunk_fwd(x, wb, bp, ws)),
                             ("trunk_bwd", lambda: MF.trunk_bwd(x, wb, bp, g))):
                log(f"# timing/random {name} ({n} rows): "
                    f"{time_cuda(torch, fk, 5):.4f} ms/launch")
        del x, g
    # ... at the shapes the kernels' tiling makes special: one row, a second
    # warpgroup wholly past n, a ragged last CTA, din 1 and 256 and either
    # side of a 64-lane block
    for n, din, *case in MLP_EDGE_SHAPES:
        _, wbe, bpe = (random_trunk(torch, din, dev, seed=din) if din != MLP_DIN
                       else (None, wb, bp))
        x = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, din)).astype(np.float32), device=dev)
        g = torch.as_tensor(rng.normal(size=(n, 256)).astype(np.float32), device=dev)
        what = f"({n},{din}{', ' + case[0] if case else ''})"
        if case:
            x[::7, 3] = float("nan")
        ok, rep, groups = compare_trunk(torch, MF, x, wbe, bpe, g)
        if case:
            n_nan = int(torch.isnan(MF.trunk_fwd(x, wbe, bpe)).all(1).sum())
            ok = ok and n_nan == len(range(0, n, 7))
            what += f" ({n_nan} output rows NaN, as the twin's)"
        errs["trunk_fwd"].append(rep["out"][2])
        errs["trunk_bwd"].append(max(rep[k][2] for k in ("dx", "dW", "db")))
        # kernel 6 twice on the same inputs: the same bits (NaN included)
        first, again = MF.trunk_bwd(x, wbe, bpe, g), MF.trunk_bwd(x, wbe, bpe, g)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(first, again))
        log(f"# kernels/edge: trunk_fwd/trunk_bwd {what}: {trunk_report(rep, groups)} "
            f"{'ok' if ok else 'FAIL'}; trunk_bwd twice "
            f"{'identical' if same else 'DIFFERENT'}")
        if not ok:
            failures.append(f"trunk kernels vs twins (edge shape {what})")
        if not same:
            failures.append(f"trunk_bwd not deterministic (edge shape {what})")
        del x, g, first, again
    if KERNELS_ONLY:
        r1 = SK.composite_tiles(a1, *geo_s, residuals=True)[0::2]
        for name, fk in (("composite_bwd", lambda: SK.composite_bwd(a1, g1, g2, *geo_s)),
                         ("composite_bwd with residuals",
                          lambda: SK.composite_bwd(a1, g1, g2, *geo_s, *r1)),
                         ("shade_bwd", lambda: MK.shade_bwd(a3, g3, g4, *geo_m, mc.sigma))):
            log(f"# timing/random {name}: {time_cuda(torch, fk, 5):.4f} ms/launch")
        if failures:
            print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
            return 1
        log("# --kernels-only: stopping after the kernel checks; no result line")
        return 0
    del a1, a2, a3, g1, g2, g3, g4

    # 4. render --------------------------------------------------------------
    t0 = time.perf_counter()
    state = build_shell_state(torch, cfg, N_GAUSS, dev)
    batches = view_batches(W, H, N_VIEWS, dev)
    torch.cuda.synchronize()
    log(f"# state: {int(state.gs.alive.sum())} live Gaussians of {t.max_gaussians}, "
        f"grid {cfg.model.grid_res}, {W}x{H}, K {t.max_gaussians_per_tile}/"
        f"{t.max_faces_per_tile}, built in {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    SK.composite_tiles.launches = 0
    MK.shade_tiles.launches = 0
    renders = 0
    for i, b in enumerate(batches):
        times = []
        for r in range(1 + REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, aux = render_frame_with_aux(ctx, state, b, cfg.model.sh_degree)
            torch.cuda.synchronize()
            renders += 1
            if r:
                times.append((time.perf_counter() - t0) * 1e3)
        finite = all(bool(torch.isfinite(out[k]).all())
                     for k in ("render", "mesh_image", "mask", "verts", "vtx_color"))
        shapes_ok = (tuple(out["render"].shape) == (3, H, W)
                     and tuple(out["mesh_image"].shape) == (3, H, W)
                     and tuple(out["mask"].shape) == (H, W))
        ovf = {k: int(v) for k, v in aux.items()}
        V, F = int(out["n_verts"]), int(out["n_faces"])
        log(f"# view {i} fid {float(b.fid):.3f}: {statistics.median(times):.2f} ms median of "
            f"{REPEATS} ({', '.join(f'{x:.2f}' for x in times)}); V {V} F {F}; "
            f"overflow splat {ovf['splat_overflow']} dup {ovf['splat_dup_overflow']} "
            f"mesh {ovf['mesh_overflow']} raster {ovf['raster_overflow']}; "
            f"finite {finite}; mean gs {float(out['render'].mean()):.5f} "
            f"mesh {float(out['mesh_image'].mean()):.5f} mask {float(out['mask'].mean()):.5f}")
        if not (finite and shapes_ok):
            failures.append(f"view {i}: non-finite or misshapen output")
        if ovf["mesh_overflow"] != 0:
            failures.append(f"view {i}: mesh_overflow {ovf['mesh_overflow']} != 0")
        if V == 0 or F == 0:
            failures.append(f"view {i}: empty mesh")
    launches = {"composite_tiles": SK.composite_tiles.launches,
                "shade_tiles": MK.shade_tiles.launches}
    log(f"# renders {renders}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for k, n in launches.items():
        if n < renders:
            failures.append(f"{k}: {n} launches in {renders} renders")

    # 4b. view 0 again through render_frame, each function it calls wrapped
    #     to time it (where the time goes) and to keep the kernels' inputs;
    #     the kernels are then held against their twins on those real rows,
    #     and timed ----------------------------------------------------------
    targets = [  # what render_frame calls, in order
        (testing, "_deform_all", "deform_mlps"),
        (splat, "preprocess", "splat_preprocess"),
        (splat, "bin_gaussians", "splat_binning"),
        (splat, "tile_attrs", "splat_tile_rows"),
        (SK, "composite_tiles", "composite_kernel"),
        (ctx, "dpsr", "dpsr"),
        (step, "marching_tets", "marching_tets"),
        (testing, "_mesh_colors", "mesh_color_mlps"),
        (MR, "rasterize", "mesh_binning"),
        (MR, "tile_attrs", "mesh_tile_rows"),
        (MK, "shade_tiles", "shade_kernel"),
    ]
    with torch.no_grad():
        stages, total, args = call_by_stage(
            torch, targets,
            lambda: render_frame_with_aux(ctx, state, batches[0], cfg.model.sh_degree),
            REPEATS)
    log(f"# stages of view 0 (ms, median of {REPEATS}, host clock around synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.2f}; whole call {total:.2f}, of it outside "
        f"the stages {total - sum(stages.values()):.2f}")
    # float32 MLP work: 2 * rows * sum(din * dout) over each net's layers
    nets = state.nets
    rows_d = args["deform_mlps"][1].shape[0]
    rows_c = int(args["mesh_color_mlps"][2].sum())
    for stage, rows, pair in (("deform_mlps", rows_d, (nets.deform, nets.deform_normal)),
                              ("mesh_color_mlps", rows_c, (nets.deform_back, nets.appearance))):
        flop = 2 * rows * sum(m.in_features * m.out_features for net in pair
                              for m in net.modules() if isinstance(m, torch.nn.Linear))
        log(f"# {stage}: {rows} rows, {flop / 1e9:.2f} GFLOP, "
            f"{flop / stages[stage] / 1e9:.2f} TFLOP/s over the stage's time")
    ra1, ra2 = args["composite_kernel"][0], args["shade_kernel"][0]
    if args["composite_kernel"][1:] != geo_s or args["shade_kernel"][1:] != geo_m + (mc.sigma,):
        failures.append("kernels called with another geometry than the config's")
    check_composite(torch, SK, ra1, geo_s, "view0: composite_tiles", errs, failures)
    check_shade(torch, MK, ra2, geo_m, mc.sigma, "view0: shade_tiles", errs, failures)

    P = sc.tile_h * sc.tile_w
    T1, K1 = ra1.shape[:2]
    T2, K2 = ra2.shape[:2]
    v1, n_pass, _ = composite_pairs(torch, SK, ra1, sc)
    v2 = int((ra2[..., 9] > 0.5).sum()) * P
    kernel_rows = {  # name: (kernel call, twin call, bytes, operations) at real rows
        "composite_tiles": (lambda: SK.composite_tiles(ra1, *geo_s),
                            lambda: SK.composite_tiles_ref(ra1, *geo_s),
                            T1 * K1 * 16 * 4 + T1 * P * 4 * 4,
                            v1 * COMPOSITE_TEST_OPS + n_pass * COMPOSITE_ACCUM_OPS),
        "shade_tiles": (lambda: MK.shade_tiles(ra2, *geo_m, mc.sigma),
                        lambda: MK.shade_tiles_ref(ra2, *geo_m, mc.sigma),
                        T2 * K2 * 24 * 4 + T2 * P * 6 * 4, v2 * SHADE_OPS),
    }
    log(f"# view 0 rows: {v1 // P} valid composite rows of {T1 * K1}, {n_pass} passing "
        f"(pixel, row) pairs; {v2 // P} valid shade rows of {T2 * K2}")
    kernels = []
    del args, state

    # 4c. the YAML's own gaussian_ratio and init_density_threshold: one render
    #     of view 0, reported and not held to the caps ---------------------
    ycfg = load_cfg(bench_values=False)
    ystate = build_shell_state(torch, ycfg, N_GAUSS, dev)
    ctx_y = StepContext(ycfg, W, H, device=dev)
    out, aux = render_frame_with_aux(ctx_y, ystate, batches[0], ycfg.model.sh_degree)
    torch.cuda.synchronize()
    ovf = {k: int(v) for k, v in aux.items()}
    log(f"# YAML's own values (gaussian_ratio {ycfg.model.gaussian_ratio}, "
        f"init_density_threshold {ycfg.optimization.init_density_threshold}), view 0: "
        f"V {int(out['n_verts'])}/{ycfg.tpu.max_verts} "
        f"F {int(out['n_faces'])}/{ycfg.tpu.max_faces}")
    log(f"#   overflow splat {ovf['splat_overflow']} dup {ovf['splat_dup_overflow']} "
        f"mesh {ovf['mesh_overflow']} raster {ovf['raster_overflow']}; finite "
        f"{all(bool(torch.isfinite(out[k]).all()) for k in ('render', 'mesh_image'))}")
    del out, ystate

    # 5. train: the mesh-phase training step at full width, 1 warm-up and
    #    TRAIN_STEPS timed steps, each from the same frozen state; the launch
    #    counters zeroed just before and read just after -------------------
    tstate = build_shell_state(torch, cfg, N_GAUSS, dev)
    tbatch = bench_batch(W, H, dev)
    flags = train_flags(step, cfg.model.sh_degree)
    counters = (SK.composite_tiles, SK.composite_bwd, MK.shade_tiles, MK.shade_bwd)
    med, peak, launches = train_run(torch, step, ctx, tstate, tbatch, flags, counters,
                                    failures)
    for k, n in launches.items():
        if n < 1 + TRAIN_STEPS:
            failures.append(f"{k}: {n} launches in {1 + TRAIN_STEPS} training steps")
    summary = {"f32": (med, peak)}

    # 5b. where a step's time goes (forward / backward / optimizer, each
    #     between two synchronisations), and the backward kernels' real rows
    #     and cotangents, held against their twins and timed -------------
    targets = [(step, "loss_and_aux", "forward"), (step, "backward", "backward"),
               (step, "apply_updates", "optimizer"),
               (SK, "composite_bwd", "composite_bwd_kernel"),
               (MK, "shade_bwd", "shade_bwd_kernel")]
    stages, total, args = call_by_stage(
        torch, targets, lambda: step.train_step(ctx, tstate, tbatch, flags), 2,
        what="train_step")
    log("# train stages (ms, median of 2, host clock around synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items() if "kernel" not in k)
        + f"; whole step {total:.2f}, of it outside them "
        f"{total - stages['forward'] - stages['backward'] - stages['optimizer']:.2f}; "
        f"inside backward: composite_bwd {stages['composite_bwd_kernel']:.3f}, "
        f"shade_bwd {stages['shade_bwd_kernel']:.3f}")
    # the step's cotangents are ~1e-6, below the tolerance's absolute floor;
    # the backward is linear in them, so each is scaled to a largest |value|
    # of 1 (zeros stay zeros) before the kernels and the twins see them
    ca = args["composite_bwd_kernel"][0].detach()
    sa = args["shade_bwd_kernel"][0].detach()
    c_res = tuple(x.detach() for x in args["composite_bwd_kernel"][6:8])  # kernel 1's rgb, S
    s_res = args["shade_bwd_kernel"][7:9]       # kernel 3's residuals in the step
    cg, cga, sg, sgs = (x.detach() / x.detach().abs().max().clamp_min(1e-30)
                        for x in (*args["composite_bwd_kernel"][1:3],
                                  *args["shade_bwd_kernel"][1:3]))
    log("# train rows' cotangents, largest |value| before scaling to 1: "
        + ", ".join(f"{n} {float(x.detach().abs().max()):.3g}" for n, x in (
            ("composite g_rgb", args["composite_bwd_kernel"][1]),
            ("g_alpha", args["composite_bwd_kernel"][2]),
            ("shade g_rgb", args["shade_bwd_kernel"][1]),
            ("g_soft", args["shade_bwd_kernel"][2]))))
    if (args["composite_bwd_kernel"][3:6] != geo_s or len(c_res) != 2
            or args["shade_bwd_kernel"][3:7] != geo_m + (mc.sigma,) or len(s_res) != 2):
        failures.append("backward kernels called with another geometry or residuals than "
                        "the config's")
    check_composite(torch, SK, ca, geo_s, "train: composite_tiles", errs, failures)
    # the step's own rgb and S are kernel 1's on these rows, bit for bit
    same = all(bool(torch.equal(x, y)) for x, y in
               zip(c_res, SK.composite_tiles(ca, *geo_s, residuals=True)[0::2]))
    log(f"# kernels/train: composite_tiles again on the step's rows: "
        f"{'the step' if same else 'NOT the step'}'s rgb and S")
    if not same:
        failures.append("composite_tiles on the step's rows gives other rgb or S than the step")
    check_composite_bwd(torch, SK, ca, cg, cga, geo_s, "train: composite_bwd", errs, failures,
                        c_res)
    check_shade(torch, MK, sa, geo_m, mc.sigma, "train: shade_tiles", errs, failures)
    check_shade_bwd(torch, MK, sa, sg, sgs, geo_m + (mc.sigma,), "train: shade_bwd", errs,
                    failures, s_res)
    # kernel 4 twice on the same rows, as the step calls it: fixed-order
    # sums, the same bits
    first, again = (MK.shade_bwd(sa, sg, sgs, *geo_m, mc.sigma, *s_res) for _ in range(2))
    same = bool(torch.equal(first, again))
    log(f"# kernels/train: shade_bwd twice: {'identical' if same else 'DIFFERENT'} d_attrs")
    if not same:
        failures.append("shade_bwd not deterministic (training rows)")
    del first, again
    c_valid, c_pass, c_live = composite_pairs(torch, SK, ca, sc)
    s_valid, s_soft, s_rgb = shade_pairs(torch, SK, sa, sg, sgs, mc)
    rows_per_tile = (sa[..., 9] > 0.5).sum(1)
    log(f"# train rows: composite {c_valid} valid (pixel, row) pairs, {c_pass} passing, "
        f"{c_live} below the clamp; shade {s_valid} valid pairs, {s_soft} with a soft "
        f"gradient, {s_rgb} winner pixels with a colour gradient; shade rows "
        f"{int(rows_per_tile.sum())} valid of {sa.shape[0] * sa.shape[1]} in "
        f"{int((rows_per_tile > 0).sum())} of {sa.shape[0]} tiles, largest tile "
        f"{int(rows_per_tile.max())}, {int((rows_per_tile == sa.shape[1]).sum())} tiles at K")
    kernel_rows["composite_bwd"] = (
        lambda: SK.composite_bwd(ca, cg, cga, *geo_s, *c_res),
        lambda: SK.composite_bwd_ref(ca, cg, cga, *geo_s, rgb=c_res[0], S=c_res[1]),
        (2 * ca.numel() + cg.numel() + cga.numel() + sum(x.numel() for x in c_res)) * 4,
        c_valid * COMPOSITE_TEST_OPS + c_pass * COMPOSITE_BWD_PASS_OPS
        + c_live * COMPOSITE_BWD_LIVE_OPS + cga.numel() * COMPOSITE_BWD_PIXEL_OPS)
    kernel_rows["shade_bwd"] = (
        lambda: MK.shade_bwd(sa, sg, sgs, *geo_m, mc.sigma, *s_res),
        lambda: MK.shade_bwd_ref(sa, sg, sgs, *geo_m, mc.sigma),
        (2 * sa.numel() + sg.numel() + sgs.numel() + sum(x.numel() for x in s_res)) * 4,
        s_valid * SHADE_OPS + s_soft * SHADE_BWD_SOFT_OPS + s_rgb * SHADE_BWD_RGB_OPS)
    train_launches = launches
    summary["f32"] += (stages,)
    for name, (fk, fp, nbytes, nops) in kernel_rows.items():
        ms = time_cuda(torch, fk, KERNEL_TIMING_LAUNCHES)
        plain_ms = time_cuda(torch, fp, 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=train_launches[name], max_abs_err=max(errs[name]), ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None))
        log(f"# timing {name}: {ms:.4f} ms/launch, twin {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G ops); "
            f"no single PyTorch call computes it (library_ms null)")
    del ca, cg, cga, c_res, sa, sg, sgs, s_res, ra1, ra2, args, kernel_rows

    # 5f. the fused configuration (tpu.mlp_bf16 = tpu.mlp_fused = True) from
    #     the same state and view: every kernel counted, kernels 5 and 6
    #     TRUNKS times a step; the stages; kernels 5 and 6 held against their
    #     twins on every trunk call of a step, then timed on the largest one
    #     beside their bound and the cuBLAS chain of the "bf16" mode --------
    fcfg = load_cfg()
    fcfg.tpu.mlp_bf16 = fcfg.tpu.mlp_fused = True
    ctx_f = StepContext(fcfg, W, H, device=dev)
    trunk_counters = (MF.trunk_fwd, MF.trunk_bwd)
    med, peak, launches = train_run(torch, step, ctx_f, tstate, tbatch, flags,
                                    counters + trunk_counters, failures, " fused")
    for k, n in launches.items():
        if n < 1 + TRAIN_STEPS:
            failures.append(f"fused: {k}: {n} launches in {1 + TRAIN_STEPS} training steps")
    for c in trunk_counters:
        if launches[c.__name__] != TRUNKS * (1 + TRAIN_STEPS):
            failures.append(f"fused: {c.__name__}: {launches[c.__name__]} launches, not "
                            f"{TRUNKS} in each of {1 + TRAIN_STEPS} training steps")
    targets = [(step, "loss_and_aux", "forward"), (step, "backward", "backward"),
               (step, "apply_updates", "optimizer"),
               (MF, "trunk_fwd", "trunk_fwd_kernel"), (MF, "trunk_bwd", "trunk_bwd_kernel")]
    calls = {}
    stages, total, _ = call_by_stage(
        torch, targets, lambda: step.train_step(ctx_f, tstate, tbatch, flags), 2,
        what="train_step", per_call={"trunk_fwd_kernel": TRUNKS, "trunk_bwd_kernel": TRUNKS},
        keep=calls)
    log_stages(stages, total, " fused", ("trunk_fwd", "trunk_bwd"))
    summary["fused"] = (med, peak, stages)
    rows = []
    for x, wb, bp, g, *_ in calls["trunk_bwd_kernel"]:     # and the transposed pack
        x, g = x.detach(), g.detach()
        gmax = float(g.abs().max())
        # like kernels 2 and 4, each cotangent is scaled to a largest |value| of 1
        ok, rep, groups = compare_trunk(torch, MF, x, wb, bp, g / max(gmax, 1e-30))
        errs["trunk_fwd"].append(rep["out"][2])
        errs["trunk_bwd"].append(max(rep[k][2] for k in ("dx", "dW", "db")))
        log(f"# kernels/train: trunk_fwd/trunk_bwd {tuple(x.shape)}, |g| max {gmax:.3g} "
            f"scaled to 1: {trunk_report(rep, groups)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"trunk kernels vs twins (training rows, {x.shape[0]})")
        rows.append((x, wb, bp, g / max(gmax, 1e-30)))
    x, wb, bp, g = max(rows, key=lambda r: r[0].shape[0])
    n, din = x.shape
    wt = MF.transpose_pack(wb)    # made once a trunk call, as FusedTrunk does
    ws = MF.stage_pack(wt)
    same = torch.equal(MF.trunk_fwd(x, wb, bp, ws), MF.trunk_fwd(x, wb, bp, ws))
    log(f"# kernels/train: trunk_fwd {tuple(x.shape)} twice: "
        f"{'identical' if same else 'DIFFERENT'} out")
    if not same:
        failures.append(f"trunk_fwd not deterministic (training rows, {n})")
    chain = trunk_from_pack(torch, wb, bp, din)
    xg = x.clone().requires_grad_(True)
    out = chain(xg, "bf16")
    params = [xg] + list(chain.parameters())
    fwd_flops = 2 * n * (7 * 256 * 256 + 2 * din * 256)
    w_bytes = wb.numel() * 2 + bp.numel() * 4
    trunk_rows = {  # name: (kernel, twin, cuBLAS chain, bytes, operations)
        "trunk_fwd": (lambda: MF.trunk_fwd(x, wb, bp, ws), lambda: MF.trunk_fwd_ref(x, wb, bp),
                      lambda: chain(x, "bf16"), n * din * 4 + n * 256 * 4 + w_bytes, fwd_flops),
        "trunk_bwd": (lambda: MF.trunk_bwd(x, wb, bp, g, wt),
                      lambda: MF.trunk_bwd_ref(x, wb, bp, g),
                      lambda: torch.autograd.grad(out, params, g, retain_graph=True),
                      2 * n * din * 4 + n * 256 * 4 + w_bytes + 9 * 256 * 256 * 4 + 8 * 256 * 4,
                      3 * fwd_flops),
    }
    for name, (fk, fp, fl, nbytes, nops) in trunk_rows.items():
        with torch.no_grad() if name == "trunk_fwd" else contextlib.nullcontext():
            ms = time_cuda(torch, fk, KERNEL_TIMING_LAUNCHES)
            plain_ms = time_cuda(torch, fp, 2)
            library_ms = time_cuda(torch, fl, KERNEL_TIMING_LAUNCHES)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_BF16_TC * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name], max_abs_err=max(errs[name]), ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms))
        log(f"# timing {name} ({n},{din}): {ms:.4f} ms/launch, twin {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {nops / 1e12:.3f} TFLOP, "
            f"{nops / ms / 1e9:.1f} TFLOP/s); library: the bf16 mode's chain of nine cuBLAS "
            f"GEMMs + bias + ReLU{' (autograd backward)' if name == 'trunk_bwd' else ''} "
            f"{library_ms:.4f} ms")
    del rows, calls, x, g, wt, ws, xg, out, params, chain, trunk_rows

    # 5g. the bf16 configuration (tpu.mlp_bf16, not fused; bench.py's own
    #     precision): the same state, view and checks, reported -----------
    bcfg = load_cfg()
    bcfg.tpu.mlp_bf16 = True
    ctx_b = StepContext(bcfg, W, H, device=dev)
    med, peak, launches = train_run(torch, step, ctx_b, tstate, tbatch, flags, counters,
                                    failures, " bf16")
    targets = [(step, "loss_and_aux", "forward"), (step, "backward", "backward"),
               (step, "apply_updates", "optimizer")]
    stages, total, _ = call_by_stage(
        torch, targets, lambda: step.train_step(ctx_b, tstate, tbatch, flags), 2,
        what="train_step")
    log_stages(stages, total, " bf16", ())
    summary["bf16"] = (med, peak, stages)
    log("# steps side by side (ms/step median; forward / backward / optimizer ms; peak GiB): "
        + "; ".join(f"{k} {v[0]:.2f} ({v[2]['forward']:.1f} / {v[2]['backward']:.1f} / "
                    f"{v[2]['optimizer']:.1f}; {v[1]:.3f})" for k, v in summary.items()))

    # 5s. the structural ops at the same state: normal init, an anchor
    #     iteration (float32 and fused), densify/prune, the opacity reset
    t0 = time.perf_counter()
    structural_phase(torch, ctx, ctx_f, tstate, tbatch, flags, counters, trunk_counters,
                     failures)
    log(f"# structural phase: {time.perf_counter() - t0:.2f} s")
    del tstate

    # 6. the same path on the card and on the CPU at a small size ------------
    small = _small_cfg(Config)
    ctx_g = StepContext(small, 64, 64, device=dev)
    ctx_c = StepContext(small, 64, 64, device="cpu")
    st_c = build_shell_state(torch, small, 256, "cpu")
    from dgmesh_torch.train.state import state_to
    st_g = state_to(st_c, dev)
    for i, (bg_, bc_) in enumerate(zip(view_batches(64, 64, 2, dev),
                                       view_batches(64, 64, 2, "cpu"))):
        og, ag = render_frame_with_aux(ctx_g, st_g, bg_, small.model.sh_degree)
        oc, ac = render_frame_with_aux(ctx_c, st_c, bc_, small.model.sh_degree)
        d_img = max(float((og[k].cpu() - oc[k]).abs().max())
                    for k in ("render", "mesh_image", "mask"))
        same = (int(og["n_verts"]) == int(oc["n_verts"])
                and int(og["n_faces"]) == int(oc["n_faces"]))
        whole = int(ag["mesh_overflow"]) == 0 and int(ac["mesh_overflow"]) == 0
        ok = same and whole and d_img <= TOL_SMALL and int(oc["n_verts"]) > 0
        log(f"# small view {i}: card vs CPU max image diff {d_img:.3g} (tol {TOL_SMALL}); "
            f"V {int(og['n_verts'])}/{int(oc['n_verts'])} F {int(og['n_faces'])}/"
            f"{int(oc['n_faces'])} of {small.tpu.max_verts}/{small.tpu.max_faces}; "
            f"mesh overflow {int(ag['mesh_overflow'])}/{int(ac['mesh_overflow'])} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"small view {i}: card and CPU disagree")
        if i == 0:
            small_shape_check(torch, MR, ctx_g, ctx_c, oc, bg_, bc_, dev, failures)

    # the training step on the card and on the CPU at the small size, from
    # SMALL_SEEDS states; then the same in the fused configuration, from
    # SMALL_SEEDS_FUSED states
    small_train_check(torch, step, small, dev, failures, TOL_SMALL_GP, TOL_SMALL_HEAD,
                      TOL_SMALL_NET, "", SMALL_SEEDS)
    fsmall = _small_cfg(Config)
    fsmall.tpu.mlp_bf16 = fsmall.tpu.mlp_fused = True
    small_train_check(torch, step, fsmall, dev, failures, TOL_SMALL_GP_FUSED,
                      TOL_SMALL_HEAD_FUSED, TOL_SMALL_NET_FUSED, " fused", SMALL_SEEDS_FUSED)
    # the structural ops on the card and on the CPU with the same draws
    small_structural_check(torch, _small_cfg(Config), dev, failures)

    # 7. the driver: the port's trainer, data and CLIs at full width --------
    t0 = time.perf_counter()
    counters = (SK.composite_tiles, SK.composite_bwd, MK.shade_tiles, MK.shade_bwd,
                MF.trunk_fwd, MF.trunk_bwd)
    run_fused, data = driver_phase(torch, dev, failures, summary, counters)
    log(f"# phase 7 (driver): {time.perf_counter() - t0:.2f} s")
    # 7e. evaluation (module 4) on the fused run's final checkpoint ---------
    t0 = time.perf_counter()
    frames, pairs = eval_phase(torch, dev, failures, counters, run_fused, data)
    log(f"# phase 7e (eval): {time.perf_counter() - t0:.2f} s")
    # 7f. evaluation from the checkpoint: cli.evaluate, held to 7e ---------
    t0 = time.perf_counter()
    evaluate_phase(torch, dev, failures, counters, run_fused, data, frames, pairs)
    log(f"# phase 7f (cli.evaluate): {time.perf_counter() - t0:.2f} s")
    # 7b. the converging regime of tests/test_mesh_phase_learns.py ---------
    t0 = time.perf_counter()
    converging_phase(torch, dev, failures)
    log(f"# phase 7b (converging regime): {time.perf_counter() - t0:.2f} s")
    # 8. real capture: the real-data configs' widths through the CLIs ------
    t0 = time.perf_counter()
    capture_phase(torch, dev, failures, counters, kernels)
    log(f"# phase 8 (real capture): {time.perf_counter() - t0:.2f} s")
    # 9. the multi-device step (module 6) ---------------------------------
    t0 = time.perf_counter()
    multi_device_phase(torch, dev, failures)
    log(f"# phase 9 (multi-device): {time.perf_counter() - t0:.2f} s")
    # 10. the 6-DoF head (module 5) --------------------------------------
    t0 = time.perf_counter()
    six_dof_phase(torch, dev, failures, counters)
    log(f"# phase 10 (6-DoF): {time.perf_counter() - t0:.2f} s")

    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def small_shape_check(torch, MR, ctx_g, ctx_c, oc, bg_, bc_, dev, failures):
    """render_mesh_shape of the CPU render's mesh on the card and on the
    CPU, from the same camera: face_id and mask equal, rgb, normal and
    position within TOL_SHAPE_RENDER."""
    fv = torch.arange(oc["faces"].shape[0]) < oc["n_faces"]
    centre = bc_.cam.campos.numpy()
    want = MR.render_mesh_shape(oc["verts"], oc["faces"], fv, bc_.mesh_pose, bc_.mesh_proj,
                                centre, ctx_c.mr_cfg)
    got = MR.render_mesh_shape(oc["verts"].to(dev), oc["faces"].to(dev), fv.to(dev),
                               bg_.mesh_pose, bg_.mesh_proj, centre, ctx_g.mr_cfg)
    exact = all(bool(torch.equal(got[k].cpu(), want[k])) for k in ("face_id", "mask"))
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("rgb", "normal", "position")}
    ok = exact and max(errs.values()) <= TOL_SHAPE_RENDER and bool(want["mask"].any())
    log(f"# small view 0 shape render: card vs CPU face_id and mask "
        f"{'equal' if exact else 'DIFFERENT'}; max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {TOL_SHAPE_RENDER}); coverage {float(want['mask'].mean()):.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("small view 0: render_mesh_shape card and CPU disagree")


def small_train_check(torch, step, small, dev, failures, tol_gp, tol_head, tol_net, label,
                      seeds, prepare=None):
    """The training step on the card and on the CPU (the plain twins) at the
    small size, from each of ``seeds`` states (each given to ``prepare``
    first, where given), held to the loss, Gaussian-gradient,
    appearance-head and net-leaf tolerances."""
    from dgmesh_torch.train.state import state_to
    from dgmesh_torch.train.step import StepContext

    ctx_g = StepContext(small, 64, 64, device=dev)
    ctx_c = StepContext(small, 64, 64, device="cpu")
    sflags = train_flags(step, small.model.sh_degree)
    loss_keys = ("loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss",
                 "img_loss")

    def leaf_err(a, b):
        return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def leaf_norm_err(a, b):
        return float((a.cpu() - b).norm()) / max(float(b.norm()), 1e-30)

    worst = dict(loss=0.0, gp=0.0, head=0.0, net=0.0)
    for seed in range(seeds):
        st_c = build_shell_state(torch, small, 256, "cpu", seed=seed)
        if prepare is not None:
            prepare(st_c)
        st_g = state_to(st_c, dev)
        res = {}
        for where, c, st, b in (("card", ctx_g, st_g, bench_batch(64, 64, dev)),
                                ("cpu", ctx_c, st_c, bench_batch(64, 64, "cpu"))):
            _, m = step.train_step(c, st, b, sflags)
            res[where] = (m, step.loss_and_grads(c, st, b, sflags)[2])
        (m_g, gr_g), (m_c, gr_c) = res["card"], res["cpu"]
        d_loss = max(abs(float(m_g[k]) - float(m_c[k])) / max(abs(float(m_c[k])), 1e-20)
                     for k in loss_keys)
        d_gp = max(leaf_err(a, b) for a, b in zip(gr_g.gp, gr_c.gp))
        # the appearance net's output head takes kernel 4's colour gradient
        # through the vertex scatter and no ReLU: a unit that takes the other
        # side of its kink on the card reaches every other leaf (the deform
        # nets' through the appearance net's input gradient), not this one
        leaves = {nm: [(k.startswith("head_"), a, b) for (k, _), a, b in zip(
            net.named_parameters(), na, nb)]
            for nm, net, na, nb in zip(type(st_c.nets)._fields, st_c.nets, gr_g.nets, gr_c.nets)}
        head_by_net = {nm: max((leaf_err(a, b) for h, a, b in ls if h), default=0.0)
                       for nm, ls in leaves.items()}
        net_by_net = {nm: max(leaf_norm_err(a, b) for h, a, b in ls
                              if not (h and nm == "appearance"))
                      for nm, ls in leaves.items()}
        d_head, d_net = head_by_net["appearance"], max(net_by_net.values())
        for k, v in (("loss", d_loss), ("gp", d_gp), ("head", d_head), ("net", d_net)):
            worst[k] = max(worst[k], v)
        log(f"#   seed {seed}, per net: heads max rel "
            + ", ".join(f"{nm} {v:.3g}" for nm, v in head_by_net.items())
            + "; other leaves norm rel "
            + ", ".join(f"{nm} {v:.3g}" for nm, v in net_by_net.items()))
        same = all(int(m_g[k]) == int(m_c[k]) for k in ("mesh_n_verts", "mesh_n_faces",
                                                         "mesh_overflow",
                                                         "nonfinite_grad_leaves"))
        ok = (same and d_loss <= TOL_SMALL_LOSS and d_gp <= tol_gp
              and d_head <= tol_head and d_net <= tol_net
              and not step_problems(torch, m_g) and not step_problems(torch, m_c))
        log(f"# small{label} train step, seed {seed}: card vs CPU loss terms rel {d_loss:.3g}; "
            f"Gaussian grads rel {d_gp:.3g}; appearance head grads rel {d_head:.3g}; other "
            f"net grads norm rel {d_net:.3g}; V {int(m_g['mesh_n_verts'])}/"
            f"{int(m_c['mesh_n_verts'])} F {int(m_g['mesh_n_faces'])}/"
            f"{int(m_c['mesh_n_faces'])} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"small{label} train step, seed {seed}: card and CPU disagree")
    log(f"# small{label} train step, worst of {seeds} seeds: loss terms "
        f"{worst['loss']:.3g} (tol {TOL_SMALL_LOSS}), Gaussian grads {worst['gp']:.3g} "
        f"(tol {tol_gp}), appearance head {worst['head']:.3g} (tol {tol_head}), "
        f"other net leaves {worst['net']:.3g} (tol {tol_net})")


def touched_slots(pre_gp, pre_alive, post_gp, post_alive):
    """Slots whose alive bit or any per-Gaussian leaf a structural op changed."""
    from dgmesh_torch.train.densify import PER_GAUSS
    t = pre_alive != post_alive
    for n in PER_GAUSS:
        a, b = getattr(pre_gp, n), getattr(post_gp, n)
        t = t | (a != b).reshape(a.shape[0], -1).any(1)
    return t


def moments_zero_at(mu, nu, mask):
    from dgmesh_torch.train.densify import PER_GAUSS
    return all(not bool(getattr(m, n)[mask].any()) for m in (mu, nu) for n in PER_GAUSS)


def all_finite(torch, tensors):
    return all(bool(torch.isfinite(x).all()) for x in tensors)


def structural_phase(torch, ctx, ctx_f, tstate, tbatch, flags, counters, trunk_counters,
                     failures):
    """5s (module docstring): the structural ops at phase 5's state and view,
    with the moments and statistics of one float32 training step from it;
    ``ctx``/``ctx_f`` the float32 and fused step contexts."""
    from dgmesh_torch.models import gaussians as G
    from dgmesh_torch.train import densify as D
    from dgmesh_torch.train import loop as TLoop
    from dgmesh_torch.train import step

    cfg = ctx.cfg
    dev = tstate.gp.xyz.device
    gen = torch.Generator(device=dev).manual_seed(0)
    # phase 5's state with the Adam moments and densify statistics one step
    # leaves; its own Gaussians and nets (one Adam step from these random
    # nets moves every head weight by its learning rate: offsets ~0.1, which
    # would shrink every scale below 0)
    st1, _ = step.train_step(ctx, tstate, tbatch, flags)
    st = tstate._replace(gs=st1.gs, g_mu=st1.g_mu, g_nu=st1.g_nu)
    del st1
    alive = st.gs.alive

    # the one-shot normal init, each part timed: at the config's grid twice
    # (the first call pays for first uses), then at the reference's
    occ_res = min(cfg.model.grid_res, cfg.tpu.occ_res)
    for call, res in enumerate((occ_res, occ_res, REFERENCE_OCC_RES)):
        out = {}
        targets = [(D, "gaussian_occupancy_grid", "occupancy"), (D, "marching_tets",
                                                                   "marching_tets"),
                   (D, "sample_mesh_surface", "sampling"), (D, "knn", "knn")]
        torch.cuda.reset_peak_memory_stats()
        stages, total, _ = call_by_stage(
            torch, targets, lambda: out.update(r=D.normal_initialization(
                cfg, st.gp, st.gs, st.nets, tbatch.fid, occ_res=res, gen=gen)),
            1, what="normal_initialization")
        gp_n, m = out["r"]
        nrm = gp_n.normal[alive]
        ok = (all_finite(torch, [nrm, m.verts]) and int(m.overflow) == 0 and int(m.n_faces) > 0
              and bool(((torch.linalg.norm(nrm, dim=-1) - 1).abs() < 1e-3).all())
              and not bool(gp_n.normal[~alive].any()))
        what = (" (first call)" if call == 0 else
                " (reference grid, measured only)" if res != occ_res else "")
        log(f"# structural/normal init at {res}^3{what}: "
            f"{total:.2f} ms (" + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f"); mesh V {int(m.n_verts)} F {int(m.n_faces)} mesh_overflow {int(m.overflow)}; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"{'ok' if ok else ('FAIL' if res == occ_res else 'over the mesh caps or not finite')}")
        if res == occ_res and not ok:
            failures.append(f"normal init at {res}^3: non-finite, not unit, or mesh overflow")
        del out, gp_n, m, nrm

    # one anchor iteration through run_iteration, float32 then fused nets
    o = cfg.optimization
    it = (o.anchor_iter // o.anchor_interval + 1) * o.anchor_interval
    fl = TLoop.flags_for(cfg, it)
    pre = st._replace(step=torch.tensor(it, dtype=torch.int32, device=dev))
    for label, c, cs in (("float32", ctx, counters), ("fused", ctx_f, counters + trunk_counters)):
        for rep in range(2):                       # the first warms the path up
            res = {}
            torch.cuda.reset_peak_memory_stats()
            for k in cs:
                k.launches = 0
            stages, total, _ = call_by_stage(
                torch, [(TLoop, "anchor_step", "anchor_step"), (TLoop, "train_step", "step")],
                lambda: res.update(r=TLoop.run_iteration(c, pre, tbatch, it, STRUCT_EXTENT,
                                                         gen=gen)),
                1, what="run_iteration")
            launches = {k.__name__: k.launches for k in cs}
        post, m = res["r"]
        touched = touched_slots(pre.gp, pre.gs.alive, post.gp, post.gs.alive)
        nets_moved = any(not torch.equal(a, b) for a, b in zip(pre.nets.deform.parameters(),
                                                              post.nets.deform.parameters()))
        bad = step_problems(torch, m)
        if not (fl.anchor and "anchor_loss" in m and bool(torch.isfinite(m["anchor_loss"]))):
            bad.append("no finite anchor loss")
        if not all_finite(torch, [getattr(post.gp, n)[post.gs.alive] for n in D.PER_GAUSS]):
            bad.append("non-finite Gaussians")
        if not moments_zero_at(post.g_mu, post.g_nu, touched):
            bad.append("moments left on touched slots")
        if int(post.g_count) != int(pre.g_count) or not nets_moved:
            bad.append("g_count advanced or the nets did not move")
        if min(launches.values()) < 1:
            bad.append(f"a kernel of the step not launched {launches}")
        stats = {k[len("anchor_"):]: int(v) for k, v in m.items() if k.startswith("anchor_")
                 and k != "anchor_loss"}
        log(f"# structural/anchor iteration {it} ({label} nets): {total:.2f} ms, anchor_step "
            f"{stages['anchor_step']:.2f}, step {stages['step']:.2f}; {stats}; anchor_loss "
            f"{float(m['anchor_loss']):.6g}; {int(touched.sum())} slots touched; launches "
            f"{launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"{'ok' if not bad else 'FAIL: ' + ', '.join(bad)}")
        if bad:
            failures.append(f"anchor iteration ({label}): " + ", ".join(bad))
        del res, post, m, touched

    # densify / prune, both ways, on the state as the step left it; then
    # with every other live Gaussian 4x larger (past percent_dense ·
    # extent: split), every tenth at opacity 0.003 (pruned) and the
    # gradient threshold at the median of the step's non-zero statistics,
    # so that clone, split and prune all run at full width
    grads = torch.where(st.gs.denom > 0, st.gs.xyz_grad_accum / st.gs.denom.clamp_min(1), 0.0)
    dcfg = type(cfg).from_dict(cfg.to_dict())
    dcfg.optimization.densify_grad_threshold = float(grads[alive & (grads > 0)].median())
    slot = torch.arange(alive.shape[0], device=dev)
    varied = st.gp._replace(
        scaling=torch.where((slot % 2 == 0)[:, None], st.gp.scaling + math.log(4.0),
                            st.gp.scaling),
        opacity=torch.where((slot % 10 == 5)[:, None], math.log(0.003 / 0.997), st.gp.opacity))
    for label, c, gp0, use_size in (("as left", cfg, st.gp, False), ("as left", cfg, st.gp, True),
                                    ("varied", dcfg, varied, True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gp_d, gs_d, mu_d, nu_d, n = D.densify_and_prune(c, gp0, st.gs, st.g_mu, st.g_nu,
                                                        STRUCT_EXTENT, use_size, gen=gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        touched = touched_slots(gp0, st.gs.alive, gp_d, gs_d.alive)
        n = {k: int(v) for k, v in n.items()}
        ok = (all_finite(torch, [getattr(gp_d, k)[gs_d.alive] for k in D.PER_GAUSS])
              and moments_zero_at(mu_d, nu_d, touched)
              and int(gs_d.alive.sum()) == int(alive.sum()) + n["clone"] + n["split"] - n["prune"]
              and not bool(gs_d.denom.any())
              and (label == "as left" or min(n.values()) > 0))
        log(f"# structural/densify_and_prune ({label}, use_size {use_size}, threshold "
            f"{c.optimization.densify_grad_threshold:.3g}): {ms:.2f} ms; clone {n['clone']} "
            f"split {n['split']} prune {n['prune']} of {int(alive.sum())} live; "
            f"{int(touched.sum())} slots touched; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"densify_and_prune ({label}, use_size {use_size})")
        del gp_d, gs_d, mu_d, nu_d, touched
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp_r, mu_r, nu_r = D.reset_opacity(st.gp, st.g_mu, st.g_nu)
    torch.cuda.synchronize()
    ok = (float(G.get_opacity(gp_r).max()) <= 0.01 + 1e-6 and not bool(mu_r.opacity.any())
          and not bool(nu_r.opacity.any()) and torch.equal(gp_r.xyz, st.gp.xyz))
    log(f"# structural/reset_opacity: {(time.perf_counter() - t0) * 1e3:.2f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("reset_opacity")


def small_structural_state(torch, small):
    """The small card-vs-CPU check's state (CPU): chip_smoke's 256-point
    shell with 40 copies of 20 of its Gaussians moved by N(0, 1e-3) (faces
    with several Gaussians to merge), log-scales 0.1-0.3 (an iso-surface on
    the 32³ occupancy grid; every fourth slot 0.005, small enough to clone)
    and random rotations, opacities
    0.002-0.9 (some below the prune threshold), seeded densify statistics
    and Adam moments."""
    st = build_shell_state(torch, small, 256, "cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    M = st.gp.xyz.shape[0]
    src = torch.arange(40) % 20
    dst = 256 + torch.arange(40)
    leaves = {n: getattr(st.gp, n).clone() for n in ("xyz", "f_dc", "f_rest", "normal")}
    for n in leaves:
        leaves[n][dst] = leaves[n][src]
    leaves["xyz"][dst] += torch.randn((40, 3), generator=g) * 1e-3
    alive = st.gs.alive.clone()
    alive[dst] = True
    u = lambda *shape: torch.rand(shape, generator=g)  # noqa: E731
    scaling = torch.where(torch.arange(M)[:, None] % 4 == 0, 0.005, 0.1 + 0.2 * u(M, 3))
    gp = st.gp._replace(**leaves, scaling=torch.log(scaling),
                        rotation=torch.randn((M, 4), generator=g),
                        opacity=torch.logit(0.002 + 0.898 * u(M, 1)))
    gs = st.gs._replace(alive=alive, xyz_grad_accum=torch.where(alive, 6e-4 * u(M), 0.0),
                        denom=torch.where(alive, 1.0 + torch.floor(3 * u(M)), 0.0),
                        max_radii2d=30 * u(M))
    mu = type(gp)(*[torch.randn(x.shape, generator=g) for x in gp])
    nu = type(gp)(*[u(*x.shape) for x in gp])
    return st._replace(gp=gp, gs=gs, g_mu=mu, g_nu=nu)


def small_structural_check(torch, small, dev, failures):
    """Normal init, anchor_step and densify/prune on the card and on the CPU
    at the small size, with the same CPU-made draws: discrete outputs (mesh
    sizes and faces, alive, the 1-1 mask, counters) equal, float outputs
    within TOL_STRUCT_*."""
    from dgmesh_torch.train import densify as D
    from dgmesh_torch.train.state import state_to
    from dgmesh_torch.train.step import StepContext, _deform_all, extract_mesh

    small.optimization.anchor_n_1_bs, small.optimization.anchor_0_1_bs = 16, 64
    st_c = small_structural_state(torch, small)
    st_g = state_to(st_c, dev)
    M, F = small.tpu.max_gaussians, small.tpu.max_faces
    g = torch.Generator().manual_seed(2)
    draws = dict(u=torch.rand(M, generator=g), uv=torch.rand((M, 2), generator=g),
                 anchor={"n_1": torch.rand(F, generator=g), "0_1": torch.rand(F, generator=g),
                         "angle": torch.randn((64, 1), generator=g)},
                 split=[torch.randn((M, 3), generator=g) for _ in range(2)])
    fid = torch.tensor(0.5)
    worst, problems = 0.0, []

    def cmp(what, a, b, atol=TOL_STRUCT_ABS):
        nonlocal worst
        a, b = a.detach().cpu().double(), b.detach().double()
        gap = float(((a - b).abs() - TOL_STRUCT_REL * b.abs()).max()) if a.numel() else 0.0
        worst = max(worst, gap / atol)
        if not (torch.isfinite(a).all() and gap <= atol):
            problems.append(what)

    def same(what, a, b):
        if not torch.equal(a.cpu(), b):
            problems.append(what)

    res = {}
    for where, st in (("card", st_g), ("cpu", st_c)):
        res[where] = D.normal_initialization(
            small, st.gp, st.gs, st.nets, fid.to(st.gp.xyz.device),
            occ_res=min(small.model.grid_res, small.tpu.occ_res),
            u=draws["u"], uv=draws["uv"])
    (gp_g, m_g), (gp_c, m_c) = res["card"], res["cpu"]
    for k in ("n_verts", "n_faces", "overflow"):
        same(f"normal init {k}", getattr(m_g, k), getattr(m_c, k))
    same("normal init faces", m_g.faces, m_c.faces)
    cmp("normal init verts", m_g.verts, m_c.verts)
    cmp("normal init normals", gp_g.normal, gp_c.normal, TOL_STRUCT_NORMAL)
    n_faces = int(m_c.n_faces)

    # both sides anchor to the CPU's mesh (float32 nets, frozen positions)
    ctx_c = StepContext(small, 64, 64, device="cpu")
    with torch.no_grad():
        d_xyz, _, _, d_n = _deform_all(st_c.nets, st_c.gp.xyz, fid, True, mode="f32")
        mesh = extract_mesh(ctx_c, st_c.gp, st_c.gs, d_xyz, d_n, freeze_pos=True)
    for where, st in (("card", st_g), ("cpu", st_c)):
        d = st.gp.xyz.device
        res[where] = D.anchor_step(small, st.gp, st.gs, st.g_mu, st.g_nu, st.nets, fid.to(d),
                                   mesh.verts.to(d), mesh.faces.to(d), mesh.face_valid.to(d),
                                   draws=draws["anchor"])
    (gp_g, gs_g, mu_g, nu_g, in_g), (gp_c, gs_c, mu_c, nu_c, in_c) = res["card"], res["cpu"]
    same("anchor alive", gs_g.alive, gs_c.alive)
    same("anchor 1-1 mask", in_g.gauss_1_1_mask, in_c.gauss_1_1_mask)
    for k in in_c.stats:
        same(f"anchor {k}", in_g.stats[k], in_c.stats[k])
    cmp("anchor centroids", in_g.centroid_of_gaussian, in_c.centroid_of_gaussian)
    cmp("anchor loss_n_1", in_g.loss_n_1, in_c.loss_n_1)
    for n in D.PER_GAUSS:
        for what, a, b in (("", gp_g, gp_c), (" mu", mu_g, mu_c), (" nu", nu_g, nu_c)):
            cmp(f"anchor {n}{what}", getattr(a, n), getattr(b, n))
    # how far the CPU's rows are from a boundary: |d² − radius| and the gap
    # between a Gaussian's two nearest centroids
    from dgmesh_torch.ops.knn import knn
    from dgmesh_torch.ops.laplacian import face_centroids
    d2, _ = knn(st_c.gp.xyz + d_xyz, face_centroids(mesh.verts, mesh.faces, mesh.face_valid),
                2, ref_valid=mesh.face_valid)
    live = st_c.gs.alive
    radius = float(st_c.gs.gaussian_scale) * small.optimization.anchor_search_radius
    margin = (float((d2[live, 0] - radius).abs().min()), float((d2[live, 1] - d2[live, 0]).min()))
    anchor_stats = {k: int(v) for k, v in in_c.stats.items()}

    for use_size in (False, True):
        for where, st in (("card", st_g), ("cpu", st_c)):
            res[where] = D.densify_and_prune(small, st.gp, st.gs, st.g_mu, st.g_nu,
                                             STRUCT_EXTENT / 2, use_size,
                                             split_normals=draws["split"])
        (gp_g, gs_g, mu_g, nu_g, n_g), (gp_c, gs_c, mu_c, nu_c, n_c) = res["card"], res["cpu"]
        same(f"densify alive ({use_size})", gs_g.alive, gs_c.alive)
        for k in n_c:
            same(f"densify {k} ({use_size})", n_g[k], n_c[k])
        for n in D.PER_GAUSS:
            for what, a, b in (("", gp_g, gp_c), (" mu", mu_g, mu_c), (" nu", nu_g, nu_c)):
                cmp(f"densify {n}{what} ({use_size})", getattr(a, n), getattr(b, n))
        if use_size:
            counts = {k: int(v) for k, v in n_c.items()}
    ok = not problems and n_faces > 0 and anchor_stats["n_merged"] > 0 and min(counts.values()) > 0
    log(f"# small structural ops, card vs CPU: normal init F {n_faces}; anchor {anchor_stats} "
        f"(CPU rows' |d2 - radius| >= {margin[0]:.3g}, nearest-centroid gap >= {margin[1]:.3g}); "
        f"densify (use_size) {counts}; worst float gap {worst:.3g} of its tolerance "
        f"{'ok' if ok else 'FAIL: ' + ', '.join(problems)}")
    if not ok:
        failures.append("small structural ops: card and CPU disagree")


def train_run(torch, step, ctx, state, batch, flags, counters, failures, label=""):
    """1 warm-up and TRAIN_STEPS timed training steps, each from the same
    frozen state and checked, with the launch counters zeroed just before
    and read just after.  Logs and returns (median ms/step, peak GiB,
    {counter: launches})."""
    W, H = ctx.splat_cfg.width, ctx.splat_cfg.height
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    step_ms = []
    for i in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step.train_step(ctx, state, batch, flags)
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        bad = step_problems(torch, m)
        if bad:
            failures.append(f"{label.strip()}{' ' if label else ''}train step {i}: "
                            + ", ".join(bad))
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_ms)
    log(f"# train{label}: {1 + TRAIN_STEPS} steps at {W}x{H}, grid {ctx.cfg.model.grid_res}, "
        f"{int(state.gs.alive.sum())} live Gaussians, nets {ctx.mlp_mode}; "
        f"V {int(m['mesh_n_verts'])} "
        f"F {int(m['mesh_n_faces'])}; overflow mesh {int(m['mesh_overflow'])} splat "
        f"{int(m['splat_overflow'])} dup {int(m['splat_dup_overflow'])} raster "
        f"{int(m['raster_overflow'])}; nonfinite_grad_leaves {int(m['nonfinite_grad_leaves'])}")
    log("#   losses: " + ", ".join(f"{k} {float(m[k]):.6g}" for k in (
        "loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss", "img_loss",
        "img_psnr", "mesh_psnr")))
    log(f"#   ms/step median of {TRAIN_STEPS}: {med:.2f} ({', '.join(f'{x:.2f}' for x in step_ms)}); "
        f"{1e3 / med:.3f} steps/s; peak memory {peak:.3f} GiB; launches {launches}")
    return med, peak, launches


def log_stages(stages, total, label, kernels):
    """One line: a step's forward / backward / optimizer ms and the named
    kernels' ms per step (host clock around synchronize)."""
    log(f"# train{label} stages (ms, median of 2, host clock around synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items() if "kernel" not in k)
        + f"; whole step {total:.2f}, of it outside them "
        f"{total - stages['forward'] - stages['backward'] - stages['optimizer']:.2f}"
        + "".join(f"; {k} per step {stages[k + '_kernel']:.3f}" for k in kernels))


def trunk_from_pack(torch, wb, bp, din):
    """An MLPTrunk holding the packed trunk's weights (bf16 values, float32
    parameters): the library yardstick of kernels 5 and 6 runs its "bf16"
    mode on them."""
    from dgmesh_torch.models.mlp import MLPTrunk
    from dgmesh_torch.ops.mlp_fused import DEPTH, SKIP
    trunk = MLPTrunk(din, device=wb.device)
    w = wb.float()
    with torch.no_grad():
        for i, layer in enumerate(trunk.layers):
            k = w[i][:din] if i == 0 else w[i]
            if i == SKIP + 1:
                k = torch.cat([w[DEPTH][:din], w[i]], 0)
            layer.weight.copy_(k.t())
            layer.bias.copy_(bp[i])
    return trunk


def profile_train(torch, cfg, dev) -> int:
    """``--profile``: for the float32 and then the fused configuration, one
    warm-up and one profiled full-width training step (torch.profiler, CPU
    and CUDA activities).  Prints the operators with the most device time,
    then those with the most host time.  No result line."""
    from dgmesh_torch.train import step
    from dgmesh_torch.train.step import StepContext

    st = build_shell_state(torch, cfg, N_GAUSS, dev)
    b = bench_batch(IMG, IMG, dev)
    flags = train_flags(step, cfg.model.sh_degree)
    fcfg = load_cfg()
    fcfg.tpu.mlp_bf16 = fcfg.tpu.mlp_fused = True
    for c in (cfg, fcfg):
        ctx = StepContext(c, IMG, IMG, device=dev)
        step.train_step(ctx, st, b, flags)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step.train_step(ctx, st, b, flags)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        log(f"# --profile: nets {ctx.mlp_mode}")
        log(ka.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=60))
        log(ka.table(sort_by="self_cpu_time_total", row_limit=20, max_name_column_width=60))
    log("# --profile: stopping after the profiles; no result line")
    return 0


def driver_yaml(path: str, src: str = CONFIG, **extra) -> str:
    """A copy of the YAML ``src`` with DRIVER_SCHEDULE's keys (and
    ``extra``) in place of the YAML's: the YAML overrides the command line,
    so the schedule goes into the copy."""
    import yaml
    with open(src) as f:
        flat = yaml.safe_load(f)
    flat.update(DRIVER_SCHEDULE, **extra)
    with open(path, "w") as f:
        yaml.safe_dump(flat, f)
    return path


def driver_run(torch, dev, failures, data, label, counters, extra, src=CONFIG,
               root=DRIVER_DIR, save=(DRIVER_SAVE, DRIVER_SAVE + 1), what=None):
    """cli.train.main on the dataset with DRIVER_SCHEDULE in a copy of the
    YAML ``src`` (stdout to a log file beside the run, under ``root``),
    checkpoints at ``save`` and the end, the counters zeroed just before and
    read just after; the run's gates (with fused nets in ``extra``, kernels
    5 and 6 launched too).  Returns (model path, its log rows, launches)."""
    from dgmesh_torch.cli import train as cli_train
    from dgmesh_torch.train.loop import TrainingHalted
    out = os.path.join(root, f"run_{label}")
    if os.path.isdir(out):
        import shutil
        shutil.rmtree(out)
    os.makedirs(out)
    # the YAML's own source_path and model_path (a real-data YAML has both)
    # would override the command line's
    yml = driver_yaml(os.path.join(root, f"{label}.yaml"), src, **extra, source_path=data,
                      model_path=out)
    argv = ["--config", yml, "-s", data, "-m", out, "--save_iterations"] + [
        str(i) for i in save or (DRIVER_SCHEDULE["iterations"],)]
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = None
    with open(os.path.join(root, f"{label}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        try:
            _, results = cli_train.main(argv, device=DEVICE)
        except TrainingHalted as e:
            failures.append(f"driver {label}: tripwire: {str(e).splitlines()[0]}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    rows = []
    log_path = os.path.join(out, "train_log.jsonl")
    if os.path.exists(log_path):
        with open(log_path) as f:
            rows = [json.loads(line) for line in f]
    n_it = DRIVER_SCHEDULE["iterations"]
    bad = [f"iter {r['iter']}: {k} {r.get(k)}" for r in rows
           for k in ("loss", "mesh_overflow", "nonfinite_grad_leaves")
           if (k == "loss" and not math.isfinite(r[k])) or (k != "loss" and r.get(k, 0) != 0)]
    files = (["cfg_args.json", "train_log.jsonl", "test_results/test_result.txt",
              f"point_cloud/iteration_{n_it}/point_cloud.ply"]
             + [f"checkpoint/state_{i}.pt" for i in (*save, n_it)]
             + [f"{n}/iteration_{n_it}/{n}.pt" for n in ("deform", "deform_normal",
                                                         "deform_back", "deform_back_normal",
                                                         "appearance")])
    missing = [p for p in files if not os.path.exists(os.path.join(out, p))]
    want = [c.__name__ for c in counters
            if extra.get("mlp_fused") or c.__name__ not in ("trunk_fwd", "trunk_bwd")]
    unlaunched = [k for k in want if launches[k] == 0]
    res_ok = results is not None and all(math.isfinite(v) for v in results.values())
    mesh_rows = [r for r in rows if "mesh_n_verts" in r]
    ok = (len(rows) == n_it and not bad and not missing and not unlaunched and res_ok
          and mesh_rows and min(r["mesh_n_verts"] for r in mesh_rows) > 0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    what = what or f"{IMG}², {DRIVER_FRAMES} training views"
    log(f"# driver {label}: cli.train {n_it} iterations at {what}, {wall:.2f} s, peak memory "
        f"{peak:.3f} GiB; launches "
        f"{launches}; logged rows {len(rows)}; problems {bad[:6]}; missing files {missing}; "
        f"test pass {results} {'ok' if ok else 'FAIL'}")
    by_it = {int(r["iter"]): r for r in rows}
    if len(by_it) == n_it:
        d = DRIVER_ITERS["densify"]
        log(f"#   live Gaussians {int(by_it[1]['n_alive'])} → {int(by_it[n_it]['n_alive'])} "
            f"(densify at {d}: {int(by_it[d - 1]['n_alive'])} → {int(by_it[d]['n_alive'])}); "
            f"V at the first mesh iteration {int(mesh_rows[0]['mesh_n_verts'])}, at the last "
            f"{int(mesh_rows[-1]['mesh_n_verts'])}; at the last: "
            + ", ".join(f"{k} {by_it[n_it][k]:.6g}" for k in (
                "loss", "img_psnr", "mesh_psnr", "mask_loss", "density_thres")
                if k in by_it[n_it])
            + "; anchor " + ", ".join(f"{k[7:]} {int(v)}" for k, v in by_it[
                DRIVER_ITERS["anchor"]].items() if k.startswith("anchor_")))
    if not ok:
        failures.append(f"driver {label}: cli.train run")
    return out, rows, launches


def iteration_times(rows):
    """ms per iteration from the log rows (log_every 1: each row's
    iters_per_sec is over its own iteration, logging and the metrics'
    device sync included): {what: ms}."""
    ms = {int(r["iter"]): 1e3 / r["iters_per_sec"] for r in rows if r["iters_per_sec"] > 0}
    special = set(DRIVER_ITERS.values()) | {1}
    mesh = [ms[i] for i in sorted(ms) if i > DRIVER_ITERS["normal init"] and i not in special
            and i >= DRIVER_SCHEDULE["dpsr_iter"] + DRIVER_SCHEDULE["normal_net_warmup"]]
    pre = [ms[i] for i in sorted(ms) if 1 < i < DRIVER_SCHEDULE["dpsr_iter"] and i not in special]
    out = {f"{k} (iteration {i})": ms.get(i, float("nan")) for k, i in DRIVER_ITERS.items()}
    out["first iteration"] = ms.get(1, float("nan"))
    if pre:
        out[f"median before the mesh phase ({len(pre)})"] = statistics.median(pre)
    if mesh:
        out[f"median mesh iteration with normals ({len(mesh)})"] = statistics.median(mesh)
    return out


def resume_gaps(torch, cfg, got, want, before):
    """A resumed iteration's state ``got`` against the uninterrupted run's
    ``want``, both from ``before``: the gradients from the Adam first moments
    ((μ - 0.9·μ_before)/0.1), per Gaussian group and per net leaf as
    ‖Δ‖/‖g‖ (and, reported only, the Gaussian groups' max |Δ|/max |g|);
    and max |Δp|/lr over the parameters.  Returns {measure: (gap, worst
    leaf)}."""
    from dgmesh_torch.train.state import gaussian_group_lrs, net_lrs
    out = {"gaussian grads": (0.0, ""), "net grads": (0.0, ""), "params / lr": (0.0, ""),
           "gaussian grads max": (0.0, "")}

    def put(k, gap, where):
        if not gap <= out[k][0]:
            out[k] = (gap, where)

    lrs = gaussian_group_lrs(before.step, cfg)
    for f in type(got.gp)._fields:
        ga = (getattr(got.g_mu, f) - 0.9 * getattr(before.g_mu, f)).double() / 0.1
        gb = (getattr(want.g_mu, f) - 0.9 * getattr(before.g_mu, f)).double() / 0.1
        scale, n = float(gb.abs().max()), float(gb.norm())
        put("gaussian grads", float((ga - gb).norm()) / n if n > 0 else 0.0, f)
        put("gaussian grads max", float((ga - gb).abs().max()) / scale if scale > 0 else 0.0, f)
        put("params / lr", float((getattr(got.gp, f) - getattr(want.gp, f)).abs().max())
            / float(getattr(lrs, f)), f)
    nlrs = net_lrs(before.step.float(), cfg)
    for name in type(got.nets)._fields:
        oa, ob, o0 = (getattr(x.net_opt, name) for x in (got, want, before))
        for i, (ma, mb, m0) in enumerate(zip(oa.mu, ob.mu, o0.mu)):
            ga, gb = (ma - 0.9 * m0).double() / 0.1, (mb - 0.9 * m0).double() / 0.1
            n = float(gb.norm())
            put("net grads", float((ga - gb).norm()) / n if n > 0 else 0.0, f"{name}[{i}]")
        for i, (pa, pb) in enumerate(zip(getattr(got.nets, name).parameters(),
                                         getattr(want.nets, name).parameters())):
            put("params / lr", float((pa - pb).detach().abs().max()) / float(getattr(nlrs, name)),
                f"{name}[{i}]")
    return out


RESUME_LIMITS = {"gaussian grads": TOL_SMALL_GP, "net grads": TOL_SMALL_NET, "params / lr": 2.0}


def resume_check(torch, dev, failures, out, rows):
    """A fresh Trainer from the DRIVER_SAVE checkpoint runs DRIVER_SAVE + 1,
    twice (two fresh resumes: the card's run-to-run spread), each held to
    the uninterrupted run's checkpoint and logged metrics."""
    from dgmesh_torch.config import Config
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.train.checkpoint import load_checkpoint
    from dgmesh_torch.train.loop import Trainer
    cfg = Config.load(os.path.join(out, "cfg_args.json"))
    scene = Scene(cfg, shuffle=True, seed=6666)
    it = DRIVER_SAVE + 1
    before = load_checkpoint(cfg, out, DRIVER_SAVE, device=dev)
    want = load_checkpoint(cfg, out, it, device=dev)
    logged = next(r for r in rows if int(r["iter"]) == it)
    runs = []
    for _ in range(2):
        with contextlib.redirect_stdout(io.StringIO()):
            tr = Trainer(cfg, scene, state=load_checkpoint(cfg, out, DRIVER_SAVE, device=dev),
                         seed=6666, device=dev)
            m = {k: float(v) for k, v in tr.run_iteration(it).items()}
        runs.append((tr.state, m))
    keys = [k for k in ("loss", "img_loss", "mask_loss", "mesh_img_loss", "laplacian_loss",
                        "cycle_loss", "img_psnr", "mesh_psnr") if k in logged]
    for j, (st, m) in enumerate(runs):
        d_loss = max(abs(m[k] - logged[k]) / max(abs(logged[k]), 1e-12) for k in keys)
        d_mesh = max(abs(m[k] - logged[k]) / max(logged[k], 1.0)
                     for k in ("mesh_n_verts", "mesh_n_faces"))
        gaps = resume_gaps(torch, cfg, st, want, before)
        ok = (int(st.step) == int(want.step) and int(st.g_count) == int(want.g_count)
              and d_loss <= TOL_RESUME_LOSS and d_mesh <= TOL_RESUME_MESH
              and all(gaps[k][0] <= v for k, v in RESUME_LIMITS.items()))
        log(f"# driver resume {j + 1}: iteration {it} from the checkpoint at {DRIVER_SAVE} "
            f"against the uninterrupted run's: loss terms {d_loss:.3g} relative (tol "
            f"{TOL_RESUME_LOSS}); V/F {d_mesh:.3g} relative (tol {TOL_RESUME_MESH}; V "
            f"{int(m['mesh_n_verts'])}/{int(logged['mesh_n_verts'])}, F "
            f"{int(m['mesh_n_faces'])}/{int(logged['mesh_n_faces'])}); "
            + ", ".join(f"{k} {v[0]:.3g} (tol {RESUME_LIMITS.get(k, 'none')}, worst {v[1]})"
                        for k, v in gaps.items()) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"driver: resumed iteration {it} ({j + 1}) differs")
    gaps = resume_gaps(torch, cfg, runs[0][0], runs[1][0], before)
    d = max(abs(runs[0][1][k] - runs[1][1][k]) / max(abs(runs[1][1][k]), 1e-12) for k in keys)
    log(f"# driver resume: the two resumes against each other (the card's run-to-run "
        f"spread): loss terms {d:.3g} relative, "
        + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in gaps.items()))


def driver_phase(torch, dev, failures, summary, counters):
    """7 (module docstring)."""
    from dgmesh_torch.cli import render_test as cli_render
    from dgmesh_torch.data.synthetic_mesh import generate_mesh_dataset
    os.makedirs(DRIVER_DIR, exist_ok=True)
    data = os.path.join(DRIVER_DIR, "data")
    t0 = time.perf_counter()
    generate_mesh_dataset(data, n_frames=DRIVER_FRAMES, width=IMG, height=IMG,
                          n_test=DRIVER_TEST, subdiv=DRIVER_SUBDIV,
                          n_eval_meshes=DRIVER_EVAL_FRAMES, device=dev)
    torch.cuda.synchronize()
    log(f"# driver dataset: {DRIVER_FRAMES} + {DRIVER_TEST} frames at {IMG}², icosphere "
        f"subdiv {DRIVER_SUBDIV}, by generate_mesh_dataset on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    for label, extra in (("f32", {}), ("fused", {"mlp_bf16": True, "mlp_fused": True})):
        runs[label] = driver_run(torch, dev, failures, data, label, counters, extra)
        times = iteration_times(runs[label][1])
        log(f"# timing/driver {label}: ms per iteration (host clock, log_every 1): "
            + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
            + f"; phase 5's bare train_step ({N_GAUSS} Gaussians, 800², "
            f"{'fused' if label == 'fused' else 'float32'}) "
            f"{summary['fused' if label == 'fused' else 'f32'][0]:.2f}")
    out, rows, _ = runs["f32"]
    if rows:
        resume_check(torch, dev, failures, out, rows)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with open(os.path.join(DRIVER_DIR, "render_test.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        results = cli_render.main(["-m", out], device=DEVICE)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    renders = sorted(os.listdir(os.path.join(out, "test_renders")))
    ok = (all(math.isfinite(v) for v in results.values()) and launches["composite_tiles"] > 0
          and launches["shade_tiles"] > 0 and len(renders) == 3 * DRIVER_TEST)
    log(f"# driver render_test: {time.perf_counter() - t0:.2f} s; {results}; launches "
        f"{launches}; files {renders} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("driver: cli.render_test")
    return runs["fused"][0], data


def eval_phase(torch, dev, failures, counters, run_dir, data):
    """7e (module docstring)."""
    from dgmesh_torch.cli import mesh_evaluation as meval
    from dgmesh_torch.cli import render_trajectory as cli_traj
    from dgmesh_torch.config import Config
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.eval import lpips_torch, testing
    from dgmesh_torch.ops import mesh_raster as MR
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.train.checkpoint import load_checkpoint
    from dgmesh_torch.train.loop import Trainer
    from dgmesh_torch.train.step import make_batch
    from dgmesh_torch.utils_io import read_mesh_ply

    def zero():
        for c in counters:
            c.launches = 0

    def launches():
        return {c.__name__: c.launches for c in counters}

    # the checkpoint as render_test loads it
    t0 = time.perf_counter()
    cfg = Config.load(os.path.join(run_dir, "cfg_args.json"))
    scene = Scene(cfg, shuffle=False)
    trainer = Trainer(cfg, scene, state=load_checkpoint(cfg, run_dir, -1, device=dev),
                      device=dev)
    torch.cuda.synchronize()
    log(f"# eval: the fused run's final checkpoint loaded in {time.perf_counter() - t0:.2f} s")

    # 1. the dynamic mesh export, its parts timed apart
    n = DRIVER_EVAL_FRAMES
    meshes = os.path.join(run_dir, "meshes")
    frames = []
    zero()
    with open(os.path.join(DRIVER_DIR, "eval_export.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        parts, total, _ = call_by_stage(
            torch, [(testing, "_deform_all", "deform nets"),
                    (testing, "extract_mesh", "DPSR + marching tets"),
                    (testing, "_mesh_colors", "colour nets"),
                    (testing, "write_mesh_ply", "PLY write")],
            lambda: frames.extend(testing.export_dynamic_meshes(cfg, trainer, scene, meshes, n)),
            1, what="export_dynamic_meshes", per_call={k: n for k in (
                "deform nets", "DPSR + marching tets", "colour nets", "PLY write")})
    got = launches()
    finite = []
    for i in range(len(frames)):
        v, _ = read_mesh_ply(os.path.join(meshes, f"mesh_{i:05d}.ply"))
        finite.append(bool(np.isfinite(v).all()) and len(v) > 0)
    ok = (len(frames) == n and all(fr["mesh_overflow"] == 0 for fr in frames) and all(finite))
    log(f"# timing/eval export: {n} frames in {total:.2f} ms, {total / n:.2f} ms a frame: "
        + ", ".join(f"{k} {v / n:.2f}" for k, v in parts.items())
        + f" ms a frame; V {[fr['n_verts'] for fr in frames]}; F "
        f"{[fr['n_faces'] for fr in frames]}; mesh_overflow "
        f"{[fr['mesh_overflow'] for fr in frames]}; finite {all(finite)}; launches {got} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("eval: export_dynamic_meshes (overflow, empty or non-finite mesh)")

    # 2. cli.mesh_evaluation with JAX's recipe, its parts timed apart
    gt_dir = os.path.join(data, "gt_eval")
    transforms = os.path.join(data, "transforms_train.json")
    argv = ["--gt_dir", gt_dir, "--pred_dir", meshes, "--transforms", transforms,
            "--emd_samples", str(EVAL_EMD_SAMPLES), "--out",
            os.path.join(DRIVER_DIR, "eval_results.txt")]
    pairs = []
    torch.cuda.reset_peak_memory_stats()
    with open(os.path.join(DRIVER_DIR, "eval_meval.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        parts, total, _ = call_by_stage(
            torch, [(meval, "chamfer", "chamfer"), (meval, "sample_surface_np", "sampling"),
                    (meval, "emd_sinkhorn", "EMD")],
            lambda: pairs.extend(meval.main(argv, device=DEVICE)), 1,
            what="cli.mesh_evaluation", per_call={"chamfer": n, "sampling": 2 * n, "EMD": n})
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok = len(pairs) == n and all(math.isfinite(x) for p in pairs for x in p)
    log(f"# eval mesh_evaluation (--transforms, --method dgmesh, --emd_samples "
        f"{EVAL_EMD_SAMPLES}): CD {[round(p[0], 6) for p in pairs]}; EMD "
        f"{[round(p[1], 6) for p in pairs]} {'ok' if ok else 'FAIL'}")
    log(f"# timing/eval mesh_evaluation: {total / 1e3:.2f} s for {n} frames, "
        f"{total / n / 1e3:.3f} s a frame: "
        + ", ".join(f"{k} {v / n:.2f}" for k, v in parts.items())
        + f" ms a frame; peak memory {peak:.3f} GiB")
    if not ok:
        failures.append("eval: cli.mesh_evaluation (non-finite CD or EMD)")
    # the recipe's rotation and camera-origin shift suit the reference's
    # captures, not the generated data: the meshes in the dataset's own frame
    with open(os.path.join(DRIVER_DIR, "eval_meval_aligned.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        aligned = meval.main(["--gt_dir", gt_dir, "--pred_dir", meshes, "--method", "none",
                              "--emd_samples", str(EVAL_EMD_SAMPLES), "--out", os.path.join(DRIVER_DIR, "eval_results_aligned.txt")],
                             device=DEVICE)
    ok = len(aligned) == n and all(math.isfinite(x) for p in aligned for x in p)
    log(f"# eval mesh_evaluation in the dataset's frame (--method none, no --transforms): CD "
        f"{[round(p[0], 6) for p in aligned]}; EMD {[round(p[1], 6) for p in aligned]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("eval: cli.mesh_evaluation in the dataset's frame (non-finite)")
    # frame 0 on the card and on the CPU
    gts = sorted(x for x in os.listdir(gt_dir) if x.endswith(".obj"))
    gv, gf, pv, pf = meval.load_pair(os.path.join(gt_dir, gts[0]),
                                     os.path.join(meshes, "mesh_00000.ply"),
                                     meval.ROTATIONS["dgmesh"], meval.camera_origin(transforms))
    def on(x, where):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=where)

    cd_cli = float(meval.chamfer(on(gv, dev), on(pv, dev))[0]) / 2.0
    pv_s = pv[::EVAL_CHECK_STRIDE]
    gs = meval.sample_surface_np(gv, gf, EVAL_CHECK_SAMPLES, 0)
    ps = meval.sample_surface_np(pv, pf, EVAL_CHECK_SAMPLES, 1)
    res, secs = {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        res[str(where)] = (float(meval.chamfer(on(gv, where), on(pv_s, where))[0]) / 2.0,
                           float(meval.emd_sinkhorn(on(gs, where), on(ps, where))))
        secs[str(where)] = time.perf_counter() - t0
    (cd_g, emd_g), (cd_c, emd_c) = res[str(dev)], res["cpu"]
    d_cd, d_emd = abs(cd_g - cd_c) / abs(cd_c), abs(emd_g - emd_c) / abs(emd_c)
    ok = d_cd <= TOL_EVAL_CD_REL and d_emd <= TOL_EVAL_EMD_REL
    log(f"# eval frame 0, card vs CPU: CD {cd_g:.9g} / {cd_c:.9g} rel {d_cd:.3g} (tol "
        f"{TOL_EVAL_CD_REL}; {len(gv)} GT against every {EVAL_CHECK_STRIDE}th predicted vertex, "
        f"{len(pv_s)} of {len(pv)}); EMD at {EVAL_CHECK_SAMPLES} samples {emd_g:.9g} / "
        f"{emd_c:.9g} rel {d_emd:.3g} (tol {TOL_EVAL_EMD_REL}); {secs[str(dev)]:.2f} s / "
        f"{secs['cpu']:.2f} s; the card's CD of all {len(pv)} vertices is the CLI's "
        f"{cd_cli == pairs[0][0]} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("eval: card and CPU disagree on frame 0's CD or EMD")
    # the EMD alone at the CLI's samples: its time and its own peak memory
    gs = on(meval.sample_surface_np(gv, gf, EVAL_EMD_SAMPLES, 0), dev)
    ps = on(meval.sample_surface_np(pv, pf, EVAL_EMD_SAMPLES, 1), dev)
    times = []
    for r in range(1 + REPEATS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        meval.emd_sinkhorn(gs, ps)
        torch.cuda.synchronize()
        if r:
            times.append((time.perf_counter() - t0) * 1e3)
    log(f"# timing/eval EMD at {EVAL_EMD_SAMPLES} samples: {statistics.median(times):.2f} ms "
        f"(median of {REPEATS}), its peak memory above its inputs "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB")

    # 3. cli.render_trajectory: kernel 1 once and kernel 3 twice a view
    traj = os.path.join(DRIVER_DIR, "trajectory")
    zero()
    t0 = time.perf_counter()
    with open(os.path.join(DRIVER_DIR, "render_trajectory.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        panels = cli_traj.main(["-m", run_dir, "--n_views", str(TRAJ_VIEWS), "--out", traj],
                               device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    want = {c.__name__: 0 for c in counters}
    want.update(composite_tiles=TRAJ_VIEWS, shade_tiles=2 * TRAJ_VIEWS)
    files = sorted(os.listdir(traj))
    ok = (got == want and len(panels) == TRAJ_VIEWS
          and all(p.shape == (IMG, 2 * IMG, 3) and np.isfinite(p).all() for p in panels)
          and files == [f"frame_{i:03d}.png" for i in range(TRAJ_VIEWS)]
          + (["trajectory.gif"] if importlib.util.find_spec("imageio") else []))
    log(f"# eval render_trajectory --n_views {TRAJ_VIEWS} at {IMG}²: {wall:.2f} s with the "
        f"checkpoint load; launches {got} (want {want}; the load launches none); files "
        f"{files} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("eval: cli.render_trajectory (launches, panels or files)")
    # view 0's panel timed, kernel 3 held to its twin on the shape render's rows
    cams = cli_traj.trajectory_cameras(scene.train_cameras[0], TRAJ_VIEWS, 3.0, 0.3)
    b0 = make_batch(cams[0], scene.time_interval, trainer.bg, dev)
    keep = {}
    stages, total, _ = call_by_stage(
        torch, [(testing, "render_frame", "render_frame"),
                (MR, "render_mesh_shape", "render_mesh_shape"), (MK, "shade_tiles", "kernel 3")],
        lambda: cli_traj.render_panel(trainer, b0, cams[0].camera_center), REPEATS,
        what="render_panel", per_call={"kernel 3": 2}, keep=keep)
    log(f"# timing/eval trajectory view: {total:.2f} ms (median of {REPEATS}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + " ms")
    mc = trainer.ctx.mr_cfg
    check_shade(torch, MK, keep["kernel 3"][1][0], (mc.tiles_x, mc.tile_h, mc.tile_w), mc.sigma,
                "trajectory view 0, the shape render: shade_tiles", {"shade_tiles": []},
                failures)

    # 4. run_testing with LPIPS on random weights, for this phase only
    lp = os.path.join(DRIVER_DIR, "lpips")
    os.makedirs(lp, exist_ok=True)
    for net in ("alex", "vgg"):
        lpips_torch.random_weights(os.path.join(lp, f"lpips_{net}.npz"), net)
    saved = os.environ.get("DGMESH_LPIPS_DIR")
    os.environ["DGMESH_LPIPS_DIR"] = lp
    try:
        t0 = time.perf_counter()
        results = testing.run_testing(cfg, trainer, scene)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cols = [f"{p}lpips_{net}" for net in ("alex", "vgg") for p in ("", "mesh_")]
        ok = all(k in results and math.isfinite(results[k]) for k in cols)
        nv = len(scene.test_cameras)
        log(f"# eval run_testing with LPIPS: {results}; {nv / wall:.2f} views/s with the "
            f"metrics (fps {results['fps']:.2f}: the renders alone) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("eval: run_testing's LPIPS columns missing or not finite")
        b = make_batch(scene.test_cameras[0], scene.time_interval, trainer.bg, dev)
        img = testing.render_frame(trainer.ctx, trainer.state, b,
                                   cfg.model.sh_degree)["render"].clamp(0, 1)
        y0 = (IMG - LPIPS_CROP) // 2
        crop = (slice(None), slice(y0, y0 + LPIPS_CROP), slice(y0, y0 + LPIPS_CROP))
        for net in ("alex", "vgg"):
            times = []
            for r in range(1 + REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lpips_torch.rgb_lpips(img, b.gt_image, net)
                if r:
                    times.append((time.perf_counter() - t0) * 1e3)
            g = lpips_torch.rgb_lpips(img[crop], b.gt_image[crop], net)
            c = lpips_torch.rgb_lpips(img[crop].cpu(), b.gt_image[crop].cpu(), net)
            d = abs(g - c) / abs(c)
            ok = d <= TOL_LPIPS_REL
            log(f"# timing/eval LPIPS {net}: {statistics.median(times):.2f} ms an image at "
                f"{IMG}² (median of {REPEATS}); card vs CPU on a {LPIPS_CROP}² crop "
                f"{g:.7g} / {c:.7g} rel {d:.3g} (tol {TOL_LPIPS_REL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"eval: LPIPS {net} card and CPU disagree")
    finally:
        if saved is None:
            os.environ.pop("DGMESH_LPIPS_DIR", None)
        else:
            os.environ["DGMESH_LPIPS_DIR"] = saved
    return frames, pairs


def evaluate_phase(torch, dev, failures, counters, run_dir, data, frames, pairs):
    """7f (module docstring)."""
    import shutil
    from dgmesh_torch.cli import evaluate as cli_eval
    from dgmesh_torch.utils_io import read_mesh_ply
    # the run's config and final checkpoint in a folder of their own (7e's
    # files stay), and the dataset with the GT meshes of 7e's first and
    # last frames, the export's t = 0 and 1 at EVALUATE_MESHES 2
    run, src = (os.path.join(DRIVER_DIR, k) for k in ("evaluate_run", "evaluate_data"))
    for d in (run, src):
        shutil.rmtree(d, ignore_errors=True)
    ckpt = os.path.join(run_dir, "checkpoint")
    last = max(int(n[6:-3]) for n in os.listdir(ckpt) if n.startswith("state_")
               and n.endswith(".pt"))
    os.makedirs(os.path.join(run, "checkpoint"))
    shutil.copy(os.path.join(run_dir, "cfg_args.json"), run)
    shutil.copy(os.path.join(ckpt, f"state_{last}.pt"), os.path.join(run, "checkpoint"))
    os.makedirs(os.path.join(src, "gt_eval"))
    for name in os.listdir(data):
        if name != "gt_eval":
            os.symlink(os.path.join(data, name), os.path.join(src, name))
    gts = sorted(x for x in os.listdir(os.path.join(data, "gt_eval")) if x.endswith(".obj"))
    for name in (gts[0], gts[-1]):
        os.symlink(os.path.join(data, "gt_eval", name), os.path.join(src, "gt_eval", name))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(os.path.join(DRIVER_DIR, "evaluate.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        results, got = cli_eval.main(["-m", run, "-s", src, "--n_meshes", str(EVALUATE_MESHES),
                                      "--emd_samples", str(EVALUATE_EMD_SAMPLES)], device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    vf = [tuple(len(x) for x in read_mesh_ply(os.path.join(run, "meshes", f"mesh_{i:05d}.ply")))
          for i in range(EVALUATE_MESHES)]
    want_vf = [(fr["n_verts"], fr["n_faces"]) for fr in (frames[0], frames[-1])]
    want_cd = [pairs[0][0], pairs[-1][0]]
    d_mesh = max(abs(a - b) / b for g, w in zip(vf, want_vf) for a, b in zip(g, w))
    d_cd = max(abs(g[0] - w) / w for g, w in zip(got, want_cd))
    with open(os.path.join(run, "test_results", "test_result.txt")) as f:
        written = dict(ln.split(": ", 1) for ln in f.read().splitlines())
    n_views = sum(x.startswith("render_") for x in os.listdir(os.path.join(run, "test_results")))
    ok_txt = (set(written) == set(results) and {"psnr", "ssim", "mesh_psnr", "mesh_ssim",
                                                "fps"} <= set(written)
              and all(math.isfinite(float(v)) for v in written.values()))
    ok = (ok_txt and len(got) == EVALUATE_MESHES and d_mesh <= TOL_EVALUATE_MESH
          and d_cd <= TOL_EVALUATE_CD and all(math.isfinite(x) for p in got for x in p)
          and launches["composite_tiles"] == launches["shade_tiles"] == n_views)
    log(f"# evaluate: cli.evaluate -m (state_{last}.pt) --n_meshes {EVALUATE_MESHES} "
        f"--emd_samples {EVALUATE_EMD_SAMPLES}: test_result.txt {written}; V/F {vf} against 7e's "
        f"frames 0 and {len(frames) - 1} {want_vf}, {d_mesh:.3g} relative (tol "
        f"{TOL_EVALUATE_MESH}); CD {[p[0] for p in got]} against 7e's {want_cd}, {d_cd:.3g} "
        f"relative (tol {TOL_EVALUATE_CD}); EMD {[p[1] for p in got]}; launches {launches} "
        f"{'ok' if ok else 'FAIL'}")
    log(f"# timing/evaluate: cli.evaluate {wall:.2f} s (checkpoint load, run_testing of "
        f"{n_views} views at {IMG}², {EVALUATE_MESHES} meshes exported and evaluated); "
        + card_line())
    if not ok:
        failures.append("evaluate: cli.evaluate (its files, V/F or CD against 7e, launches)")


# --- phase 8's PNG frames, written independently of the port's writer and of
# Pillow (which writes no Average, Paeth or interlaced file on request)

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))   # PNG spec §8.2: each pass's first row and column, row and column steps


def png_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth RGB ramp with noise, (h, w, 3) uint8, as a camera frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(xx / 37.0) * 80 + np.cos(yy / 23.0) * 60 + 120 + 10 * c
                     for c in range(3)], -1)
    return np.clip(base + rng.integers(0, 20, base.shape), 0, 255).astype(np.uint8)


def png_file(img: np.ndarray, ft: int, interlace: bool = False) -> bytes:
    """An 8-bit RGB PNG of ``img`` with every row filtered ``ft`` (PNG spec
    §9: 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); with ``interlace`` its
    data is Adam7's passes, each a sub-image with its own rows."""
    def chunk(tag, body):
        return (len(body).to_bytes(4, "big") + tag + body
                + (zlib.crc32(tag + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    data = []
    for y0, x0, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        a = img[y0::dy, x0::dx].astype(np.int16)
        if a.size == 0:
            continue
        left, up, ul = (np.zeros_like(a) for _ in range(3))
        left[:, 1:], up[1:], ul[1:, 1:] = a[:, :-1], a[:-1], a[:-1, :-1]
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
        pred = [0, left, up, (left + up) >> 1,
                np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))][ft]
        rows = ((a - pred) & 0xFF).astype(np.uint8).reshape(len(a), -1)
        data.append(np.concatenate([np.full((len(a), 1), ft, np.uint8), rows], 1).tobytes())
    h, w = img.shape[:2]
    hdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, int(interlace)])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(b"".join(data), 6)) + chunk(b"IEND", b""))


@contextlib.contextmanager
def pil_blocked():
    """Pillow unimportable inside the block (a None entry in sys.modules)."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved


def png_read_times(read, files, img, repeats):
    """Each PNG of ``files`` {name: path} read by ``read`` ``repeats``
    times, Pillow's way where it imports and with PIL blocked: {name:
    {way: median seconds}}, and whether every array equals ``img``."""
    ways = [("Pillow" if importlib.util.find_spec("PIL") else "no Pillow",
             contextlib.nullcontext), ("PIL blocked", pil_blocked)]
    secs, same = {}, True
    for name, path in files.items():
        secs[name] = {}
        for way, ctx in ways:
            t = []
            for _ in range(repeats):
                with ctx():
                    t0 = time.perf_counter()
                    a = read(path)
                    t.append(time.perf_counter() - t0)
                same = same and a.dtype == img.dtype and np.array_equal(a, img)
            secs[name][way] = statistics.median(t)
    return secs, same


def capture_phase(torch, dev, failures, counters, kernels):
    """8 (module docstring)."""
    import argparse
    from dgmesh_torch.cli import render_test as cli_render
    from dgmesh_torch.config import Config, config_from_args
    from dgmesh_torch.data.resize import lanczos_resize
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.data.synthetic_mesh import generate_capture_datasets
    from dgmesh_torch.eval.testing import render_frame_with_aux
    from dgmesh_torch.ops import cuda_build
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.ops import mlp_fused as MF
    from dgmesh_torch.ops import splat_kernels as SK
    from dgmesh_torch.train import step
    from dgmesh_torch.train.checkpoint import load_checkpoint
    from dgmesh_torch.train.step import StepContext, make_batch
    card = card_line()
    os.makedirs(CAPTURE_DIR, exist_ok=True)
    t0 = time.perf_counter()
    paths = generate_capture_datasets(os.path.join(CAPTURE_DIR, "data"), n_train=CAPTURE_TRAIN,
                                      n_val=CAPTURE_VAL, width=CAPTURE_W, height=CAPTURE_H,
                                      device=dev)
    torch.cuda.synchronize()
    log(f"# capture dataset: {CAPTURE_TRAIN} + {CAPTURE_VAL} frames at {CAPTURE_W}x{CAPTURE_H} "
        f"in the {', '.join(paths)} layouts, by generate_capture_datasets on the card: "
        f"{time.perf_counter() - t0:.2f} s")

    # the Nerfies layout through cli.train under tail.yaml's widths, fused nets
    # tail.yaml's own gaussian_ratio and init_density_threshold: unlike the
    # 288 YAML's in phase 7, they keep this fit's mesh within the caps
    extra = {k: v for k, v in DRIVER_SCHEDULE.items()
             if k not in ("gaussian_ratio", "init_density_threshold")}
    extra.update(mlp_bf16=True, mlp_fused=True)
    out, rows, launches = driver_run(
        torch, dev, failures, paths["Nerfies"], "capture", counters, extra, src=CAPTURE_CONFIG,
        root=CAPTURE_DIR, save=(), what=f"{CAPTURE_W}x{CAPTURE_H}, {CAPTURE_TRAIN} training "
        f"views, {os.path.relpath(CAPTURE_CONFIG, ROOT)}")
    log(f"# timing/capture: ms per iteration (host clock, log_every 1): "
        + ", ".join(f"{k} {v:.2f}" for k, v in iteration_times(rows).items()) + f"; {card}")
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with open(os.path.join(CAPTURE_DIR, "render_test.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        results = cli_render.main(["-m", out], device=DEVICE)
    torch.cuda.synchronize()
    rl = {c.__name__: c.launches for c in counters}
    renders = sorted(os.listdir(os.path.join(out, "test_renders")))
    ok = (all(math.isfinite(v) for v in results.values()) and rl["composite_tiles"] > 0
          and rl["shade_tiles"] > 0 and len(renders) == 3 * CAPTURE_VAL)
    log(f"# capture render_test: {time.perf_counter() - t0:.2f} s; {results}; launches {rl}; "
        f"files {renders} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("capture: cli.render_test")

    # the iPhone and NeuralActor layouts through Scene under their YAMLs'
    # data_type, with Pillow made unimportable (a None entry in sys.modules);
    # one view of each rendered from the run's final state
    cfg = Config.load(os.path.join(out, "cfg_args.json"))
    state = load_checkpoint(cfg, out, device=dev)
    ctx = StepContext(cfg, CAPTURE_W, CAPTURE_H, device=dev)
    bg = np.ones(3, np.float32)
    with pil_blocked():
        t0 = time.perf_counter()
        nscene = Scene(cfg, shuffle=True, seed=6666)
        load_s = {"Nerfies": time.perf_counter() - t0}
        scenes = {}
        for layout, yml in CAPTURE_YAMLS.items():
            ycfg = config_from_args(argparse.Namespace(), yml)
            ycfg.model.source_path = paths[layout]
            t0 = time.perf_counter()
            scenes[layout] = (ycfg, Scene(ycfg, shuffle=False))
            load_s[layout] = time.perf_counter() - t0
    for layout, (ycfg, scene) in scenes.items():
        yml = CAPTURE_YAMLS[layout]
        cam = scene.test_cameras[0]
        times = []
        for _ in range(1 + REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, aux = render_frame_with_aux(ctx, state, make_batch(cam, 0.01, bg, device=dev),
                                           cfg.model.sh_degree)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        gt = torch.as_tensor(cam.image, device=dev).permute(2, 0, 1)
        psnr = float(-10 * torch.log10(((o["render"] - gt) ** 2).mean()))
        ok = (ycfg.model.data_type == layout and tuple(o["render"].shape) == (3, CAPTURE_H,
                                                                               CAPTURE_W)
              and all(bool(torch.isfinite(o[k]).all()) for k in ("render", "mesh_image", "mask"))
              and int(aux["mesh_overflow"]) == 0 and int(o["n_faces"]) > 0
              and cam.K[0, 2] != CAPTURE_W / 2)
        log(f"# capture {layout} ({os.path.relpath(yml, ROOT)}, data_type {ycfg.model.data_type}):"
            f" Scene {load_s[layout]:.3f} s for {len(scene.train_cameras)} + "
            f"{len(scene.test_cameras)} views; render of {cam.image_name} "
            f"{statistics.median(times[1:]):.2f} ms median of {REPEATS} (first "
            f"{times[0]:.2f}); GS PSNR {psnr:.2f} dB against its frame; V {int(o['n_verts'])} "
            f"F {int(o['n_faces'])}; mesh overflow {int(aux['mesh_overflow'])}; read with "
            f"Pillow unimportable {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"capture: the {layout} layout")
    log(f"# capture Scene load: Nerfies {load_s['Nerfies']:.3f} s ({len(nscene.train_cameras)} + "
        f"{len(nscene.test_cameras)} views); " + card)

    # kernels 1-4 at K 768/192 and 5-6 at din 84, on one fused mesh-phase
    # step's rows from the final state (a training view of the layout)
    errs = {k: [] for k in SOURCES}
    tbatch = make_batch(nscene.train_cameras[0], nscene.time_interval, bg, device=dev)
    flags = train_flags(step, cfg.model.sh_degree)
    targets = [(SK, "composite_bwd", "composite_bwd_kernel"),
               (MK, "shade_bwd", "shade_bwd_kernel"),
               (MF, "trunk_bwd", "trunk_bwd_kernel")]
    calls = {}
    stages, total, args = call_by_stage(
        torch, targets, lambda: step.train_step(ctx, state, tbatch, flags), 1,
        what="train_step", per_call={"trunk_bwd_kernel": TRUNKS}, keep=calls)
    sc, mc = ctx.splat_cfg, ctx.mr_cfg
    geo_s, geo_m = (sc.tiles_x, sc.tile_h, sc.tile_w), (mc.tiles_x, mc.tile_h, mc.tile_w)
    ca, sa = args["composite_bwd_kernel"][0].detach(), args["shade_bwd_kernel"][0].detach()
    c_res = tuple(x.detach() for x in args["composite_bwd_kernel"][6:8])
    s_res = args["shade_bwd_kernel"][7:9]
    cg, cga, sg, sgs = (x.detach() / x.detach().abs().max().clamp_min(1e-30)
                        for x in (*args["composite_bwd_kernel"][1:3],
                                  *args["shade_bwd_kernel"][1:3]))
    K1, K2 = ca.shape[1], sa.shape[1]
    if (K1, K2) != (cfg.tpu.max_gaussians_per_tile, cfg.tpu.max_faces_per_tile) or \
            sc.width % sc.tile_w == 0:
        failures.append(f"capture: kernels at K {K1}/{K2}, width {sc.width}")
    check_composite(torch, SK, ca, geo_s, "capture: composite_tiles", errs, failures)
    check_composite_bwd(torch, SK, ca, cg, cga, geo_s, "capture: composite_bwd", errs, failures,
                        c_res)
    check_shade(torch, MK, sa, geo_m, mc.sigma, "capture: shade_tiles", errs, failures)
    check_shade_bwd(torch, MK, sa, sg, sgs, geo_m + (mc.sigma,), "capture: shade_bwd", errs,
                    failures, s_res)
    P = sc.tile_h * sc.tile_w
    c_valid, c_pass, c_live = composite_pairs(torch, SK, ca, sc)
    s_valid, s_soft, s_rgb = shade_pairs(torch, SK, sa, sg, sgs, mc)
    rows_k = {  # name: (kernel, twin, bytes, operations), as phases 4 and 5 count them
        "composite_tiles": (lambda: SK.composite_tiles(ca, *geo_s),
                            lambda: SK.composite_tiles_ref(ca, *geo_s),
                            ca.numel() * 4 + ca.shape[0] * P * 4 * 4,
                            c_valid * COMPOSITE_TEST_OPS + c_pass * COMPOSITE_ACCUM_OPS),
        "composite_bwd": (lambda: SK.composite_bwd(ca, cg, cga, *geo_s, *c_res),
                          lambda: SK.composite_bwd_ref(ca, cg, cga, *geo_s, rgb=c_res[0],
                                                       S=c_res[1]),
                          (2 * ca.numel() + cg.numel() + cga.numel()
                           + sum(x.numel() for x in c_res)) * 4,
                          c_valid * COMPOSITE_TEST_OPS + c_pass * COMPOSITE_BWD_PASS_OPS
                          + c_live * COMPOSITE_BWD_LIVE_OPS + cga.numel() * COMPOSITE_BWD_PIXEL_OPS),
        "shade_tiles": (lambda: MK.shade_tiles(sa, *geo_m, mc.sigma),
                        lambda: MK.shade_tiles_ref(sa, *geo_m, mc.sigma),
                        sa.numel() * 4 + sa.shape[0] * P * 6 * 4,
                        int((sa[..., 9] > 0.5).sum()) * P * SHADE_OPS),
        "shade_bwd": (lambda: MK.shade_bwd(sa, sg, sgs, *geo_m, mc.sigma, *s_res),
                      lambda: MK.shade_bwd_ref(sa, sg, sgs, *geo_m, mc.sigma),
                      (2 * sa.numel() + sg.numel() + sgs.numel()
                       + sum(x.numel() for x in s_res)) * 4,
                      s_valid * SHADE_OPS + s_soft * SHADE_BWD_SOFT_OPS + s_rgb * SHADE_BWD_RGB_OPS),
    }
    occ = cuda_build.library("composite_bwd").composite_bwd_ctas_per_sm
    occ.argtypes, occ.restype = [ctypes.c_int] * 3, ctypes.c_int
    ctas = {k: occ(k, sc.tile_h, sc.tile_w) for k in (K1, 384)}
    log(f"# capture composite_bwd: CTAs an SM by the occupancy calculator at K {K1} "
        f"{ctas[K1]}, at K 384 (the 288 YAML's) {ctas[384]}")
    if min(ctas.values()) < 1:
        failures.append(f"capture: composite_bwd occupancy {ctas}")
    log(f"# capture rows: composite {ca.shape[0]} tiles x K {K1}, {c_valid // P} valid rows, "
        f"{c_pass} passing pairs; shade {sa.shape[0]} tiles x K {K2}, {s_valid // P} valid rows "
        f"(tiles {sc.tiles_x}x{sc.tiles_y} over {sc.width}x{sc.height}: the last column partial)")
    for name, (fk, fp, nbytes, nops) in rows_k.items():
        ms, plain_ms = time_cuda(torch, fk, KERNEL_TIMING_LAUNCHES), time_cuda(torch, fp, 2)
        bound = max(nbytes / PEAK_BYTES, nops / PEAK_F32) * 1e3
        log(f"# timing/capture {name} (K {K1 if 'composite' in name else K2}): {ms:.4f} "
            f"ms/launch, twin {plain_ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{nops / 1e9:.2f} G ops); {card}")
    del ca, cg, cga, c_res, sa, sg, sgs, s_res, args, rows_k
    dins = sorted({x.shape[1] for x, *_ in calls["trunk_bwd_kernel"]})
    for x, wb, bp, g, *_ in calls["trunk_bwd_kernel"]:
        x, g = x.detach(), g.detach()
        g = g / g.abs().max().clamp_min(1e-30)
        ok, rep, groups = compare_trunk(torch, MF, x, wb, bp, g)
        errs["trunk_fwd"].append(rep["out"][2])
        errs["trunk_bwd"].append(max(rep[k][2] for k in ("dx", "dW", "db")))
        log(f"# kernels/capture: trunk_fwd/trunk_bwd {tuple(x.shape)}: "
            f"{trunk_report(rep, groups)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"capture: trunk kernels vs twins ({tuple(x.shape)})")
    x, wb, bp, g, *_ = max(calls["trunk_bwd_kernel"], key=lambda c: c[0].shape[0])
    x, g = x.detach(), g.detach()
    ws, wt = MF.stage_pack(MF.transpose_pack(wb)), MF.transpose_pack(wb)
    log(f"# timing/capture trunk ({x.shape[0]},{x.shape[1]}): trunk_fwd "
        f"{time_cuda(torch, lambda: MF.trunk_fwd(x, wb, bp, ws), KERNEL_TIMING_LAUNCHES):.4f} "
        f"ms/launch, trunk_bwd "
        f"{time_cuda(torch, lambda: MF.trunk_bwd(x, wb, bp, g, wt), KERNEL_TIMING_LAUNCHES):.4f}"
        f" ms/launch; din of the step's trunks {dins}; {card}")
    if dins != [CAPTURE_DIN]:
        failures.append(f"capture: trunk din {dins}, not [{CAPTURE_DIN}]")
    for k in kernels:
        if errs[k["name"]]:
            k["max_abs_err"] = max(k["max_abs_err"], max(errs[k["name"]]))
    unlaunched = [k for k, n in launches.items() if n == 0]
    log(f"# capture launches (cli.train): {launches}")
    if unlaunched:
        failures.append(f"capture: {unlaunched} not launched")
    del x, wb, bp, g, ws, wt, calls, state
    torch.cuda.empty_cache()

    # card vs CPU: one off-centre K camera at a size no multiple of 16
    capture_small_check(torch, dev, failures)

    # the host's LANCZOS resize of one PlenopticVideo frame (resolution -1)
    frame = np.random.default_rng(0).integers(0, 256, RESIZE_FROM[::-1] + (3,), dtype=np.uint8)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        small = lanczos_resize(frame, RESIZE_TO)
        secs.append(time.perf_counter() - t0)
    log(f"# timing/capture lanczos_resize {RESIZE_FROM[0]}x{RESIZE_FROM[1]} RGB to "
        f"{RESIZE_TO[0]}x{RESIZE_TO[1]} on the host: {statistics.median(secs):.3f} s median of 3 "
        f"({', '.join(f'{v:.3f}' for v in secs)}); {os.cpu_count()} host cores")
    if small.shape != RESIZE_TO[::-1] + (3,):
        failures.append("capture: lanczos_resize shape")

    # the host's PNG reads of a capture frame: Paeth, Average and Adam7 rows,
    # through Pillow where it imports and with PIL blocked (decode_png)
    from dgmesh_torch.utils_io import read_png
    img = png_frame(CAPTURE_H, CAPTURE_W)
    files = {}
    for name, (ft, interlace) in PNG_FILES.items():
        files[name] = os.path.join(CAPTURE_DIR, f"frame_{name.replace(' ', '_')}.png")
        with open(files[name], "wb") as f:
            f.write(png_file(img, ft, interlace))
    secs, same = png_read_times(read_png, files, img, 3)
    for name, t in secs.items():
        log(f"# timing/capture PNG {name} {CAPTURE_W}x{CAPTURE_H} RGB "
            f"({os.path.getsize(files[name])} bytes) read_png on the host: "
            + ", ".join(f"{k} {v:.4f} s" for k, v in t.items()) + f" (median of 3); "
            f"{os.cpu_count()} host cores")
    log(f"# capture PNG reads: every array equal to the frame and to each other "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append("capture: a PNG read differs from its frame")


def capture_small_check(torch, dev, failures):
    """render_frame of a real-capture state (is_blender false) through an
    off-centre K camera at CAPTURE_SMALL, on the card and on the CPU: the
    images within TOL_SMALL, the mesh's counts and faces equal."""
    from dgmesh_torch.cameras import Camera
    from dgmesh_torch.config import Config
    from dgmesh_torch.eval.testing import render_frame_with_aux
    from dgmesh_torch.train.state import state_to
    from dgmesh_torch.train.step import StepContext, make_batch
    W, H = CAPTURE_SMALL
    small = _small_cfg(Config)
    small.model.is_blender = False
    st_c = build_shell_state(torch, small, 256, "cpu")
    st_g = state_to(st_c, dev)
    a = 0.3
    c2w = np.eye(4)
    c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
    c2w[:3, 3] = c2w[:3, :3] @ [0, 0, 2.5]
    cv = c2w.copy()
    cv[:3, 1:3] *= -1
    w2c = np.linalg.inv(cv)
    K = np.array([[70.0, 0, 0.56 * W], [0, 66.0, 0.43 * H], [0, 0, 1]], np.float32)
    cam = Camera(uid=0, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=2 * math.atan(W / 140),
                 fovy=2 * math.atan(H / 132), image=None, alpha_mask=None, fid=0.4, width=W,
                 height=H, K=K, orig_transform=c2w.astype(np.float32))
    bg = np.zeros(3, np.float32)
    og, ag = render_frame_with_aux(StepContext(small, W, H, device=dev), st_g,
                                   make_batch(cam, 0.01, bg, device=dev), small.model.sh_degree)
    oc, ac = render_frame_with_aux(StepContext(small, W, H, device="cpu"), st_c,
                                   make_batch(cam, 0.01, bg, device="cpu"), small.model.sh_degree)
    d_img = max(float((og[k].cpu() - oc[k]).abs().max()) for k in ("render", "mesh_image", "mask"))
    same = (int(og["n_verts"]) == int(oc["n_verts"]) and int(og["n_faces"]) == int(oc["n_faces"])
            and torch.equal(og["faces"].cpu(), oc["faces"]))
    ok = (same and d_img <= TOL_SMALL and int(oc["n_faces"]) > 0
          and int(ag["mesh_overflow"]) == int(ac["mesh_overflow"]) == 0)
    log(f"# capture small view {W}x{H}, K principal point ({K[0, 2]:.2f}, {K[1, 2]:.2f}): card vs "
        f"CPU max image diff {d_img:.3g} (tol {TOL_SMALL}); V {int(og['n_verts'])}/"
        f"{int(oc['n_verts'])} F {int(og['n_faces'])}/{int(oc['n_faces'])}, faces "
        f"{'equal' if same else 'DIFFERENT'} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("capture: small off-centre view, card and CPU disagree")


def converging_phase(torch, dev, failures):
    """7b: tests/test_mesh_phase_learns.py's regime (its dataset, config and
    schedule) trained by the port's Trainer on the card, with its four
    properties."""
    from dgmesh_torch.config import Config
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.data.synthetic_mesh import generate_mesh_dataset
    from dgmesh_torch.train.loop import Trainer
    from dgmesh_torch.train.state import DENSITY_THRES_BOUND
    data = os.path.join(DRIVER_DIR, "converge_data")
    generate_mesh_dataset(data, n_frames=6, width=64, height=64, n_test=1, subdiv=3,
                          n_eval_meshes=0, max_per_tile=1024, device=dev)
    cfg = converging_cfg(Config, data)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, Scene(cfg, shuffle=True), device=dev)
    # deterministic scatters: the outcome is the code's, not the atomic
    # order's (the criterion compares two single-view rows at each end,
    # which sit ±2 dB apart; PERF.md §6)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with open(os.path.join(DRIVER_DIR, "converge.log"), "w") as f, \
                contextlib.redirect_stdout(f), warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            history = trainer.train(iterations=cfg.optimization.iterations, log_every=20)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mesh_rows = [m for m in history if "mesh_psnr" in m]
    pre = [m for m in history if "mesh_psnr" not in m]
    first = float(np.mean([m["mesh_psnr"] for m in mesh_rows[:2]]))
    last = float(np.mean([m["mesh_psnr"] for m in mesh_rows[-2:]]))
    gs_before = max(m["img_psnr"] for m in pre[-3:])
    gs_after = float(np.mean([m["img_psnr"] for m in mesh_rows[-2:]]))
    thr = float(trainer.state.gp.density_thres)
    checks = {
        "mesh_psnr rises": len(mesh_rows) >= 5 and last > first + 1.0,
        "GS not destroyed": gs_after > gs_before - 3.0,
        "density_thres not pinned": abs(thr) < DENSITY_THRES_BOUND - 0.01,
        "mesh has geometry": (mesh_rows[-1].get("mesh_n_verts", 0) > 100
                              and all(m.get("mesh_overflow", 0) == 0 for m in mesh_rows)),
    }
    log(f"# converging regime: {cfg.optimization.iterations} iterations at 64², grid "
        f"{cfg.model.grid_res}, {wall:.2f} s ({1e3 * wall / cfg.optimization.iterations:.2f} "
        f"ms/iteration with logging); mesh_psnr by row "
        f"{[round(m['mesh_psnr'], 2) for m in mesh_rows]}, {first:.2f} → {last:.2f}; raster "
        f"overflow at the last row {int(mesh_rows[-1].get('raster_overflow', 0))}; img_psnr "
        f"{gs_before:.2f} → {gs_after:.2f}; density_thres {thr:.4f}; V "
        f"{int(mesh_rows[-1].get('mesh_n_verts', 0)) if mesh_rows else 0}; "
        + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    for k, v in checks.items():
        if not v:
            failures.append(f"converging regime: {k}")


def converging_cfg(Config, data):
    """tests/test_mesh_phase_learns.py's config, on ``data``."""
    cfg = Config()
    cfg.model.source_path = data
    cfg.model.data_type = "finetune-nerf"
    cfg.model.is_blender = True
    cfg.model.white_background = False
    cfg.model.grid_res = 24
    cfg.model.sh_degree = 1
    cfg.model.gaussian_ratio = 1.2
    o = cfg.optimization
    o.iterations = CONVERGE_ITERS
    o.warm_up, o.dpsr_iter, o.normal_warm_up, o.normal_net_warmup = 30, 220, 40, 60
    o.anchor_iter = 10_000
    o.densify_from_iter, o.densify_until_iter, o.densification_interval = 30, 150, 50
    o.opacity_reset_interval = 100_000
    o.dpsr_sig = 2.0
    o.mask_loss_weight = 1.0
    t = cfg.tpu
    t.max_gaussians = 2048
    t.max_verts, t.max_faces = 16384, 32768
    t.max_gaussians_per_tile, t.max_dup = 128, 1 << 15
    t.max_faces_per_tile, t.max_face_dup = 512, 1 << 17
    return cfg


# phase 9 (the multi-device step): ranks on the one card, steps each, and
# the limits against the unsharded step on the same card.  The two differ
# by sums in other orders (the scatters, the DPSR's transforms, kernel 6's
# weight sums over other rows) and, through the ~1e-6 moves of the mesh
# vertices that follow, by a bf16 rounding of a trunk input that may tip a
# ReLU: the sources of the card-vs-CPU fused check's differences, so its
# limits; parameters within 2 lr (Adam's first step, as the resume check)
SHARD_RANKS = 2
SHARD_STEPS = 3
# the capacity counters that follow sub-ulp moves of the mesh vertices
# (the backface cull and the tile rects of a face on an edge): the card's
# own scatter sums move them run to run, and the sharded DPSR's transforms
# in another order; held to this relative gap, the others exactly
SHARD_SOFT_COUNTERS = {"raster_overflow": 1e-4}
TOL_SHARD_RANKS = 1e-6   # a float metric on two ranks: replicated sums with atomics
SHARD_LEGS = ((SHARD_RANKS, "gloo"), (1, "nccl"))   # (ranks on the card, backend)
TOL_SHARD_LOSS = 1e-4
SHARD_LIMITS = {"gaussian grads": TOL_SMALL_GP_FUSED, "net grads": TOL_SMALL_NET_FUSED,
                "params / lr": 2.0 * 1.001}   # 2 lr and its float32 rounding
# phase 10: the screw heads' (w, v Denses) initial weights times this, so a
# random state moves its points by ~1e-3 rad, not ~1 (flax's default init
# on a 256-wide trunk output)
SCREW_SCALE = 1e-3


def batch_to(batch, device):
    """A Batch (its camera arrays too) on ``device``."""
    return type(batch)(*[type(x)(*[y.to(device) for y in x]) if isinstance(x, tuple)
                         else x.to(device) for x in batch])


def shard_rank(mesh, cfg, img, state, batch, flags, steps, profile=False):
    """One rank of phase 9: its part of ``state`` (whole, on the CPU) on its
    card, one step with the launch counters zeroed just before and read just
    after, ``steps`` timed steps, one more with every collective timed.
    Returns its counters and times, the gathered new state, the metrics and
    the gradients (the replicated leaves' summed over the ranks, the row
    leaves' gathered)."""
    import torch
    sys.path.insert(0, ROOT)
    from dgmesh_torch.models.gaussians import GaussianParams
    from dgmesh_torch.ops import cuda_build
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.ops import mlp_fused as MF
    from dgmesh_torch.ops import splat_kernels as SK
    from dgmesh_torch.parallel import sharding as SH
    from dgmesh_torch.train import step

    dev = mesh.device
    on_card = dev.type == "cuda"
    if on_card:
        cuda_build.build()   # loads the libraries the parent built: no nvcc here

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    ctx = step.StepContext(cfg, img, img, device=dev, device_mesh=mesh)
    part = SH.shard_state(state, mesh)
    batch = batch_to(batch, dev)
    counters = (SK.composite_tiles, SK.composite_bwd, MK.shade_tiles, MK.shade_bwd,
                MF.trunk_fwd, MF.trunk_bwd)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    copies0 = mesh.host_copies
    new, metrics = step.train_step(ctx, part, batch, flags)
    sync()
    launches = {c.__name__: c.launches for c in counters}
    host_copies = mesh.host_copies - copies0
    times = []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        step.train_step(ctx, part, batch, flags)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    mesh.timing, mesh.collective_ms, mesh.collective_calls = True, 0.0, 0
    t0 = time.perf_counter()
    step.train_step(ctx, part, batch, flags)
    sync()
    timed = (time.perf_counter() - t0) * 1e3
    coll = (mesh.collective_ms, mesh.collective_calls)
    mesh.timing = False
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0
    tables = None
    if profile:      # every rank steps: the step's collectives need them all
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if on_card else [])
        with torch.profiler.profile(activities=acts) as prof:
            step.train_step(ctx, part, batch, flags)
            sync()
        ka = prof.key_averages()
        tables = [ka.table(sort_by=k, row_limit=14) for k in (
            ("self_cuda_time_total" if on_card else "self_cpu_time_total"),
            "self_cpu_time_total")]
        tables.append(f"device busy {sum(e.self_device_time_total for e in ka) / 1e3:.2f} ms, "
                      f"host {sum(e.self_cpu_time_total for e in ka) / 1e3:.2f} ms (self sums)")
        tables = tables if mesh.rank == 0 else None
    _, _, grads = step.loss_and_grads(ctx, part, batch, flags)
    grads, _ = step.sanitize(grads, mesh)
    g_gp = GaussianParams(*[SH.all_gather(g, mesh) if f != "density_thres" else g
                            for f, g in zip(GaussianParams._fields, grads.gp)])
    return dict(launches=launches, host_copies=host_copies, host_staged=sorted(mesh.host_staged),
                times=times, timed_step=timed, collectives=coll, peak=peak,
                metrics={k: float(v) for k, v in metrics.items()},
                new=SH.gather_state(new, mesh), g_gp=g_gp, g_nets=grads.nets,
                backend=mesh.backend, profile=tables)


def multi_device_phase(torch, dev, failures):
    """Phase 9: the sharded step against the unsharded one on this card."""
    from dgmesh_torch.parallel import sharding as SH
    from dgmesh_torch.train import step
    from dgmesh_torch.train.state import state_to

    fcfg = load_cfg()
    fcfg.tpu.mlp_bf16 = fcfg.tpu.mlp_fused = True
    W = IMG
    ctx = step.StepContext(fcfg, W, W, device=dev)
    state = build_shell_state(torch, fcfg, N_GAUSS, dev)
    batch = bench_batch(W, W, dev)
    flags = train_flags(step, fcfg.model.sh_degree)
    step.train_step(ctx, state, batch, flags)                  # warm-up
    times = []
    for _ in range(SHARD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_new, want = step.train_step(ctx, state, batch, flags)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"# phase 9: the unsharded fused step on this card: {statistics.median(times):.2f} ms "
        f"median of {SHARD_STEPS} ({', '.join(f'{x:.2f}' for x in times)}); V "
        f"{int(want['mesh_n_verts'])} F {int(want['mesh_n_faces'])}")
    _, _, wgrads = step.loss_and_grads(ctx, state, batch, flags)
    wgrads, _ = step.sanitize(wgrads)
    # the card's own spread: the unsharded step's gradients once more
    _, _, again = step.loss_and_grads(ctx, state, batch, flags)
    again, _ = step.sanitize(again)
    spread_gp = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                    for a, b in zip(again.gp, wgrads.gp))
    spread_net = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                     for na, nb in zip(again.nets, wgrads.nets) for a, b in zip(na, nb))
    log(f"# phase 9: the unsharded step's gradients twice on this card: Gaussian leaves "
        f"norm rel {spread_gp:.3g}, net leaves {spread_net:.3g} (the scatters' order)")
    del again
    before = state_to(state, "cpu")
    want_new = state_to(want_new, "cpu")
    want = {k: float(v) for k, v in want.items()}
    wg = [g.cpu() for g in wgrads.gp], [[g.cpu() for g in n] for n in wgrads.nets]
    del wgrads
    cpu_batch = batch_to(batch, "cpu")
    where = "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    for n, backend in SHARD_LEGS:
        t0 = time.perf_counter()
        out = SH.spawn(shard_rank, n, backend, where,
                       args=(fcfg, W, before, cpu_batch, flags, SHARD_STEPS, True))
        wall = time.perf_counter() - t0
        label = f"{n} rank{'s' if n > 1 else ''} on one card, {backend}"
        for r, o in enumerate(out):
            missing = [k for k, v in o["launches"].items() if v < 1]
            log(f"# phase 9 ({label}) rank {r}: launches {o['launches']}; step ms "
                f"{', '.join(f'{x:.2f}' for x in o['times'])} (median "
                f"{statistics.median(o['times']):.2f}); with each collective timed "
                f"{o['timed_step']:.2f} ms, of it {o['collectives'][0]:.2f} ms in "
                f"{o['collectives'][1]} collectives; host-staged collectives "
                f"{o['host_staged'] or 'none'}, {o['host_copies']} tensors through the host "
                f"a step; peak {o['peak']:.3f} GiB")
            if missing:
                failures.append(f"phase 9 ({label}) rank {r}: {missing} not launched")
            gap = max(abs(v - out[0]["metrics"][k]) / max(abs(out[0]["metrics"][k]), 1e-20)
                      for k, v in o["metrics"].items())
            counts = all(o["metrics"][k] == out[0]["metrics"][k] for k in (
                "mesh_n_verts", "mesh_n_faces", "mesh_overflow", "splat_overflow",
                "raster_overflow", "n_alive", "nonfinite_grad_leaves"))
            if r:
                log(f"# phase 9 ({label}) rank {r} against rank 0: metrics rel {gap:.3g} (tol "
                    f"{TOL_SHARD_RANKS}), counters {'equal' if counts else 'DIFFERENT'}")
            if gap > TOL_SHARD_RANKS or not counts:
                failures.append(f"phase 9 ({label}): rank {r}'s metrics differ from rank 0's")
        got = out[0]
        if got["profile"]:
            path = os.path.join(MULTI_DIR, f"phase9_profile_{backend}{n}.txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write("\n\n".join(got["profile"]))
            log(f"# phase 9 ({label}) rank 0, one profiled step: {got['profile'][-1]}; the "
                f"top operators in {os.path.relpath(path, ROOT)}")
        m = got["metrics"]
        d_loss = max(abs(m[k] - want[k]) / max(abs(want[k]), 1e-20) for k in (
            "loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss", "img_loss"))
        exact = {k: (int(m[k]), int(want[k])) for k in (
            "mesh_n_verts", "mesh_n_faces", "mesh_overflow", "splat_overflow",
            "splat_dup_overflow", "n_alive", "nonfinite_grad_leaves")}
        soft = {k: (int(m[k]), int(want[k])) for k in SHARD_SOFT_COUNTERS}
        gaps = resume_gaps(torch, fcfg, got["new"], want_new, before)
        g_gp = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                   for a, b in zip(got["g_gp"], wg[0]))
        g_net = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                    for na, nb in zip(got["g_nets"], wg[1]) for a, b in zip(na, nb))
        ok = (d_loss <= TOL_SHARD_LOSS and all(a == b for a, b in exact.values())
              and all(abs(a - b) <= SHARD_SOFT_COUNTERS[k] * max(b, 1)
                      for k, (a, b) in soft.items())
              and g_gp <= SHARD_LIMITS["gaussian grads"] and g_net <= SHARD_LIMITS["net grads"]
              and all(gaps[k][0] <= SHARD_LIMITS[k] for k in SHARD_LIMITS)
              and not any(k for k in ("mesh_overflow", "nonfinite_grad_leaves") if m[k]))
        log(f"# phase 9 ({label}) vs the unsharded step: loss terms rel {d_loss:.3g} (tol "
            f"{TOL_SHARD_LOSS}); " + ", ".join(f"{k} {a}/{b}" for k, (a, b) in exact.items())
            + ", " + ", ".join(f"{k} {a}/{b} (rel tol {SHARD_SOFT_COUNTERS[k]})"
                               for k, (a, b) in soft.items())
            + f"; gradients (loss_and_grads) Gaussian leaves norm rel {g_gp:.3g}, net leaves "
            f"{g_net:.3g}; new state: " + ", ".join(
                f"{k} {v:.3g} ({w}, tol {SHARD_LIMITS.get(k, 'reported')})"
                for k, (v, w) in gaps.items())
            + f"; {wall:.1f} s with the ranks' start {'ok' if ok else 'FAIL'}")
        log(f"# timing phase 9 ({label}): {statistics.median(got['times']):.2f} ms per "
            f"sharded step, {got['collectives'][0]:.2f} ms of collectives (each timed alone); "
            f"unsharded {statistics.median(times):.2f} ms; {card_line()}")
        if not ok:
            failures.append(f"phase 9 ({label}): the sharded step disagrees with the unsharded one")


def scale_screw_heads(torch, nets):
    with torch.no_grad():
        for net in (nets.deform, nets.deform_back):
            for head in (net.head_w, net.head_v):
                head.weight.mul_(SCREW_SCALE)


def six_dof_phase(torch, dev, failures, counters):
    """Phase 10: the 6-DoF head at the small size, card vs CPU, and one
    fused full-width step."""
    from dgmesh_torch.config import Config
    from dgmesh_torch.eval.testing import render_frame_with_aux
    from dgmesh_torch.train import step
    from dgmesh_torch.train.state import state_to
    from dgmesh_torch.train.step import StepContext

    small = _small_cfg(Config)
    small.model.is_6dof = True
    st_c = build_shell_state(torch, small, 256, "cpu")
    scale_screw_heads(torch, st_c.nets)
    st_g = state_to(st_c, dev)
    ctx_g, ctx_c = StepContext(small, 64, 64, device=dev), StepContext(small, 64, 64, device="cpu")
    bg_, bc_ = view_batches(64, 64, 1, dev)[0], view_batches(64, 64, 1, "cpu")[0]
    og, _ = render_frame_with_aux(ctx_g, st_g, bg_, small.model.sh_degree)
    oc, _ = render_frame_with_aux(ctx_c, st_c, bc_, small.model.sh_degree)
    d_img = max(float((og[k].cpu() - oc[k]).abs().max()) for k in ("render", "mesh_image", "mask"))
    same = int(og["n_verts"]) == int(oc["n_verts"]) > 0
    log(f"# 6-DoF small view: card vs CPU max image diff {d_img:.3g} (tol {TOL_SMALL}); V "
        f"{int(og['n_verts'])}/{int(oc['n_verts'])} {'ok' if same and d_img <= TOL_SMALL else 'FAIL'}")
    if not (same and d_img <= TOL_SMALL):
        failures.append("6-DoF small view: card and CPU disagree")
    # the training step on both, held as phase 6 holds the float32 step
    small_train_check(torch, step, small, dev, failures, TOL_SMALL_GP, TOL_SMALL_HEAD,
                      TOL_SMALL_NET, " 6-DoF", 2,
                      prepare=lambda st: scale_screw_heads(torch, st.nets))
    # one fused full-width step
    fcfg = load_cfg()
    fcfg.tpu.mlp_bf16 = fcfg.tpu.mlp_fused = True
    fcfg.model.is_6dof = True
    ctx = StepContext(fcfg, IMG, IMG, device=dev)
    state = build_shell_state(torch, fcfg, N_GAUSS, dev)
    scale_screw_heads(torch, state.nets)
    batch = bench_batch(IMG, IMG, dev)
    flags = train_flags(step, fcfg.model.sh_degree)
    step.train_step(ctx, state, batch, flags)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    _, m = step.train_step(ctx, state, batch, flags)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters}
    bad = step_problems(torch, m) + [k for k, v in launches.items() if v < 1]
    log(f"# 6-DoF fused full-width step: {ms:.2f} ms; V {int(m['mesh_n_verts'])} F "
        f"{int(m['mesh_n_faces'])}; loss {float(m['loss']):.6g}; launches {launches} "
        f"{'ok' if not bad else 'FAIL: ' + ', '.join(map(str, bad))}")
    if bad:
        failures.append("6-DoF fused full-width step: " + ", ".join(map(str, bad)))


def check_tile0(torch, SK, MK, ca, cg, cga, geo_s, sa, sg, sgs, geo_m, sigma, errs,
                failures):
    """Phase 3t: kernels 1-4 on the tiles [T/2, T) alone with tile0 = T/2
    against those tiles of the whole launch (the same bits) and against
    their twins given tile0 (the tolerances of phase 3)."""
    def tail(x, h):
        return x[h:].contiguous()

    h = ca.shape[0] // 2
    full = SK.composite_tiles(ca, *geo_s, residuals=True)
    half = SK.composite_tiles(tail(ca, h), *geo_s, residuals=True, tile0=h)
    twin = SK.composite_tiles_ref(tail(ca, h), *geo_s, residuals=True, tile0=h)
    same = {"composite_tiles": all(same_bits(torch, x[h:], y) for x, y in zip(full, half))}
    e1 = max_err(half[:2], twin[:2])
    ok = {"composite_tiles": e1 <= TOL_COMPOSITE}
    d_full = SK.composite_bwd(ca, cg, cga, *geo_s, full[0], full[2])
    d_half = SK.composite_bwd(tail(ca, h), tail(cg, h), tail(cga, h), *geo_s, half[0], half[2],
                              tile0=h)
    same["composite_bwd"] = same_bits(torch, d_full[h:], d_half)
    e2, ok["composite_bwd"], _ = compare_bwd(
        torch, d_half, SK.composite_bwd_ref(tail(ca, h), tail(cg, h), tail(cga, h), *geo_s,
                                            rgb=half[0], S=half[2], tile0=h),
        COMPOSITE_GROUPS, ZERO_LANES["composite"], tail(ca, h)[..., 9] < 0.5)
    h = sa.shape[0] // 2
    full = MK.shade_tiles(sa, *geo_m, sigma, residuals=True)
    half = MK.shade_tiles(tail(sa, h), *geo_m, sigma, residuals=True, tile0=h)
    twin = MK.shade_tiles_ref(tail(sa, h), *geo_m, sigma, residuals=True, tile0=h)
    same["shade_tiles"] = all(same_bits(torch, x[h:], y) for x, y in zip(full, half))
    e3 = max_err((half[0], half[2]), (twin[0], twin[2]))
    ok["shade_tiles"] = (e3 <= TOL_SHADE and bool(torch.equal(half[1], twin[1]))
                         and bool(torch.equal(half[3], twin[3])))
    d_full = MK.shade_bwd(sa, sg, sgs, *geo_m, sigma, *full[4:])
    d_half = MK.shade_bwd(tail(sa, h), tail(sg, h), tail(sgs, h), *geo_m, sigma, *half[4:],
                          tile0=h)
    same["shade_bwd"] = same_bits(torch, d_full[h:], d_half)
    e4, ok["shade_bwd"], _ = compare_bwd(
        torch, d_half, MK.shade_bwd_ref(tail(sa, h), tail(sg, h), tail(sgs, h), *geo_m, sigma,
                                        tile0=h),
        SHADE_GROUPS, ZERO_LANES["shade"], tail(sa, h)[..., 9] < 0.5)
    for name, e in zip(("composite_tiles", "composite_bwd", "shade_tiles", "shade_bwd"),
                       (e1, e2, e3, e4)):
        errs[name].append(e)
        log(f"# kernels/tile0: {name} on tiles [{h if 'shade' in name else ca.shape[0] // 2}, "
            f"T) with tile0 = T/2: {'the same bits as' if same[name] else 'NOT'} the whole "
            f"launch's; vs the twin given tile0 {e:.3g} {'ok' if ok[name] else 'FAIL'}")
        if not (same[name] and ok[name]):
            failures.append(f"{name} with tile0 (phase 3t)")


def load_cfg(bench_values: bool = True):
    """configs/synthetic-quality-288.yaml through the port's config.  With
    ``bench_values``, bench.py's values for the two fields its state takes
    from Config()'s defaults instead of the YAML's (gaussian_ratio 1.5, not
    1.2; init_density_threshold 0.05, not 0.0), as bench.py measures it."""
    import argparse
    from dgmesh_torch.config import config_from_args
    cfg = config_from_args(argparse.Namespace(), CONFIG)
    if bench_values:
        cfg.model.gaussian_ratio = 1.5
        cfg.optimization.init_density_threshold = 0.05
    return cfg


def _small_cfg(Config):
    """The test fixture's miniature shapes (grid 32, 512 Gaussian slots, 64²)
    with its ROOMY caps, which hold the whole 256-point shell's mesh."""
    cfg = Config()
    cfg.model.is_blender = True
    cfg.model.grid_res = 32
    cfg.model.sh_degree = 1
    cfg.optimization.dpsr_sig = 2.0
    t = cfg.tpu
    t.max_gaussians = 512
    t.max_verts, t.max_faces = 16384, 32768
    t.max_gaussians_per_tile, t.max_dup = 64, 1 << 12
    t.max_faces_per_tile, t.max_face_dup = 1024, 1 << 16
    t.mr_cull_backface = True
    return cfg


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
