#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (brainfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build   - compile the CUDA kernels of brainfm_tpu_torch/csrc (nvcc,
               sm_90a, one process per source, all at once).
  2. kernel  - each kernel against its plain PyTorch version on the card, at
               the generator path's, the serving path's and the bench's
               generator stage's shapes, edge cases included
               (`kernel_cases`), and K3-K5 (csrc/groupnorm.cu) at the
               flagship's decoder pair and served tensor in bf16 and fp32
               (`gn_cases`); kernel (warm and cold L2),
               plain and library times (CUDA events) beside the byte bound.
               K1 linear at C=12 is also timed on 4 flagship deformation
               draws (seeds 0-3).
  3. slice_reference - a small item made on the GPU and replayed on the CPU
               from the same recorded draws (CPU = the plain versions), and a
               small model run on both.
  4. groupnorm_reference - a small UNet3D (f_maps 8, 4 levels) at fp64:
               loss and gradients on the card through K3-K5 and the pair
               conv against the CPU's plain versions, at 32^3 (the pair at
               every decoder level) and 33^3 (not at the last), and with
               `phase_upconv` off.
  5. slice   - the flagship item (cfgs brain_id + joint: 160^3 from a 192^3
               bank, S=4) through synth_item, the L6 f_maps-64 joint forward
               under bf16 autocast and apply_processors; launch counts of
               every kernel over that run.
  6. serve_reference - a small head file served by the small model on the
               GPU and on the CPU (prepare_image, evaluate_image with
               postprocess, get_deformed_atlas), compared.
  7. serve   - three procedural heads served whole at 220^3 by the L6
               f_maps-64 model (the slice's weights) in bf16 through
               Inferencer.evaluate_path, the deformed atlas on a 256^3
               atlas, one tiled pass; stage times per volume; launch counts
               over those steps.
  8. train_reference - a small model (f_maps 8, 3 levels, 32^3, S=4, fp32,
               TF32 off): one train step's losses and gradients on the GPU
               against the CPU from the same params and batch, the params
               after one SGD step, a batch with a NaN voxel that must leave
               the GPU state bitwise as it was, and a checkpoint saved and
               loaded back bitwise on the card.
  9. train   - the flagship training configuration (the slice's, bf16,
               AdamW with its warmup) through train/loop.py::train for one
               epoch of TRAIN_ITR iterations with validation and
               checkpoints, then TRAIN_TIMED timed iterations (item, step);
               every step's loss and skip flag, peak memory, launch counts
               over the phase.
 10. stream_reference - procedural subject files (write_subject_root) read
               through the codec into the datasets of synth/datasets.py on
               the GPU and on the CPU; one item per dataset with
               deform_one_hots, pathology forced on from the lesion pool
               and the surface task's inverse field, made on the GPU and
               replayed on the CPU from its recorded draws, compared; a
               small model on both.
 11. stream  - the training CLI (scripts/train.py::main) with the flagship
               configs on a data root of two datasets at 180^3 (HCP: T1,
               T2; ATLAS: T1 and a lesion pool): one epoch of STREAM_ITR
               iterations on the dataset stream, then --eval_only --resume
               on its checkpoint, then TRAIN_TIMED timed stream iterations
               (item, step); ingest seconds, peak memory, launch counts.
 12. pathology - items of the shape_id generator (160^3, dopri5,
               augment_pathology) with pathology forced on, from random
               shapes and from a lesion file, timed by part (shape or
               lesion warp, advection with its adaptive steps, the rest);
               then the flagship model trains a step on each.
 13. variants_reference - small models of the variants (the age head,
               the sep decoders, the flagship with the frozen critic; f_maps
               8, 3 levels, 32^3): one step's losses (fp32, fp64) and
               gradients (fp64) on the GPU against the CPU.
 14. variants - each variant at full width through train() (VARIANT_ITR
               steps, validation, checkpoints), then VARIANT_TIMED timed
               iterations (item, step): joint_age.yaml with brain_id_age.yaml
               (L6, S=4), sep.yaml (L5) on twostage.yaml's generator (S=2,
               pathology), the flagship with losses.implicit_pathol and a
               random-init critic; peak memory and launch counts per
               variant, each at its memory setting (VARIANT_FIT).
 15. twostage_reference - a small two-stage pair's step (losses, fp64
               gradients) and TwoStageInferencer's outputs, GPU against CPU.
 16. twostage - the training CLI on twostage.yaml with its generator over
               the stream phase's data root (two UNet3D f_maps-64 L5,
               160^3, S=2, bf16; TWOSTAGE_ITR iterations), TRAIN_TIMED
               timed stream iterations, then TwoStageInferencer on the run's
               checkpoint serving one procedural head at 220^3 in bf16.
 17. evaluate_reference - the evaluation CLI (scripts/test.py) with a small
               model on two procedural 48^3 heads with label-map and MNI-x
               files, on the GPU and with --device cpu: two --models,
               --spacings native 2,2,3 with --add_bf, hemisphere masking,
               the deformed atlas, then --pred_glob scoring (is_seg dice,
               recon psnr, ssim), compared file by file; MS-SSIM at 176^3
               (its five levels need it) GPU against CPU; then a small
               train() with vis_itr=1 (montage, feature strips, NIfTI
               dumps) against the same run with vis_itr=0.
 18. evaluate - the evaluation CLI on the slice phase's L6 f_maps-64
               weights (a .pth) over EVAL_HEADS procedural head(s) at the
               220^3 window in bf16: --spacings native 1.5,1.5,5 --add_bf,
               hemisphere masking, the 256^3 procedural atlas; then
               --pred_glob scoring of out_label (dice over the 33
               evaluation labels, K2) and out_T1 (psnr, ssim, ms_ssim
               against the head; ms_ssim against the bias-field setup's
               out_T1, which must not be 0); stage times per volume and
               setup, scoring time per metric, peak memory, launch counts
               of the serving and of the scoring.
 19. orbax   - the JAX package's orbax checkpoints committed as fixtures
               (tests/fixtures/torch_orbax, JAX TrainStates): the small
               joint model and the two-stage pair (f_maps 8, 3 levels)
               served on the card from their ckp/ roots within MODEL_TOL
               of the JAX inferencers' outputs (labels ORBAX_LABEL_AGREE),
               the small state through load_checkpoint bitwise and one
               train step, the decoder's MB/s on its chunks; the flagship
               zero state loaded strictly into the flagship Inferencer,
               one 220^3 volume served in bf16 (K2 in postprocess), the
               params-only and full-state reads timed.
 20. numerics_reference - the interpol family (grid_pull, grid_push,
               grid_grad at 64^3, orders 1 and 3, bounds zero and dct2;
               resize_spline, restrict_spline), synth_intensities (K2 f32
               against its plain version, with injected noise) and
               odeint_adjoint (rk4 values and gradients), GPU against CPU
               at fp64; then device times of grid_pull and grid_push at
               160^3 and synth_intensities at 192^3.
 21. multigpu_reference - MGPU_WORLD ranks, each a process of this script
               on the one card (cuda:0), in a gloo process group (NCCL
               refuses two ranks on one device; the line names the
               backend): the L6 f_maps-16 joint model's fp64 step on
               48^3 split in two D slabs against the same step unsharded
               (loss 1e-12, gradient rel-L2 1e-9, TF32 off), launching K4
               once per GroupNorm and K3 and K5; one flagship
               item per rank by per-rank synthesis, bitwise this
               process's serial batch of the same per-item generators,
               with K1 and K2 launches on each rank; the slice's L6
               f_maps-64 weights serving a SERVE_WIN head over space=2 in
               bf16 (timed, each rank's peak memory, beside one rank
               alone and that rank's noise floor; K3 and K4 on each rank),
               then a MGPU_EXACT_WIN head at fp64 against one rank alone
               (MODEL_TOL, SEG_AGREE); a bf16 slab GroupNorm of the served
               tensor over the two ranks against the unsharded one (one
               bf16 ulp or GN_BF16_ATOL), K3 on the slab against its plain
               version.
 22. multigpu - the training CLI with the flagship configs on the stream
               phase's data root, launched as torchrun launches one rank
               (RANK=0 WORLD_SIZE=1) with --mesh 1 --fsdp on NCCL:
               MULTIGPU_WARM iterations, then MULTIGPU_TIMED timed ones
               (per-rank item, step), peak memory and launches beside the
               stream phase's figures.
 23. roofline - brainfm_tpu_torch/scripts/roofline.py: the card's delivered
               bf16 matmul and conv3d rates, elementwise and GroupNorm +
               LeakyReLU bytes/s at 220^3 x 64, and the FLOP counts of the
               220^3 forward and the bench's train steps; a rate above 105 %
               of the data sheet's peak fails.
 24. bench   - python -m brainfm_tpu_torch.bench at full size in a child
               process: contract lines only on its stdout, every key of
               the root bench's summary, min <= median <= max for each,
               no failed stage, K1 and K2 launched per generator item;
               its whole-volume and generator clocks beside the serve
               phase's forward and the slice's item.
 25. entry   - brainfm_tpu_torch/entry.py, the driver contract: entry()'s
               fn on the card (the flagship joint model, every parameter
               zero, a 160^3 zero volume, bf16) gives T1 and segmentation
               of the JAX shapes, finite and constant, equal to what the
               same fn gives on the CPU at 32^3; fn timed (median of
               ENTRY_TIMED calls after ENTRY_WARM, each between
               synchronizes) with its peak memory; then
               dryrun_multichip(1): one NCCL rank in a process of its own
               (data-parallel, FSDP2 and per-rank synthesis steps), finite
               losses, the FSDP loss within 1e-5 of the data-parallel one,
               every kernel launched on the rank (K1 and K2 by its
               synthesis, K3-K5 by its steps).
 26. profile_train - brainfm_tpu_torch/scripts/profile_train.py at 128^3
               L6 f_maps 64: each remat mode (off, full, save_convs) timed
               over 3 steps after one, then each counted (--ledger: FLOPs
               with the recompute, bytes of every aten operation); `off`
               may run out of memory (its FAILED line is kept, as the root
               script keeps it), any other failure fails the phase.
Then the elapsed seconds per phase, the `kernels` summary line (launches on
every path), the card's name and power limit, and the result line. Exits
non-zero, printing no result, when a phase fails or no GPU is present.
With arguments the script is one of the processes it starts itself (a
multigpu_reference rank, or the multigpu phase's CLI run).
"""

from __future__ import annotations

import ast
import contextlib
import copy
import gc
import gzip
import io
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from brainfm_tpu_torch import kernels
from brainfm_tpu_torch.config import load_config
from brainfm_tpu_torch.device import card_label
from brainfm_tpu_torch.infer import (Inferencer, TwoStageInferencer,
                                     get_deformed_atlas, prepare_image,
                                     tile_plan)
from brainfm_tpu_torch.infer.prepare import acquisition_grid
from brainfm_tpu_torch.models import (apply_processors, build_critic_from_cfg,
                                      build_inpaint_model, build_model,
                                      process_args)
from brainfm_tpu_torch.models.criterion import make_criterion, weighted_total
from brainfm_tpu_torch.models.unet3d import UNet3D
from brainfm_tpu_torch.models.evaluator import (EVAL_LABELS, index_lut,
                                                ms_ssim_normalized)
from brainfm_tpu_torch.ops.ode import odeint_adjoint
from brainfm_tpu_torch.ops.pushpull import grid_grad, grid_pull, grid_push
from brainfm_tpu_torch.ops.resize import resize_spline, restrict_spline
from brainfm_tpu_torch.ops.interp import nearest3d, trilinear3d
from brainfm_tpu_torch.ops import groupnorm
from brainfm_tpu_torch.ops.lut import lut_apply, lut_apply_plain
from brainfm_tpu_torch.ops.warp import warp_labels, warp_volume
from brainfm_tpu_torch.synth import (Draws, LABELS_EXTRACEREBRAL, SubjectBank,
                                     SynthStatic, build_lut, deform_grid,
                                     knobs_from_cfg, random_affine,
                                     random_nonlinear_field, sample_setup,
                                     synth_item)
from brainfm_tpu_torch.scripts import test as eval_cli
from brainfm_tpu_torch.scripts import train as train_script
from brainfm_tpu_torch.synth.batch import stack_items
from brainfm_tpu_torch.synth.datasets import DATASET_SETUPS, build_datasets
from brainfm_tpu_torch.synth.gmm import synth_intensities
from brainfm_tpu_torch.train import (build_optimizer, build_schedules,
                                     load_checkpoint, make_batch,
                                     make_train_step,
                                     make_twostage_train_step,
                                     save_checkpoint, train)
from brainfm_tpu_torch.train.step import TrainState, batch_losses
from brainfm_tpu_torch.utils import profiling
from brainfm_tpu_torch.utils.nifti import load_nifti, save_nifti

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
SPIN_CYCLES = 35_000_000    # about 20 ms at the H100's 1.755 GHz boost clock
L2_FLUSH_BYTES = 256 << 20  # 5x the H100's 50 MB L2
FLT_MIN = torch.finfo(torch.float32).tiny
BANK = (192, 192, 192)
# K1 linear: fp32 in the plain version's operation order, built without
# multiply-add contraction, so any difference is a fault; 1e-5 on O(1)
# values leaves room for nothing but last-bit rounding
LINEAR_TOL = 1e-5
# K3 (chan_sums) sums millions of elements a row in fp32 in another order
# than torch.sum: max error relative to the largest |sum|; K4 and K5 round
# like their plain versions, operation for operation, and must be equal
GN_SUMS_RTOL = 1e-5
# a bf16 GroupNorm against another whose fp32 statistics differ in their
# last bits (another summation order): within one bf16 ulp, or this much
# where the fp32 value near 0 rounds to neighbours finer than that
GN_BF16_ATOL = 1e-5
# K3-K5 at the flagship's shapes: the decoder's level-0 pair (f_maps and
# 2 f_maps channels) and the served tensor, in these dtypes, each timing
# over GN_REPS calls (the library's GroupNorm takes tens of ms here)
GN_F_MAPS = 64
GN_DTYPES = (("bf16", torch.bfloat16), ("f32", torch.float32))
GN_REPS = 5
# the groupnorm_reference phase: fp64 on the card against the CPU, the
# whole gradient's relative L2 (cuDNN and K3 sum in other orders)
GN_REF_SIZES = (32, 33)
GN_REF_TOL = 1e-10
# CPU replay of a GPU item: cuBLAS/cuDNN and the CPU sum fp32 products in
# other orders; values are normalized to [0, 1] or O(1) targets
REPLAY_TOL = 1e-3
# fp32 model on the GPU and the CPU, relative to the largest |output|: cuDNN
# picks its own fp32 algorithms, and the unit-vector normalization of the
# last feature divides by norms that are small at some voxels, magnifying
# that rounding
MODEL_TOL = 5e-3
SEG_AGREE = 0.9999   # fp32 coordinate ties may flip a label at a boundary
# serving: whole volumes cropped to 220^3 at 1 mm; the inputs are written
# with 1.2 x 1.0 x 1.5 mm voxels (every axis 240 mm) and a non-RAS affine
SERVE_WIN = (220, 220, 220)
SERVE_SHAPE = (200, 240, 160)
SERVE_VOXEL_MM = (1.2, 1.0, 1.5)
# the inputs at 1 mm, where prepare_image's acquisition resample reads them
# (after the resize to 1 mm, before the crop to the window)
SERVE_MM_SHAPE = tuple(int(v) for v in np.round(
    np.multiply(SERVE_SHAPE, SERVE_VOXEL_MM)))
# voxel axis 0 along +A, axis 1 along -S, axis 2 along -R
SERVE_AXES = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], np.float64)
ATLAS_SHAPE = (256, 256, 256)   # 1 mm, as the reference's gca.mgz

# training: the flagship phase's iterations, and its memory settings, the
# first in the order (save_convs, accum 1), (save_convs, accum 2),
# (full, accum 2) that leaves 8 GB of the card free
# (scripts/profile_torch_slice.py `fit_train`)
TRAIN_ITR = 5
TRAIN_TIMED = 3
TRAIN_REMAT = "save_convs"
TRAIN_ACCUM = 1
# train_reference (check_train_reference says why each precision): losses
# to 1e-4 relative; each gradient tensor and the SGD update, at fp64, to
# 1e-3 relative L2; at fp32 the GPU's gradients no further from the fp64
# ones than 4x the CPU's fp32 gradients are
LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
FP32_GRAD_FACTOR = 4.0
# the stream phases: procedural subjects of this extent in the data root,
# and the CLI's iterations; the pathology phase's items (random shape,
# lesion file, alternately)
STREAM_EXTENT = (180, 180, 180)
STREAM_ITR = 4
PATHOLOGY_ITEMS = 4
# the model variants and the two-stage pair: each one's memory setting
# (remat, grad_accum_samples), the first of the order of
# scripts/profile_torch_slice.py --variants (`fit_train`) that leaves 8 GB
# of the card free; the iterations through train() and the CLI
VARIANTS = ("joint_age", "sep", "critic")
VARIANT_FIT = {"joint_age": ("save_convs", 1), "sep": ("save_convs", 1),
               "critic": ("save_convs", 2)}
TWOSTAGE_FIT = ("save_convs", 1)
VARIANT_ITR = 2
VARIANT_TIMED = 2
TWOSTAGE_ITR = 4

# evaluation: the acquisition spacing of the evaluate phase's low-
# resolution setup, and its number of heads: each served volume writes
# about 3 GB of .nii.gz (15 outputs at 220^3, the segmentation's 56
# channels among them) in 4 setups, about 20 s a volume, so one head keeps
# the phase near 120 s
EVAL_SPACING = (1.5, 1.5, 5.0)
EVAL_HEADS = 1
# the evaluation CLI's mean scores, GPU against CPU: relative to the
# score; a score nearer 0 than SCORE_FLOOR (a random model's SSIM lies near
# 0, where the fp32 sums' rounding does not shrink with it) is held to
# SCORE_TOL * SCORE_FLOOR absolute
SCORE_TOL = 1e-4
SCORE_FLOOR = 1e-2
# the deformed atlas of evaluate_reference: each device renders from its
# own predicted coordinates (x100, MODEL_TOL apart), so voxels where a
# label flips change wholesale; this share must lie within REPLAY_TOL
ATLAS_AGREE = 0.999
# train(vis_itr=1) against vis_itr=0 on the card: cuDNN's backward is not
# bitwise repeatable between two runs, the losses are held to this
VIS_LOSS_TOL = 1e-6
# the interpol family, GPU against CPU at fp64: sums in other orders
NUMERICS_TOL = 1e-10
# multigpu_reference: two ranks share the one card, so their process group
# is gloo (NCCL refuses two ranks on one device); the exchanges are built on
# all_gather and all_reduce, which gloo stages through the host
MGPU_BACKEND = "gloo"
MGPU_WORLD = 2
MGPU_SIZE = (48, 48, 48)     # levels 48, 24, 12 on slabs; 6, 3, 1 whole
MGPU_F_MAPS = 16
MGPU_LOSS_TOL = 1e-12
MGPU_GRAD_TOL = 1e-9         # rel-L2 of the whole fp64 gradient
# each tensor alone: the first GroupNorm weight's gradient is a sum that
# cancels to ~1e-4 of its terms, so fp64 summation order moves it ~1e-9
MGPU_TENSOR_TOL = 1e-7
MGPU_TIMEOUT = 900
# the served head's gate: fp64 at this window (5 of the 6 levels on
# slabs); bf16 at SERVE_WIN is timed and compared, not gated: the random
# L6 model carries a 2^-20 nudge of its input to outputs as far apart as
# the sharded and the single bf16 runs are (see _mgpu_serve)
MGPU_EXACT_WIN = (128, 128, 128)
# multigpu: the training CLI with --mesh 1 --fsdp on NCCL, one rank
MULTIGPU_WARM = 2
MULTIGPU_TIMED = 2

# roofline: no delivered rate may pass the data sheet's peak by more
ROOFLINE_MARGIN = 1.05
# entry: fn's timed calls; the dry run's limit and the FSDP loss's
ENTRY_WARM = 2
ENTRY_TIMED = 5
ENTRY_CPU_SIZE = (32, 32, 32)   # the smallest crop of the L6 model
ENTRY_TIMEOUT = 600
# profile_train: the root script's sweep, and the mode that may run out of
# memory at 128^3
PROFILE_TRAIN_ARGS = ("--modes", "off,full,save_convs", "--reps", "3")
PROFILE_TRAIN_MAY_OOM = "off"
# orbax: the JAX package's checkpoints committed as fixtures (written by
# tests/_torch_orbax_fixtures.py): the small joint model and the two-stage
# pair at f_maps 8, 3 levels, unit_feat off, served on a 32^3 input from
# default_rng(0); the flagship architecture with zero weights and moments
ORBAX_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_orbax")
ORBAX_SIZE = (32, 32, 32)
ORBAX_READS = 5
# the decoder's timed work (decoder_rates): a batch of fixture (a)'s chunks
# repeated to this many decoded bytes, and its largest chunk to this many
DECODE_BATCH_BYTES = 256 << 20
DECODE_CHUNK_BYTES = 64 << 20
# fp32 softmaxes of a random model on a noise input that differ in the last
# bits flip near-tied argmaxes (the serving tests' LABEL_AGREE_F32)
ORBAX_LABEL_AGREE = 0.999
# bench: the child process's limit, and the summary keys of the root
# bench.py (its STAGES), which the port's bench must all print
BENCH_TIMEOUT = 900
BENCH_SUMMARY = "# BENCH SUMMARY "
JAX_SUMMARY_KEYS = ("primary_compile_s", "whole_volume_ms",
                    "primary_vols_per_sec", "vs_baseline", "train_compile_s",
                    "train_step_ms", "generator_compile_s",
                    "generator_ms_per_item", "generator_pathol_compile_s",
                    "generator_pathol_ms_per_item", "tiled_compile_s",
                    "tiled_fp32_ms", "cache_cold")

SOURCES = {"warp_linear_f32": "brainfm_tpu_torch/csrc/warp.cu",
           "warp_nearest_i32": "brainfm_tpu_torch/csrc/warp.cu",
           "lut_gather_i32": "brainfm_tpu_torch/csrc/lut.cu",
           "lut_gather_f32": "brainfm_tpu_torch/csrc/lut.cu",
           "chan_sums": "brainfm_tpu_torch/csrc/groupnorm.cu",
           "chan_affine": "brainfm_tpu_torch/csrc/groupnorm.cu",
           "chan_affine3": "brainfm_tpu_torch/csrc/groupnorm.cu"}
REPLACES = {"warp_linear_f32": "brainfm_tpu/ops/pallas_warp_blocks.py:300",
            "warp_nearest_i32": "brainfm_tpu/ops/pallas_warp_blocks.py:300",
            "lut_gather_i32": "brainfm_tpu/ops/pallas_lut.py:53",
            "lut_gather_f32": "brainfm_tpu/ops/pallas_lut.py:53",
            # K3-K5 port jax.custom_vjp code, not Pallas: the sums of
            # _fgn_stats, the apply of _fgn_fwd, the combine of _fgn_bwd
            "chan_sums": "brainfm_tpu/models/unet3d.py:304",
            "chan_affine": "brainfm_tpu/models/unet3d.py:341",
            "chan_affine3": "brainfm_tpu/models/unet3d.py:383"}
# K3 and K4 run in every forward of the model, K5 only in a backward pass
GN_FORWARD = ("chan_sums", "chan_affine")
GN_BACKWARD = ("chan_affine3",)
GN_KERNELS = GN_FORWARD + GN_BACKWARD


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_power() -> str:
    return card_label("cuda")


def time_ms(fn, reps=20, warmup=3, cold=False) -> float:
    """Device time of one call. Warm: CUDA events around `reps` calls queued
    behind a 20 ms spin kernel, so the host has enqueued them all before
    the first starts and host overhead between calls is not timed; inputs
    under the L2's 50 MB stay cached from one call to the next. Cold: each
    call follows a read of a buffer 5x the L2 and has its own pair of
    events, so it finds its inputs in DRAM, as a caller that has touched
    other data since would; the mean over the calls."""
    for _ in range(warmup):
        fn()
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        for start, end in events:
            flush.sum()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flagship_cfg():
    return train_script.train_config("brain_id", "joint")


def small_model_cfg():
    cfg = flagship_cfg()
    cfg.f_maps, cfg.num_levels, cfg.task_f_maps = 8, 5, [8]
    return cfg


def path_grid(scfg, dev, seed, extent=160.0):
    """Source coordinates of one deformation of scfg.size into a subject
    of `extent` (the flagship's: 160^3 into a 160^3 subject of the 192^3
    bank)."""
    d = Draws(torch.Generator(dev).manual_seed(seed), dev)
    setup = sample_setup(d.sub("setup"), scfg)
    shp = torch.tensor([float(extent)] * 3, device=dev)
    sfd, A, c2 = random_affine(d.sub("affine"), scfg, shp)
    F_, _ = random_nonlinear_field(d.sub("field"), scfg, setup)
    return [c.contiguous() for c in deform_grid(scfg, shp, A, c2, F_)]


def with_edges(grid, D):
    """Coordinates exactly on 0 and D-1, just inside and just outside (the
    smallest denormal, FLT_MIN and the largest denormal among them), on
    each axis in turn, at the head of the flattened grid."""
    one = torch.tensor(1.0)
    hi = torch.tensor(float(D - 1))
    tiny = torch.tensor(FLT_MIN)
    e = torch.stack([torch.tensor(0.0), hi, torch.nextafter(0 * one, one),
                     tiny, torch.nextafter(tiny, 0 * one),
                     torch.nextafter(hi, hi + 1), torch.nextafter(hi, 0 * one),
                     -torch.nextafter(0 * one, one), torch.tensor(0.5),
                     hi - 0.5, torch.tensor(-3.0), hi + 3.0])
    out = [c.clone() for c in grid]
    n = e.numel()
    for a in range(3):
        out[a].view(-1)[a * n:(a + 1) * n] = e.to(out[a].device)
    return out


def with_ties(grid):
    """Coordinates on .5 ties at the head of the flattened grid."""
    out = [c.clone() for c in grid]
    for a in range(3):
        ties = torch.arange(64, device=out[a].device, dtype=torch.float32)
        out[a].view(-1)[:64] = ties + 0.5
    return out


def in_bounds(ii, jj, kk, shape):
    """K1 linear's in-bounds predicate (ops/interp.py trilinear3d)."""
    D, H, W = shape
    return ((ii >= FLT_MIN) & (jj >= FLT_MIN) & (kk >= FLT_MIN)
            & (ii <= D - 1) & (jj <= H - 1) & (kk <= W - 1))


def touched_source_voxels(shape, grid, mode="linear") -> int:
    """Distinct source voxels of a (D, H, W) volume that a K1 warp at
    `grid` reads: the 8 corners of each in-bounds output voxel (linear), or
    the rounded and clipped voxel of each output voxel (nearest). Counted
    on the grid's device, as a boolean scatter over the source."""
    D, H, W = shape
    ii, jj, kk = (c.reshape(-1) for c in grid)
    hit = torch.zeros(D * H * W, dtype=torch.bool, device=ii.device)
    if mode == "nearest":
        x, y, z = (torch.round(c).long().clamp(0, n - 1)
                   for c, n in zip((ii, jj, kk), shape))
        hit[(x * H + y) * W + z] = True
        return int(hit.sum())
    ok = in_bounds(ii, jj, kk, shape)
    fx, fy, fz = (torch.floor(c[ok]).long() for c in (ii, jj, kk))
    for dx in (0, 1):
        x = (fx + dx).clamp(max=D - 1)
        for dy in (0, 1):
            y = (fy + dy).clamp(max=H - 1)
            for dz in (0, 1):
                z = (fz + dz).clamp(max=W - 1)
                hit[(x * H + y) * W + z] = True
    return int(hit.sum())


class Case(NamedTuple):
    name: str
    fn: str                 # the C function, a key of kernels.LAUNCHES
    kernel: Callable        # the wrapper, on the card
    plain: Callable         # its plain PyTorch version, same inputs
    library: Callable | None   # one PyTorch call of the same function
    nbytes: int             # the bound: bytes the function must move
    exact: bool
    rtol: float = 0.0       # > 0: max error relative to the largest |want|
    reps: int = 20          # calls per timing
    info: dict | None = None   # shape, dtype, library call: for the record


def linear_bytes(shape, grid, C) -> int:
    """K1 linear's least traffic in fp32: the touched source voxels, three
    coordinates and C outputs per output voxel, and the C defaults."""
    n = grid[0].numel()
    return 4 * (touched_source_voxels(shape, grid) * C + 3 * n + C + n * C)


def run_case(case):
    """Run a case's kernel and plain version, compare, time all three."""
    got = case.kernel()
    want = case.plain()
    torch.cuda.synchronize()
    t = torch.promote_types(want.dtype, torch.float32)
    err = float((got.to(t) - want.to(t)).abs().max())
    rel = None
    if case.exact:
        ok = err == 0
    elif case.rtol:
        rel = err / max(float(want.to(t).abs().max()), 1e-30)
        ok = rel <= case.rtol
    else:
        ok = err <= LINEAR_TOL
    del got, want
    n = case.reps
    rec = {"phase": "kernel", "case": case.name, **(case.info or {}),
           "max_abs_err": err,
           **({} if rel is None else {"max_rel_err": rel}),
           "ms": time_ms(case.kernel, n),
           "ms_cold": time_ms(case.kernel, n, cold=True),
           "plain_ms": time_ms(case.plain, n),
           "library_ms": (None if case.library is None
                          else time_ms(case.library, n)),
           "bound_ms": case.nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    emit(rec)
    if not ok:
        raise AssertionError(f"{case.name}: kernel disagrees with its plain "
                             f"version, max abs err {err}")
    return rec


def grid_sample_yardstick(src, grid, mode, default=None):
    """One torch.nn.functional.grid_sample call on the same source and
    coordinates (align_corners=True maps -1..1 onto voxel 0..n-1), masked
    to `default` out of bounds in linear mode."""
    D, H, W = src.shape[:3]
    vol = (src[..., None] if src.dim() == 3 else src).permute(3, 0, 1, 2)
    vol = vol[None].float().contiguous()
    ii, jj, kk = grid
    g = torch.stack([kk / (W - 1) * 2 - 1, jj / (H - 1) * 2 - 1,
                     ii / (D - 1) * 2 - 1], dim=-1)[None]
    if default is None:
        return lambda: F.grid_sample(vol, g, mode=mode, padding_mode="border",
                                     align_corners=True)
    ok = in_bounds(ii, jj, kk, (D, H, W))[None, None]
    dflt = torch.as_tensor(default, dtype=torch.float32,
                           device=src.device).reshape(1, -1, 1, 1, 1)
    return lambda: torch.where(ok, F.grid_sample(
        vol, g, mode=mode, padding_mode="border", align_corners=True), dflt)


def kernel_cases(scfg, dev) -> list:
    """Every kernel case at the generator path's shapes, on seed-0 inputs
    with edge coordinates, ties and out-of-range indices among them."""
    g = torch.Generator(dev).manual_seed(0)
    grid = path_grid(scfg, dev, seed=0)
    cases = []

    # K1 linear: the fused target wall (C=12, per-channel defaults) and the
    # real-image warp (C=1)
    egrid = with_edges(grid, BANK[0])
    for C in (12, 1):
        shape = BANK + ((C,) if C > 1 else ())
        src = torch.randn(shape, generator=g, device=dev)
        dflt = (torch.randn(C, generator=g, device=dev) if C > 1
                else torch.zeros((), device=dev))
        cases.append(Case(
            f"warp_linear_f32 C={C}", "warp_linear_f32",
            lambda s=src, d=dflt: warp_volume(s, egrid, default=d),
            lambda s=src, d=dflt: trilinear3d(s, *egrid, d),
            grid_sample_yardstick(src, egrid, "bilinear", dflt),
            linear_bytes(BANK, egrid, C), exact=False))

    # the stream and pathology paths: the target wall with the pathology
    # keep channels (12 + S = 16 at S=4), the lesion file (C=1, a lesion
    # probability), the one-hot segmentation of deform_one_hots (C=56) and
    # the SVF's self-composition of the surface task (C=3, cfg.size into
    # cfg.size at the identity grid plus the field)
    src16 = torch.randn(BANK + (16,), generator=g, device=dev)
    d16 = torch.randn(16, generator=g, device=dev)
    lesion = torch.from_numpy(lesion_blob(BANK, 0)).to(dev)
    onehot = F.one_hot(torch.randint(0, 56, BANK, generator=g, device=dev),
                       56).float()
    size = tuple(scfg.size)
    svf = torch.randn(size + (3,), generator=g, device=dev) * (4.0 / 256)
    ax = torch.meshgrid(*[torch.arange(n, dtype=torch.float32, device=dev)
                          for n in size], indexing="ij")
    sgrid = [(ax[a] + svf[..., a]).contiguous() for a in range(3)]
    zero = torch.zeros((), device=dev)
    for name, src, sg, shape, dflt in (
            ("C=16 wall", src16, egrid, BANK, d16),
            ("C=1 lesion", lesion, egrid, BANK, zero),
            ("C=56 one-hot", onehot, egrid, BANK, zero),
            ("C=3 svf", svf, sgrid, size, zero)):
        C = 1 if src.dim() == 3 else src.shape[-1]
        cases.append(Case(
            f"warp_linear_f32 {name}", "warp_linear_f32",
            lambda s=src, gr=sg, d=dflt: warp_volume(s, gr, default=d),
            lambda s=src, gr=sg, d=dflt: trilinear3d(s, *gr, d),
            grid_sample_yardstick(src, sg, "bilinear", dflt),
            linear_bytes(shape, sg, C), exact=False))

    # K1 nearest: compact labels, with .5 ties
    labels = torch.randint(0, 56, BANK, generator=g, device=dev,
                           dtype=torch.int32)
    tgrid = with_ties(grid)
    n_out = grid[0].numel()
    cases.append(Case(
        "warp_nearest_i32", "warp_nearest_i32",
        lambda: warp_labels(labels, tgrid),
        lambda: nearest3d(labels, *tgrid),
        grid_sample_yardstick(labels, tgrid, "nearest"),
        4 * (touched_source_voxels(BANK, tgrid, "nearest") + 3 * n_out
             + n_out), exact=True))

    # K2: label compaction (10000,) i32 over 192^3, vflip (56,) i32 over
    # 160^3, GMM (256, 8) f32 over 192^3; indices -1 and >= K included
    def lut_case(name, table, idx_shape, idx=None):
        K = table.shape[0]
        C = 1 if table.dim() == 1 else table.shape[1]
        if idx is None:
            idx = torch.randint(-1, K + 2, idx_shape, generator=g,
                                device=dev, dtype=torch.int32)
        t2 = table if table.dim() == 2 else table[:, None]
        # the library call takes the path's in-range indices (the port
        # clamps them before the lookup, synth/engine.py)
        idc = idx.clamp(0, K - 1)
        n = idx.numel()
        size = table.element_size()
        return Case(name, f"lut_gather_{'i32' if C == 1 else 'f32'}",
                    lambda: lut_apply(table, idx),
                    lambda: lut_apply_plain(table, idx),
                    lambda: F.embedding(idc, t2),
                    size * K * C + 4 * n + size * n * C,
                    exact=table.dtype == torch.int32)

    lut = torch.from_numpy(build_lut(LABELS_EXTRACEREBRAL)).to(dev)
    cases.append(lut_case("lut_gather_i32 K=10000", lut, BANK))
    cases.append(lut_case("lut_gather_i32 K=56",
                          torch.arange(56, dtype=torch.int32,
                                       device=dev).flip(0),
                          tuple(scfg.size)))
    gmm = torch.rand((256, 8), generator=g, device=dev) * 200
    cases.append(lut_case("lut_gather_f32 K=256 C=8", gmm, BANK))

    # serving: the deformed atlas (K1 C=1, a 1 mm atlas on an affine grid
    # of the served volume, edges included) and the label map (K2, the
    # (56,) label table over the int64 argmax of 56 channels, cast)
    atlas = torch.rand(ATLAS_SHAPE, generator=g, device=dev)
    agrid = with_edges(atlas_grid(dev), ATLAS_SHAPE[0])
    cases.append(Case(
        "warp_linear_f32 C=1 atlas", "warp_linear_f32",
        lambda: warp_volume(atlas, agrid, default=0.0),
        lambda: trilinear3d(atlas, *agrid, 0.0),
        grid_sample_yardstick(atlas, agrid, "bilinear", zero),
        linear_bytes(ATLAS_SHAPE, agrid, 1), exact=False))
    logits = torch.randn((1, *SERVE_WIN, 56), generator=g, device=dev)
    amax = logits.argmax(-1).to(torch.int32)
    del logits
    table = torch.tensor(LABELS_EXTRACEREBRAL, dtype=torch.int32, device=dev)
    cases.append(lut_case("lut_gather_i32 K=56 labels", table, None, amax))

    # evaluation: the acquisition resample of the 1.5,1.5,5 setup (K1 C=1
    # from the head at 1 mm, 240^3, onto its 160x160x48 grid) and the
    # label one-hot's (10000,) lookup over a 220^3 label map; numerics:
    # synth_intensities' (256, 2) [mus, sigmas] lookup over the 192^3
    # subject frame
    vol = torch.rand(SERVE_MM_SHAPE, generator=g, device=dev)
    qgrid, _ = acquisition_grid(SERVE_MM_SHAPE, EVAL_SPACING, dev)
    cases.append(Case(
        "warp_linear_f32 C=1 acquisition", "warp_linear_f32",
        lambda: warp_volume(vol, qgrid, default=0.0),
        lambda: trilinear3d(vol, *qgrid, 0.0),
        grid_sample_yardstick(vol, qgrid, "bilinear", zero),
        linear_bytes(SERVE_MM_SHAPE, qgrid, 1), exact=False))
    cases.append(lut_case("lut_gather_i32 K=10000 onehot",
                          index_lut(EVAL_LABELS, dev), SERVE_WIN))
    cases.append(lut_case("lut_gather_f32 K=256 C=2 intensities",
                          torch.rand((256, 2), generator=g, device=dev) * 200,
                          BANK))

    # the bench's generator stage (S=2): its wall of T1, 4 distance, 3
    # registration and 2 synthetic channels, per-channel defaults (C=10
    # takes the one-channel route: 10 % 4 != 0), and the (256, 2S) lookup
    # of its contrasts
    src10 = torch.randn(BANK + (10,), generator=g, device=dev)
    d10 = torch.randn(10, generator=g, device=dev)
    cases.append(Case(
        "warp_linear_f32 C=10 wall", "warp_linear_f32",
        lambda: warp_volume(src10, egrid, default=d10),
        lambda: trilinear3d(src10, *egrid, d10),
        grid_sample_yardstick(src10, egrid, "bilinear", d10),
        linear_bytes(BANK, egrid, 10), exact=False))
    cases.append(lut_case("lut_gather_f32 K=256 C=4",
                          torch.rand((256, 4), generator=g, device=dev) * 200,
                          BANK))

    # the driver contract's dry run (entry.py, S=2): a 16^3 item from a
    # 20^3 subject in a 24^3 bank, the same wall and lookups at that size
    from brainfm_tpu_torch import entry as port_entry

    dcfg = process_args(port_entry.synth_cfg())
    dscfg = SynthStatic.from_cfg(dcfg)
    dbank = (24, 24, 24)
    dgrid = path_grid(dscfg, dev, seed=0, extent=20.0)
    degrid = with_edges(dgrid, dbank[0])
    dsrc = torch.randn(dbank + (10,), generator=g, device=dev)
    dd = torch.randn(10, generator=g, device=dev)
    cases.append(Case(
        "warp_linear_f32 C=10 dry run", "warp_linear_f32",
        lambda: warp_volume(dsrc, degrid, default=dd),
        lambda: trilinear3d(dsrc, *degrid, dd),
        grid_sample_yardstick(dsrc, degrid, "bilinear", dd),
        linear_bytes(dbank, degrid, 10), exact=False))
    dlabels = torch.randint(0, 56, dbank, generator=g, device=dev,
                            dtype=torch.int32)
    dtgrid = with_ties(dgrid)
    dn = dgrid[0].numel()
    cases.append(Case(
        "warp_nearest_i32 dry run", "warp_nearest_i32",
        lambda: warp_labels(dlabels, dtgrid),
        lambda: nearest3d(dlabels, *dtgrid),
        grid_sample_yardstick(dlabels, dtgrid, "nearest"),
        4 * (touched_source_voxels(dbank, dtgrid, "nearest") + 3 * dn + dn),
        exact=True))
    cases.append(lut_case("lut_gather_i32 K=10000 dry run", lut, dbank))
    cases.append(lut_case("lut_gather_i32 K=56 dry run",
                          torch.arange(56, dtype=torch.int32,
                                       device=dev).flip(0),
                          tuple(dscfg.size)))
    cases.append(lut_case("lut_gather_f32 K=256 C=4 dry run",
                          torch.rand((256, 4), generator=g, device=dev) * 200,
                          dbank))
    return cases + gn_cases(scfg, dev)


def _gn_names(parts, kinds):
    return tuple(f"{fn} {d} {part}{suffix}" for d, _ in GN_DTYPES
                 for part in parts for fn, suffix in kinds)


GN_TRAIN_CASES = _gn_names(("pair enc", "pair z"),
                           (("chan_sums", ""), ("chan_sums", " backward"),
                            ("chan_affine", ""), ("chan_affine3", "")))
GN_SERVE_CASES = _gn_names(("serve",), (("chan_sums", ""),
                                        ("chan_affine", "")))
# one rank's D slab of the served tensor over MGPU_WORLD ranks (the
# multigpu_reference's sharded serving), bf16 as served
GN_SLAB_CASES = ("chan_sums bf16 serve slab", "chan_affine bf16 serve slab")


def gn_cases(scfg, dev) -> list:
    """K3-K5 at the flagship's shapes, bf16 and fp32: the decoder's
    level-0 pair in the train step (S samples; enc GN_F_MAPS channels at
    cfg.size, z twice the channels at half the extent: K3 forward and
    backward, K4, K5) and the served SERVE_WIN x GN_F_MAPS tensor (K3, K4;
    serving has no backward), and in bf16 one rank's D slab of it over
    MGPU_WORLD ranks (the space-sharded served volume). The library call
    is the GroupNorm pass each takes part in, on the same tensor (8
    groups): `F.group_norm` forward for K3 and K4, its backward through
    `torch.autograd.grad` for K3 on (dy, x) and K5."""
    g = torch.Generator(dev).manual_seed(2)
    S, size = scfg.all_samples, tuple(scfg.size)
    shapes = {"pair enc": (S, GN_F_MAPS, *size),
              "pair z": (S, 2 * GN_F_MAPS, *(n // 2 for n in size)),
              "serve": (1, GN_F_MAPS, *SERVE_WIN),
              "serve slab": (1, GN_F_MAPS, SERVE_WIN[0] // MGPU_WORLD,
                             *SERVE_WIN[1:])}
    cases = []
    for dname, dtype in GN_DTYPES:
        sdt = groupnorm.stats_dtype(dtype)
        for part, shape in shapes.items():
            if part == "serve slab" and dname != "bf16":
                continue
            N, C = shape[:2]
            x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
            w = torch.linspace(0.5, 1.5, C, device=dev, dtype=dtype)
            b = torch.linspace(-0.2, 0.2, C, device=dev, dtype=dtype)
            a2 = [torch.rand((N, C), generator=g, device=dev).to(sdt) + 0.5
                  for _ in range(2)]
            es, ss = x.element_size(), sdt.itemsize
            nx, nc = x.numel() * es, N * C
            info = {"shape": list(shape), "dtype": dname}
            fwd = {**info, "library": "F.group_norm forward"}

            def lib_fwd(x=x, w=w, b=b):
                return F.group_norm(x, 8, w, b, 1e-5)

            cases.append(Case(
                f"chan_sums {dname} {part}", "chan_sums",
                lambda x=x: groupnorm.chan_sums(x),
                lambda x=x: groupnorm.chan_sums_plain(x), lib_fwd,
                nx + 2 * nc * ss, exact=False, rtol=GN_SUMS_RTOL,
                reps=GN_REPS, info=fwd))
            if not part.startswith("serve"):
                dy = torch.randn(shape, generator=g, device=dev).to(dtype)
                PQR = [(torch.randn((N, C), generator=g, device=dev) * 0.1)
                       .to(dtype) for _ in range(3)]
                held = {}

                def lib_bwd(x=x, w=w, b=b, dy=dy, held=held):
                    if not held:
                        ins = [t.detach().requires_grad_(True)
                               for t in (x, w, b)]
                        held["ins"] = ins
                        held["y"] = F.group_norm(ins[0], 8, ins[1], ins[2],
                                                 1e-5)
                    return torch.autograd.grad(held["y"], held["ins"], dy,
                                               retain_graph=True)[0]

                bwd = {**info, "library": "F.group_norm backward "
                                          "(torch.autograd.grad)"}
                cases.append(Case(
                    f"chan_sums {dname} {part} backward", "chan_sums",
                    lambda x=x, dy=dy: groupnorm.chan_sums(dy, x),
                    lambda x=x, dy=dy: groupnorm.chan_sums_plain(dy, x),
                    lib_bwd, 2 * nx + 2 * nc * ss, exact=False,
                    rtol=GN_SUMS_RTOL, reps=GN_REPS, info=bwd))
            cases.append(Case(
                f"chan_affine {dname} {part}", "chan_affine",
                lambda x=x, a=a2: groupnorm.chan_affine(x, *a),
                lambda x=x, a=a2: groupnorm.chan_affine_plain(x, *a),
                lib_fwd, 2 * nx + 2 * nc * ss, exact=True, reps=GN_REPS,
                info=fwd))
            if not part.startswith("serve"):
                cases.append(Case(
                    f"chan_affine3 {dname} {part}", "chan_affine3",
                    lambda x=x, dy=dy, c=PQR: groupnorm.chan_affine3(dy, x,
                                                                     *c),
                    lambda x=x, dy=dy, c=PQR: groupnorm.chan_affine3_plain(
                        dy, x, *c),
                    lib_bwd, 3 * nx + 3 * nc * es, exact=True, reps=GN_REPS,
                    info=bwd))
    order = {n: i for i, n in enumerate(GN_TRAIN_CASES + GN_SERVE_CASES
                                         + GN_SLAB_CASES)}
    return sorted(cases, key=lambda c: order[c.name])


def atlas_grid(dev):
    """Source coordinates in a 1 mm atlas of ATLAS_SHAPE for each voxel of
    a SERVE_WIN volume: a 10 degree rotation and a 5 % scale about the two
    centres, so the corners fall outside the atlas."""
    th = np.deg2rad(10.0)
    R = 1.05 * np.array([[np.cos(th), -np.sin(th), 0.0],
                         [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    ax = [torch.arange(n, device=dev, dtype=torch.float32) - (n - 1) / 2
          for n in SERVE_WIN]
    x, y, z = torch.meshgrid(*ax, indexing="ij")
    return [(float(R[a, 0]) * x + float(R[a, 1]) * y + float(R[a, 2]) * z
             + (ATLAS_SHAPE[a] - 1) / 2).contiguous() for a in range(3)]


SERVING_CASES = ("warp_linear_f32 C=1 atlas", "lut_gather_i32 K=56 labels")
EVALUATE_CASES = ("warp_linear_f32 C=1 acquisition",
                  "lut_gather_i32 K=10000 onehot")
NUMERICS_CASES = ("lut_gather_f32 K=256 C=2 intensities",)
# the bench's generator stage: K1 nearest and K2 i32 at the generator
# path's shapes (the first cases), K1 linear and K2 f32 at these
BENCH_CASES = ("warp_linear_f32 C=10 wall", "lut_gather_f32 K=256 C=4")
# the driver contract's dry run (the entry phase): every kernel at its
# 16^3-from-24^3 shapes; the first case of a C function stands for it
ENTRY_CASES = ("warp_linear_f32 C=10 dry run", "warp_nearest_i32 dry run",
               "lut_gather_i32 K=10000 dry run",
               "lut_gather_i32 K=56 dry run",
               "lut_gather_f32 K=256 C=4 dry run")
# the `kernels` line's key for each path's own cases
PATH_CASES = {"serving_case": SERVING_CASES, "evaluate_case": EVALUATE_CASES,
              "numerics_case": NUMERICS_CASES, "bench_case": BENCH_CASES,
              "entry_case": ENTRY_CASES, "gn_serve_case": GN_SERVE_CASES,
              "gn_slab_case": GN_SLAB_CASES}


def check_kernels(scfg, dev):
    """Each case against its plain version, timed; the first case of each
    C function stands for it in the `kernels` line, the serving,
    evaluation, numerics and bench cases beside it. Then the cold timing's floor
    (an empty pair of events) and K1 C=12 on 4 deformation draws. Returns
    (records by C function, {PATH_CASES key: records by C function})."""
    recs = {}
    by_path = {key: {} for key in PATH_CASES}
    for case in kernel_cases(scfg, dev):
        rec = run_case(case)
        recs.setdefault(case.fn, rec)
        for key, names in PATH_CASES.items():
            if case.name in names:
                by_path[key].setdefault(case.fn, rec)
    emit({"phase": "kernel", "case": "cold timing floor (no call)",
          "ms_cold": time_ms(lambda: None, cold=True)})
    g = torch.Generator(dev).manual_seed(1)
    src = torch.randn(BANK + (12,), generator=g, device=dev)
    dflt = torch.randn(12, generator=g, device=dev)
    draws = [path_grid(scfg, dev, seed=s) for s in range(4)]
    ms = [time_ms(lambda d=d: warp_volume(src, d, default=dflt))
          for d in draws]
    bound = [linear_bytes(BANK, d, 12) / HBM_BYTES_PER_S * 1e3
             for d in draws]
    emit({"phase": "kernel", "case": "warp_linear_f32 C=12 draws",
          "seeds": [0, 1, 2, 3], "ms": ms, "bound_ms": bound,
          "ms_min": min(ms), "ms_median": float(np.median(ms)),
          "ms_max": max(ms)})
    return recs, by_path


def _max_err(a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _rel_err(a, b):
    return _max_err(a, b) / max(float(b.double().abs().max()), 1e-30)


def check_slice_reference(cfg, dev):
    """Small item on the GPU, replayed on the CPU from its recorded draws;
    a small model on both."""
    scfg = SynthStatic.from_cfg(cfg)
    small = SynthStatic(**{**scfg.__dict__, "size": (32, 32, 32)})
    bank = SubjectBank((48, 48, 48))
    bank.add_debug_subject(seed=0, extent=(40, 44, 42))
    knobs = knobs_from_cfg(cfg, small, "synth")
    rec = {}
    tg, sm = synth_item(torch.Generator(dev).manual_seed(3),
                        bank.to_device(0, dev), small, cfg.tasks, "synth",
                        knobs, record=rec)
    tc, scpu = synth_item(None, bank.to_device(0, "cpu"), small, cfg.tasks,
                          "synth", knobs, draws=rec)
    errs = {}
    for k in tg:
        if k == "segmentation":
            agree = float((tg[k].argmax(-1).cpu() == tc[k].argmax(-1))
                          .float().mean())
            errs["segmentation_agree"] = agree
            if agree < SEG_AGREE:
                raise AssertionError(f"segmentation agrees on {agree}")
        else:
            errs[k] = _max_err(tg[k], tc[k])
    for k in sm:
        errs[f"sample.{k}"] = _max_err(sm[k], scpu[k])
    bad = {k: v for k, v in errs.items()
           if k != "segmentation_agree" and not v <= REPLAY_TOL}
    torch.manual_seed(0)
    mcfg, m_gpu = build_model(small_model_cfg(), device=dev)
    _, m_cpu = build_model(small_model_cfg(), device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    with torch.no_grad():
        og = apply_processors(m_gpu(sm["input"]), mcfg)
        oc = apply_processors(m_cpu(sm["input"].cpu()), mcfg)
    rel = {f"model.{k}": _rel_err(og[k], oc[k]) for k in og if k != "feat"}
    rel |= {f"feat.{i}": _rel_err(a, b)
            for i, (a, b) in enumerate(zip(og["feat"], oc["feat"]))}
    bad |= {k: v for k, v in rel.items() if not v <= MODEL_TOL}
    emit({"phase": "slice_reference", "size": list(small.size),
          "max_abs_err": errs, "model_rel_err": rel, "replay_tol": REPLAY_TOL,
          "model_tol": MODEL_TOL, "seg_agree_min": SEG_AGREE})
    if bad:
        raise AssertionError(f"GPU/CPU disagreement beyond tolerance: {bad}")


def _unet_loss_grads(model, x, w):
    """sum(model(x) * w) and its gradient by parameter name, on the CPU."""
    model.zero_grad()
    loss = (model(x) * w).sum()
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().cpu()
                                  for k, p in model.named_parameters()}


def check_groupnorm_reference(dev):
    """A small UNet3D (f_maps 8, 4 levels, 2 samples) at fp64: the loss
    and every gradient on the card, through K3-K5 and the pair conv,
    against the CPU's plain versions, at GN_REF_SIZES (at 32^3 every
    decoder level takes the pair; at 33^3 the last, 16 -> 33, does not);
    then the same on the card with `phase_upconv` off (the plain decoder:
    upsample, concat, fused GroupNorm). The whole gradient's relative L2
    within GN_REF_TOL; K3-K5 launched."""
    recs, bad = [], []
    kernels.reset_launches()
    for size in GN_REF_SIZES:
        torch.manual_seed(size)
        cpu = UNet3D(f_maps=8, num_levels=4).double()
        x = torch.randn(2, 1, size, size, size, dtype=torch.float64)
        w = torch.randn(2, 8, size, size, size, dtype=torch.float64)
        want_l, want_g = _unet_loss_grads(cpu, x, w)
        for pair in (True, False):
            gpu = UNet3D(f_maps=8, num_levels=4,
                         phase_upconv=pair).double().to(dev)
            gpu.load_state_dict(cpu.state_dict())
            loss, grads = _unet_loss_grads(gpu, x.to(dev), w.to(dev))
            rec = {"size": size, "phase_upconv": pair,
                   "loss_rel_err": abs(loss - want_l) / abs(want_l),
                   "grad_rel_l2": _global_rel_l2(grads, want_g),
                   "grad_rel_l2_max_tensor": max(
                       _rel_l2(grads[k], want_g[k]) for k in want_g)}
            recs.append(rec)
            if not (rec["loss_rel_err"] <= GN_REF_TOL
                    and rec["grad_rel_l2"] <= GN_REF_TOL):
                bad.append(rec)
    launches = dict(kernels.LAUNCHES)
    if missed(launches, names=GN_KERNELS):
        bad.append(f"missed a kernel: {launches}")
    emit({"phase": "groupnorm_reference", "model": "UNet3D f_maps 8 L4, "
          "fp64, 2 samples", "runs": recs, "tol": GN_REF_TOL,
          "launches": launches})
    if bad:
        raise AssertionError(f"groupnorm_reference failed: {bad}")


def write_mgz(path, vol, spacing=(1.0, 1.0, 1.0), mdc=np.eye(3),
              c_ras=(0.0, 0.0, 0.0)):
    """A FreeSurfer .mgz (MGH version 1, one frame, float32 or int32, with
    its RAS geometry: direction cosines `mdc` as columns, voxel `spacing`,
    the centre voxel's RAS `c_ras`)."""
    vol = np.asarray(vol)
    code = {np.dtype(np.float32): 3, np.dtype(np.int32): 1}[vol.dtype]
    hdr = bytearray(284)
    struct.pack_into(">7i", hdr, 0, 1, *vol.shape[:3], 1, code, 0)
    struct.pack_into(">h", hdr, 28, 1)                      # goodRAS
    struct.pack_into(">3f", hdr, 30, *spacing)
    struct.pack_into(">9f", hdr, 42,
                     *np.asarray(mdc, np.float64).reshape(-1, order="F"))
    struct.pack_into(">3f", hdr, 78, *c_ras)
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(bytes(hdr))
        f.write(vol.astype(vol.dtype.newbyteorder(">")).tobytes(order="F"))


def serve_affine(shape, voxel_mm, axes=SERVE_AXES):
    """Voxel -> RAS affine: voxel axis j runs along axes[:, j] with spacing
    voxel_mm[j], the volume centred on the origin."""
    aff = np.eye(4)
    aff[:3, :3] = axes * np.asarray(voxel_mm, np.float64)
    aff[:3, 3] = -aff[:3, :3] @ ((np.asarray(shape) - 1) / 2.0)
    return aff


def _smooth_noise(shape, cells, gen, dev):
    """Trilinearly upsampled gaussian noise on a coarse grid: a texture
    with features about shape/cells voxels wide."""
    coarse = torch.randn((1, 1, *cells), generator=gen, device=dev)
    return F.interpolate(coarse, size=tuple(shape), mode="trilinear",
                         align_corners=True)[0, 0]


def procedural_head(shape, voxel_mm, seed, dev):
    """A head-like float32 volume (numpy): an ellipsoid of brain texture in
    a brighter shell on a zero background, with noise; radii in mm, so the
    head fills about 3/4 of a 240 mm field."""
    g = torch.Generator(dev).manual_seed(seed)
    ax = [(torch.arange(n, device=dev, dtype=torch.float32) - (n - 1) / 2)
          * v for n, v in zip(shape, voxel_mm)]
    x, y, z = torch.meshgrid(*ax, indexing="ij")
    ext = [n * v for n, v in zip(shape, voxel_mm)]
    r = torch.sqrt((x / (0.36 * ext[0])) ** 2 + (y / (0.42 * ext[1])) ** 2
                   + (z / (0.33 * ext[2])) ** 2)
    tex = _smooth_noise(shape, (9, 9, 9), g, dev)
    vol = torch.where(r < 0.9, 70 + 25 * tex, 0.0)
    vol = vol + torch.where((r >= 0.9) & (r < 1.0), 110.0, 0.0)
    vol = vol + 3 * torch.randn(shape, generator=g, device=dev) * (r < 1.0)
    return vol.clamp(min=0).cpu().numpy()


def procedural_atlas(shape, seed, dev):
    """An atlas-like float32 volume (numpy) at 1 mm: smooth intensities in
    [0, 1] inside a centred ellipsoid, 0 outside."""
    g = torch.Generator(dev).manual_seed(seed)
    ax = [torch.linspace(-1, 1, n, device=dev) for n in shape]
    x, y, z = torch.meshgrid(*ax, indexing="ij")
    inside = (x / 0.7) ** 2 + (y / 0.85) ** 2 + (z / 0.65) ** 2 < 1
    tex = torch.sigmoid(2 * _smooth_noise(shape, (12, 12, 12), g, dev))
    return torch.where(inside, tex, 0.0).cpu().numpy()


# the stream phases' data root: these datasets and modalities, each
# subject a procedural label map with its contrasts; ATLAS also holds the
# stroke-lesion pool
STREAM_DATASETS = {"HCP": ("T1", "T2"), "ATLAS": ("T1",)}


def lesion_blob(shape, seed, centre=None):
    """A lesion-probability volume (float32): a smooth ellipsoidal blob in
    [0, 1] with seeded radii, at `centre` (in [-1, 1] per axis) or a
    seeded place in the middle of the volume."""
    rng = np.random.default_rng(seed)
    ax = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    x, y, z = np.meshgrid(*ax, indexing="ij")
    c = rng.uniform(-0.35, 0.35, 3) if centre is None else centre
    r = rng.uniform(0.12, 0.25, 3)
    d2 = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 \
        + ((z - c[2]) / r[2]) ** 2
    return np.clip(1.0 - d2, 0.0, None).astype(np.float32)


def write_subject_root(root, extent, n_subjects=2, n_lesions=2, seed=0):
    """Subject files in synth/datasets.py's DATASET_SETUPS layout under
    `root`: for each dataset of STREAM_DATASETS, `n_subjects` procedural
    subjects (SubjectBank.add_debug_subject's label maps of `extent`: the
    generation labels and the segmentation int32, T1 float32, T2 the T1
    mirrored and scaled), some .nii.gz and some .nii; ATLAS's lesion pool
    of `n_lesions` maps and probabilities; the split files train.txt and
    train_age.txt and the age table participants_age.txt. Returns
    (data_root, split_root)."""
    data_root = os.path.join(root, "data")
    split_root = os.path.join(root, "splits")
    os.makedirs(split_root, exist_ok=True)
    names, ages = [], []

    def write(base, sub, name, vol):
        d = os.path.join(base, sub)
        os.makedirs(d, exist_ok=True)
        save_nifti(os.path.join(d, name), vol)

    for di, (ds, mods) in enumerate(STREAM_DATASETS.items()):
        setup = DATASET_SETUPS[ds]
        base = os.path.join(data_root, setup["root"])
        for i in range(n_subjects):
            sid = f"{ds}_sub{i:03d}"
            bank = SubjectBank(extent)
            bank.add_debug_subject(seed=seed + 10 * di + i, extent=extent)
            s = bank.subjects[0]
            vols = {"Gen": s["gen"], "segmentation": s["seg"], "T1": s["T1"]}
            if "T2" in mods:
                vols["T2"] = np.ascontiguousarray(0.7 * s["T1"][::-1])
            for key, vol in vols.items():
                ext = ".nii.gz" if key in ("Gen", "T1") else ".nii"
                write(base, setup["paths"][key], sid + ext, vol)
            names.append(sid + ".nii.gz")
            ages.append(f"{sid} {20 + 7 * i + di}")
        if setup["pathology_type"] == "stroke":
            for j in range(n_lesions):
                prob = lesion_blob(extent, seed + 100 + j)
                write(base, setup["paths"]["pathology_prob"],
                      f"lesion{j:02d}.nii.gz", prob)
                write(base, setup["paths"]["pathology"],
                      f"lesion{j:02d}.nii.gz",
                      (prob > 0.5).astype(np.float32))
    for fn, lines in (("train.txt", names), ("train_age.txt", names),
                      ("participants_age.txt", ages)):
        with open(os.path.join(split_root, fn), "w") as f:
            f.write("\n".join(lines) + "\n")
    return data_root, split_root


EXPECTED_HEADS = {"T1": 1, "T2": 1, "FLAIR": 1, "CT": 1, "bias_field_log": 1,
                  "segmentation": 56, "distance": 4, "registration": 3}


def run_slice(cfg, dev, power):
    scfg = SynthStatic.from_cfg(cfg)
    torch.manual_seed(0)
    _, model = build_model(cfg, device=dev)
    model.eval()
    bank = SubjectBank(BANK)
    bank.add_debug_subject(seed=0)
    subj = bank.to_device(0, dev)
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    gen = torch.Generator(dev).manual_seed(1)
    # flip drawn on, so the vflip lookup (engine.py `_target_segmentation`)
    # runs in this item
    draws = {"setup": {"flip_n": 0.0}}

    def item():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        target, samples = synth_item(gen, subj, scfg, cfg.tasks, "synth",
                                     knobs, draws=draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = apply_processors(model(samples["input"]), cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return target, samples, out, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    item()   # warm-up: cuDNN/cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    target, samples, out, item_ms, fwd_ms = item()
    launches = dict(kernels.LAUNCHES)

    S = scfg.all_samples
    size = tuple(scfg.size)
    for name, ch in EXPECTED_HEADS.items():
        if tuple(out[name].shape) != (S, *size, ch):
            raise AssertionError(f"{name}: shape {tuple(out[name].shape)}")
    want_t = {"T1": 1, "segmentation": 56, "distance": 4, "registration": 3}
    for name, ch in want_t.items():
        if tuple(target[name].shape) != (*size, ch):
            raise AssertionError(f"target {name}: {tuple(target[name].shape)}")
    for name in ("input", "bias_field_log"):
        if tuple(samples[name].shape) != (S, *size, 1):
            raise AssertionError(f"sample {name}: {tuple(samples[name].shape)}")
    tensors = ({f"out.{k}": v for k, v in out.items() if k != "feat"}
               | {f"feat.{i}": v for i, v in enumerate(out["feat"])}
               | {f"target.{k}": v for k, v in target.items()}
               | {f"sample.{k}": v for k, v in samples.items()})
    bad = [k for k, v in tensors.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"non-finite values in {bad}")
    k1 = launches["warp_linear_f32"] + launches["warp_nearest_i32"]
    k2 = launches["lut_gather_i32"] + launches["lut_gather_f32"]
    if k1 < 2 or k2 < 3 or missed(launches, backward=False):
        raise AssertionError(f"path missed a kernel: {launches}")
    emit({"phase": "slice", "size": list(size), "bank": list(BANK),
          "samples": S, "tasks": list(cfg.tasks), "f_maps": int(cfg.f_maps),
          "num_levels": int(cfg.num_levels), "item_ms": item_ms,
          "forward_ms": fwd_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "gpu": power})
    return launches, model.state_dict(), item_ms


def check_serve_reference(dev, tmp):
    """The small model served on the GPU (fp32, TF32 off) and on the CPU
    from one state dict: a small head NIfTI with anisotropic voxels and a
    permuted, flipped affine through prepare_image (with an acquisition
    spacing, so K1 runs there) -> evaluate_image -> postprocess, then
    get_deformed_atlas on a small .mgz atlas. Each device serves its own
    prepared image; the atlas is rendered on both from the CPU's outputs."""
    shape = (36, 44, 28)
    img = os.path.join(tmp, "ref_head.nii")
    save_nifti(img, procedural_head(shape, SERVE_VOXEL_MM, 5, dev),
               serve_affine(shape, SERVE_VOXEL_MM))
    atlas = os.path.join(tmp, "ref_atlas.mgz")
    write_mgz(atlas, procedural_atlas((64, 64, 64), 6, dev), (3.0, 3.0, 3.0))
    gpu = Inferencer(small_model_cfg(), device=dev)
    cpu = Inferencer(small_model_cfg(), device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    kw = dict(win_size=[40, 40, 40], spacing=(1.0, 1.0, 2.0))
    kernels.reset_launches()
    ig, aff_g, _, _ = prepare_image(img, device=dev, **kw)
    og = gpu.evaluate_image(ig, keep_feat=False)
    launches = dict(kernels.LAUNCHES)
    ic, aff_c, _, _ = prepare_image(img, device="cpu", **kw)
    oc = cpu.evaluate_image(ic, keep_feat=False)
    args = [oc[k][0, ..., 0] for k in ("label", "regx", "regy", "regz")]
    ag = get_deformed_atlas(*[a.to(dev) for a in args], atlas_path=atlas)
    ac = get_deformed_atlas(*args, atlas_path=atlas)
    errs = {"image": _max_err(ig, ic), "affine": float(np.abs(aff_g - aff_c)
                                                       .max()),
            "atlas": _max_err(ag, ac)}
    rel = {k: _rel_err(og[k], oc[k]) for k in og if k != "label"}
    agree = float((og["label"].cpu() == oc["label"]).float().mean())
    bad = {k: v for k, v in errs.items() if not v <= REPLAY_TOL}
    bad |= {k: v for k, v in rel.items() if not v <= MODEL_TOL}
    if agree < SEG_AGREE:
        bad["label_agree"] = agree
    if launches["warp_linear_f32"] < 1 or launches["lut_gather_i32"] < 1:
        bad["launches"] = launches
    emit({"phase": "serve_reference", "shape": list(ig.shape),
          "max_abs_err": errs, "model_rel_err": rel, "label_agree": agree,
          "atlas_nonzero": float((ac > 0).float().mean()),
          "launches": launches, "replay_tol": REPLAY_TOL,
          "model_tol": MODEL_TOL, "seg_agree_min": SEG_AGREE})
    if bad:
        raise AssertionError(f"serving GPU/CPU disagreement: {bad}")


SERVE_HEADS = {"T1": 1, "T2": 1, "FLAIR": 1, "CT": 1, "bias_field": 1,
               "segmentation": 56, "label": 1, "lp": 1, "lw": 1, "rp": 1,
               "rw": 1, "fake_cortical": 1, "regx": 1, "regy": 1, "regz": 1}


class CheckedInferencer(Inferencer):
    """An Inferencer that checks each served volume's outputs on the device
    just before they are fetched: shapes, finite values, labels inside the
    label table, and K2 launches since the previous volume."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.table = torch.tensor(self.cfg.label_list_segmentation,
                                  dtype=torch.int32, device=self.device)
        self.volumes = []

    def fetch_outputs(self, outs, exclude_keys):
        k2 = kernels.LAUNCHES["lut_gather_i32"]
        self.volumes.append({
            "shapes": {k: list(v.shape) for k, v in outs.items()},
            "nonfinite": [k for k, v in outs.items() if v.is_floating_point()
                          and not bool(torch.isfinite(v).all())],
            "labels_in_table": bool(torch.isin(outs["label"],
                                               self.table).all()),
            "k2_launches": k2 - sum(v["k2_launches"] for v in self.volumes)})
        return super().fetch_outputs(outs, exclude_keys)


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def run_serve(cfg, state, dev, power, tmp):
    """Three procedural heads served whole at 220^3 by the flagship model in
    bf16 through evaluate_path (prefetch on; the 56-channel softmax is not
    written, and the outputs are written as .nii, not gzipped, so host time
    stays small), the deformed atlas of one result on a 256^3 1 mm atlas,
    and one volume tiled (window 160, stride 80: 8 tiles). Kernel launches
    are counted over those three steps. Then a serial walk over the same
    files times each stage per volume, every stage ended by a
    synchronize."""
    paths = []
    for i in range(3):
        p = os.path.join(tmp, f"head{i}.nii")
        save_nifti(p, procedural_head(SERVE_SHAPE, SERVE_VOXEL_MM, 10 + i,
                                      dev),
                   serve_affine(SERVE_SHAPE, SERVE_VOXEL_MM))
        paths.append(p)
    atlas = os.path.join(tmp, "atlas.mgz")
    write_mgz(atlas, procedural_atlas(ATLAS_SHAPE, 7, dev))
    inf = CheckedInferencer(cfg, compute_dtype=torch.bfloat16, exact=False,
                            device=dev)
    inf.model.load_state_dict(state)
    out_dir = os.path.join(tmp, "served")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    dirs, path_ms = _synced_ms(lambda: inf.evaluate_path(
        paths, out_dir, win_size=SERVE_WIN, prefetch=True,
        exclude_keys=("segmentation",), ext=".nii"))
    path_launches = dict(kernels.LAUNCHES)
    peak_path = torch.cuda.max_memory_allocated() / 2 ** 30

    res = {k: torch.from_numpy(load_nifti(os.path.join(
        dirs[0], f"out_{k}.nii"))[0].copy()).to(dev)
        for k in ("label", "regx", "regy", "regz")}
    before = dict(kernels.LAUNCHES)
    deformed, atlas_first_ms = _synced_ms(lambda: get_deformed_atlas(
        res["label"], res["regx"], res["regy"], res["regz"], atlas))
    atlas_k1 = kernels.LAUNCHES["warp_linear_f32"] - before["warp_linear_f32"]
    _, atlas_ms = _synced_ms(lambda: get_deformed_atlas(
        res["label"], res["regx"], res["regy"], res["regz"], atlas))

    im = prepare_image(paths[0], list(SERVE_WIN), device=dev)[0]
    n_tiles = len(tile_plan(SERVE_WIN, (80, 80, 80), (160, 160, 160))[0])
    tiled, tiled_ms = _synced_ms(lambda: inf.evaluate_tiled(
        im, (80, 80, 80), (160, 160, 160)))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    stages = []
    for p in paths:
        (im, _, _, _), prep = _synced_ms(
            lambda: prepare_image(p, list(SERVE_WIN), device=dev))
        raw, fwd = _synced_ms(lambda: inf.evaluate_image(
            im, run_postprocess=False, keep_feat=False))
        with torch.inference_mode():
            out, post = _synced_ms(lambda: inf._post(raw, im[None, ..., None]))
        del raw
        t0 = time.perf_counter()
        inf.fetch_outputs(out, ("segmentation",))
        stages.append({"prepare_ms": prep, "forward_ms": fwd,
                       "post_ms": post,
                       "fetch_ms": (time.perf_counter() - t0) * 1e3})
        del out

    bad = []
    files = sorted(os.listdir(dirs[0])) if dirs else []
    want_files = sorted(f"out_{k}.nii" for k in SERVE_HEADS
                        if k != "segmentation")
    if len(dirs) != 3 or files != want_files:
        bad.append(f"written files {files}")
    for i, v in enumerate(inf.volumes[:3]):
        for k, c in SERVE_HEADS.items():
            if v["shapes"].get(k) != [1, *SERVE_WIN, c]:
                bad.append(f"volume {i} {k}: {v['shapes'].get(k)}")
        if v["nonfinite"] or not v["labels_in_table"] \
                or v["k2_launches"] < 1:
            bad.append(f"volume {i}: {v}")
    if missed(path_launches, backward=False, names=GN_KERNELS):
        bad.append(f"served volumes missed a kernel: {path_launches}")
    if tuple(deformed.shape) != SERVE_WIN or not bool(
            torch.isfinite(deformed).all()) or atlas_k1 < 1:
        bad.append(f"atlas {tuple(deformed.shape)}, K1 launches {atlas_k1}")
    for k, v in tiled.items():
        if tuple(v.shape) != (*SERVE_WIN, SERVE_HEADS[k]) or (
                v.is_floating_point() and not bool(torch.isfinite(v).all())):
            bad.append(f"tiled {k}: {tuple(v.shape)}")
    if set(tiled) != set(SERVE_HEADS):
        bad.append(f"tiled keys {sorted(tiled)}")
    emit({"phase": "serve", "volumes": 3, "win": list(SERVE_WIN),
          "input_shape": list(SERVE_SHAPE), "voxel_mm": list(SERVE_VOXEL_MM),
          "f_maps": int(cfg.f_maps), "num_levels": int(cfg.num_levels),
          "dtype": "bf16", "written": "every output but segmentation, .nii",
          "path_ms": path_ms, "volume_ms": path_ms / 3, "stages": stages,
          "atlas_ms": atlas_ms, "atlas_first_ms": atlas_first_ms,
          "tiled_ms": tiled_ms, "tiles": n_tiles, "peak_mem_gib": peak,
          "peak_mem_gib_path": peak_path,
          "k2_per_volume": [v["k2_launches"] for v in inf.volumes[:3]],
          "atlas_k1_launches": atlas_k1, "launches_path": path_launches,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"serve phase failed: {bad}")
    return launches, [st["forward_ms"] for st in stages]


def train_ref_cfg():
    """The train_reference model: the flagship config at f_maps 8, 3
    levels, 32^3, no autocast, SGD (params after one step compare; Adam's
    first step g / (|g| + eps) would magnify rounding in near-zero
    gradients)."""
    cfg = small_model_cfg()
    cfg.num_levels = 3
    cfg.generator.size = [32, 32, 32]
    cfg.optimizer, cfg.lr, cfg.amp = "sgd", 1e-2, False
    return cfg


def ref_train_batch(cfg, seed=0, B=1, S=4):
    """A train batch made on the CPU from a numpy seed. Distance targets
    stay inside (-2.5, 2.5), away from the head's clamp at +-3, where
    gradients would tie."""
    rng = np.random.default_rng(seed)
    size = tuple(cfg.generator.size)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    lab = rng.integers(0, cfg.n_labels, (B, 1, *size))
    return {"samples": {"input": t(rng.random((B, S, *size, 1))),
                        "bias_field_log": t(0.1 * rng.standard_normal(
                            (B, S, *size, 1)))},
            "targets": {"T1": t(rng.random((B, 1, *size, 1))),
                        "segmentation": t(np.eye(cfg.n_labels)[lab]),
                        "distance": t(rng.uniform(-2.5, 2.5,
                                                  (B, 1, *size, 4))),
                        "registration": t(rng.standard_normal(
                            (B, 1, *size, 3)))}}


def _to_dev(batch, dev):
    return {k: {kk: vv.to(dev) for kk, vv in v.items()}
            for k, v in batch.items()}


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _loss_and_grads(model, cfg, weight_dict, loss_fn, batch, **kw):
    """The losses and every parameter's gradient of one backward (`kw`:
    batch_losses' critic arguments)."""
    model.zero_grad(set_to_none=True)
    losses = batch_losses(model, cfg, loss_fn, batch, amp=False, **kw)
    losses["loss_total"] = weighted_total(losses, weight_dict)
    losses["loss_total"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def _state_tensors(state):
    """Every tensor of a TrainState (params, optimizer state), cloned."""
    out = {f"param.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"opt.{i}.{k}"] = v.detach().clone()
    return out


def _bitwise_diff(a: dict, b: dict):
    """Keys whose tensors differ in any bit (or are missing)."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].shape != b[k].shape
                  or not torch.equal(a[k].view(torch.uint8) if a[k].dim()
                                     else a[k], b[k].view(torch.uint8)
                                     if b[k].dim() else b[k]))


def _global_rel_l2(a: dict, b: dict):
    return _rel_l2(torch.cat([a[k].double().cpu().flatten() for k in b]),
                   torch.cat([b[k].double().cpu().flatten() for k in b]))


def check_train_reference(dev, tmp):
    """One train step of a small model on the GPU and on the CPU from the
    same params and batch; the NaN skip and a checkpoint round trip on the
    card.

    fp32 (TF32 off): the losses agree to LOSS_TOL, and the GPU's gradients
    are as close to the CPU's fp64 gradients as the CPU's own fp32 ones
    (global relative L2, within FP32_GRAD_FACTOR). Per tensor, fp32
    gradients of this model are not defined to 1e-3 on either device: a
    GroupNorm's bias and weight gradients behind the next GroupNorm, and
    the weight gradients of random targets, are sums that cancel, so the
    CPU's own fp32 gradients miss its fp64 ones by more than that. So
    each gradient tensor and the SGD update are held at fp64 on both
    devices, to GRAD_TOL."""
    cfg = process_args(train_ref_cfg())
    torch.manual_seed(0)
    _, m32c = build_model(cfg, device="cpu")
    models = {"cpu32": m32c, "gpu32": copy.deepcopy(m32c).to(dev),
              "cpu64": copy.deepcopy(m32c).double(),
              "gpu64": copy.deepcopy(m32c).double().to(dev)}
    _, weight_dict, loss_fn = make_criterion(cfg)
    b32 = ref_train_batch(cfg)
    b64 = {k: {kk: vv.double() for kk, vv in v.items()}
           for k, v in b32.items()}
    batches = {"cpu32": b32, "gpu32": _to_dev(b32, dev), "cpu64": b64,
               "gpu64": _to_dev(b64, dev)}
    losses, grads = {}, {}
    for k, m in models.items():
        losses[k], grads[k] = _loss_and_grads(m, cfg, weight_dict, loss_fn,
                                              batches[k])

    def loss_rel(a, b):
        return {k: abs(losses[a][k] - losses[b][k])
                / max(abs(losses[b][k]), 1e-30) for k in losses[b]}

    loss_rel32, loss_rel64 = loss_rel("gpu32", "cpu32"), loss_rel("gpu64",
                                                                  "cpu64")
    grad_rel64 = {k: _rel_l2(grads["gpu64"][k], grads["cpu64"][k])
                  for k in grads["cpu64"]}
    fp32_err = {d: _global_rel_l2(grads[f"{d}32"], grads["cpu64"])
                for d in ("gpu", "cpu")}

    # one SGD step at fp64 on both devices
    before = {k: v.detach().clone() for k, v in
              models["cpu64"].state_dict().items()}
    states, metrics = {}, {}
    for k in ("gpu64", "cpu64"):
        m = models[k]
        st = TrainState(m, build_optimizer(cfg, m.parameters()), 0)
        step = make_train_step(m, cfg, weight_dict, loss_fn, st.optimizer)
        states[k], metrics[k] = step(st, batches[k], cfg.lr, 0.0)
    pg, pc = models["gpu64"].state_dict(), models["cpu64"].state_dict()
    update_rel = max(_rel_l2(pg[k].cpu() - before[k], pc[k] - before[k])
                     for k in pc if not torch.equal(pc[k], before[k]))
    step_rel = {k: abs(float(metrics["gpu64"][k]) - float(metrics["cpu64"][k]))
                / max(abs(float(metrics["cpu64"][k])), 1e-30)
                for k in metrics["cpu64"] if k != "skipped"}

    # a NaN voxel: the GPU state (params, momentum, step) must not move
    nan_batch = {k: dict(v) for k, v in batches["gpu64"].items()}
    x = nan_batch["samples"]["input"].clone()
    x.view(-1)[12345] = float("nan")
    nan_batch["samples"]["input"] = x
    gstate = states["gpu64"]
    snap, step0 = _state_tensors(gstate), gstate.step
    step = make_train_step(gstate.model, cfg, weight_dict, loss_fn,
                           gstate.optimizer)
    gstate, nan_metrics = step(gstate, nan_batch, cfg.lr, 0.0)
    nan_changed = _bitwise_diff(snap, _state_tensors(gstate))
    nan_ok = (not nan_changed and gstate.step == step0
              and float(nan_metrics["skipped"]) == 1.0
              and all(np.isnan(float(v)) for k, v in nan_metrics.items()
                      if k != "skipped"))

    # a checkpoint saved and loaded on the card, into a model and
    # optimizer of other values
    path = save_checkpoint(os.path.join(tmp, "ref_ckp"), 1, gstate,
                           extra={"epoch": 0})
    torch.manual_seed(1)
    _, m2 = build_model(cfg, device=dev)
    m2.double()
    st2 = TrainState(m2, build_optimizer(cfg, m2.parameters()), 0)
    st2 = load_checkpoint(path, st2)
    ckpt_changed = _bitwise_diff(_state_tensors(gstate), _state_tensors(st2))
    ckpt_ok = not ckpt_changed and st2.step == gstate.step

    bad = {f"fp32.{k}": v for k, v in loss_rel32.items()
           if not v <= LOSS_TOL}
    bad |= {f"fp64.{k}": v for k, v in loss_rel64.items()
            if not v <= LOSS_TOL}
    bad |= {f"step.{k}": v for k, v in step_rel.items() if not v <= LOSS_TOL}
    bad |= {k: v for k, v in grad_rel64.items() if not v <= GRAD_TOL}
    if not update_rel <= GRAD_TOL:
        bad["sgd_update"] = update_rel
    if not fp32_err["gpu"] <= FP32_GRAD_FACTOR * fp32_err["cpu"]:
        bad["fp32_grads"] = fp32_err
    if not nan_ok:
        bad["nan_skip"] = nan_changed or dict(nan_metrics)
    if not ckpt_ok:
        bad["checkpoint"] = ckpt_changed
    emit({"phase": "train_reference", "size": list(cfg.generator.size),
          "f_maps": int(cfg.f_maps), "num_levels": int(cfg.num_levels),
          "samples": 4, "fp32_loss_rel_err": loss_rel32,
          "fp32_grad_global_rel_l2_vs_cpu_fp64": fp32_err,
          "fp64_loss_rel_err_max": max(loss_rel64.values()),
          "fp64_grad_rel_l2_max": max(grad_rel64.values()),
          "fp64_grad_rel_l2_worst": max(grad_rel64, key=grad_rel64.get),
          "fp64_sgd_step_metrics_rel_err_max": max(step_rel.values()),
          "fp64_sgd_update_rel_l2_max": update_rel,
          "nan_skip_bitwise": nan_ok, "checkpoint_bitwise": ckpt_ok,
          "loss_tol": LOSS_TOL, "grad_tol": GRAD_TOL,
          "fp32_grad_factor": FP32_GRAD_FACTOR})
    if bad:
        raise AssertionError(f"train_reference failed: {bad}")


STEP_LINE = re.compile(r"epoch (\d+) it (\d+)/\d+ lr (\S+) loss (\S+) "
                       r"skipped (\d+)")


def _read_steps(out_dir):
    with open(os.path.join(out_dir, "train.log")) as f:
        return [{"epoch": int(m[1]), "it": int(m[2]), "lr": float(m[3]),
                 "loss_total": float(m[4]), "skipped": int(m[5])}
                for m in STEP_LINE.finditer(f.read())]


def _timed_iterations(n, item, step):
    """n iterations, each timed in two parts ended by a synchronize: the
    item (`item()` -> batch) and the step (`step(batch)` -> metrics)."""
    timed = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = item()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del batch
        timed.append({"item_ms": (t1 - t0) * 1e3, "step_ms": (t2 - t1) * 1e3,
                      "iter_ms": (t2 - t0) * 1e3,
                      "loss_total": float(m["loss_total"]),
                      "skipped": int(m["skipped"])})
    return timed


def run_train(dev, power, tmp, cfg=None, bank_shape=BANK):
    """The flagship configuration trained through train(): one epoch of
    TRAIN_ITR iterations (validation on one batch, the epoch and best
    checkpoints), then TRAIN_TIMED iterations timed in two parts, each
    ended by a synchronize: the item (make_batch: K1 and K2) and the step
    (forward, backward, optimizer). Launch counts and peak memory over the
    whole phase."""
    cfg = flagship_cfg() if cfg is None else cfg
    cfg.remat, cfg.grad_accum_samples = TRAIN_REMAT, TRAIN_ACCUM
    cfg.n_epochs = 1
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    _, weight_dict, loss_fn = make_criterion(cfg)
    bank = SubjectBank(bank_shape)
    bank.add_debug_subject(seed=0, extent=tuple(s * 5 // 6
                                                for s in bank_shape))
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    out_dir = os.path.join(tmp, "train")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = train(cfg, model, weight_dict, loss_fn, bank, out_dir,
                  itr_per_epoch=TRAIN_ITR, log_itr=1, val_itr=1,
                  n_val_items=1, seed=0)
    train_s = time.perf_counter() - t0
    changed = sum(not torch.equal(init[k], v.cpu())
                  for k, v in model.state_dict().items())
    del init
    steps = _read_steps(out_dir)

    scfg = SynthStatic.from_cfg(cfg)
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    subj = bank.to_device(0, dev)
    gen = torch.Generator(dev).manual_seed(2)
    lr_s, wd_s = build_schedules(cfg, TRAIN_ITR)
    step_fn = make_train_step(model, cfg, weight_dict, loss_fn,
                              state.optimizer, sample_accum=TRAIN_ACCUM)
    timed = _timed_iterations(
        TRAIN_TIMED,
        lambda: make_batch([gen], subj, scfg, cfg.tasks, "synth", knobs),
        lambda b: step_fn(state, b, float(lr_s[-1]), float(wd_s[-1]))[1])
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    files = {f: os.path.exists(os.path.join(out_dir, f))
             for f in ("log.txt", f"ckp/ckpt_{TRAIN_ITR:06d}",
                       "ckp/ckpt_best")}
    bad = []
    every = steps + timed
    if len(steps) != TRAIN_ITR:
        bad.append(f"{len(steps)} step lines in train.log")
    if not all(np.isfinite(s["loss_total"]) and s["skipped"] == 0
               for s in every):
        bad.append(f"a non-finite or skipped step: {every}")
    if changed == 0:
        bad.append("no parameter changed")
    if not all(files.values()):
        bad.append(f"missing outputs {files}")
    if missed(launches):
        bad.append(f"path missed a kernel: {launches}")
    emit({"phase": "train", "size": list(scfg.size), "bank": list(bank_shape),
          "samples": scfg.all_samples, "f_maps": int(cfg.f_maps),
          "num_levels": int(cfg.num_levels), "amp": "bf16",
          "optimizer": cfg.optimizer, "remat": TRAIN_REMAT,
          "grad_accum_samples": TRAIN_ACCUM, "itr_per_epoch": TRAIN_ITR,
          "train_s": train_s, "steps": steps, "timed": timed,
          "item_ms": [t["item_ms"] for t in timed],
          "step_ms": [t["step_ms"] for t in timed],
          "iter_ms": [t["iter_ms"] for t in timed],
          "peak_mem_gib": peak, "params_changed": changed, "files": files,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"train phase failed: {bad}")
    return launches


def stream_gen_cfg(cfg, root, **generator):
    """`cfg` reading the data root `root` = (data_root, split_root) with
    STREAM_DATASETS, generator keys overridden by `generator`."""
    cfg = copy.deepcopy(cfg)
    cfg.data_root, cfg.split_root = root
    cfg.dataset_names = list(STREAM_DATASETS)
    cfg.generator.update(generator)
    return cfg


def check_stream_reference(dev, tmp):
    """Procedural subject files (40-44 voxels a side, a 48^3 bank) read by
    build_datasets on the GPU and on the CPU; one item per dataset (32^3,
    S=4) with deform_one_hots, pathology forced on from the lesion pool
    (K1 on the lesion file, dopri5 advection) and the surface task's
    inverse field, made on the GPU and replayed on the CPU from its draws;
    binary targets (the segmentation's argmax, the pathology) agree on
    SEG_AGREE of the voxels, the rest within REPLAY_TOL; the small model on
    the GPU item's input on both devices within MODEL_TOL."""
    base = process_args(flagship_cfg())
    root = write_subject_root(os.path.join(tmp, "ref_root"), (40, 44, 42))
    cfg = stream_gen_cfg(base, root, size=[32, 32, 32], deform_one_hots=True,
                         pathology_prob=1.0, random_shape_prob=0.0,
                         augment_pathology=True)
    tasks = tuple(base.tasks) + ("pathology", "surface")
    sets = {d: build_datasets(cfg, tasks, device=d, bank_shape=(48, 48, 48))
            for d in (dev, "cpu")}
    errs, agree, stats, bad = {}, {}, {}, {}
    kernels.reset_launches()
    inputs = []
    for name in STREAM_DATASETS:
        gds, cds = sets[dev][name], sets["cpu"][name]
        gds.reseed(0)
        cds.reseed(0)
        rec = {}
        with profiling.recording():
            tg, sg = gds.get(0, torch.Generator(dev).manual_seed(5),
                             record=rec)
        st = item_record()
        tc, sc = cds.get(0, draws=rec)
        stats[name] = st
        inputs.append(sg["input"])
        for k in tg:
            if k in ("segmentation", "pathology"):
                a, b = tg[k].cpu(), tc[k]
                if k == "segmentation":
                    errs[f"{name}.{k}"] = _max_err(a, b)
                    a, b = a.argmax(-1), b.argmax(-1)
                agree[f"{name}.{k}"] = float((a == b).float().mean())
            else:
                errs[f"{name}.{k}"] = _max_err(tg[k], tc[k])
        for k in sg:
            errs[f"{name}.sample.{k}"] = _max_err(sg[k], sc[k])
        if not float(tg["pathology"].sum()) > 0 or "lesion_warp_ms" not in st:
            bad[f"{name}.pathology"] = float(tg["pathology"].sum())
    launches = dict(kernels.LAUNCHES)
    bad |= {k: v for k, v in errs.items() if not v <= REPLAY_TOL}
    bad |= {k: v for k, v in agree.items() if not v >= SEG_AGREE}
    if launches["warp_linear_f32"] < 1 or launches["lut_gather_i32"] < 1:
        bad["launches"] = launches
    torch.manual_seed(0)
    mcfg, m_gpu = build_model(small_model_cfg(), device=dev)
    _, m_cpu = build_model(small_model_cfg(), device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    x = torch.cat(inputs)
    with torch.no_grad():
        og = apply_processors(m_gpu(x), mcfg)
        oc = apply_processors(m_cpu(x.cpu()), mcfg)
    rel = {f"model.{k}": _rel_err(og[k], oc[k]) for k in og if k != "feat"}
    bad |= {k: v for k, v in rel.items() if not v <= MODEL_TOL}
    emit({"phase": "stream_reference", "size": [32, 32, 32],
          "bank": [48, 48, 48], "datasets": list(STREAM_DATASETS),
          "tasks": list(tasks), "max_abs_err": errs, "agree": agree,
          "model_rel_err": rel, "stats": stats, "launches": launches,
          "replay_tol": REPLAY_TOL, "seg_agree_min": SEG_AGREE,
          "model_tol": MODEL_TOL})
    if bad:
        raise AssertionError(f"stream GPU/CPU disagreement: {bad}")


def _run_cli(args):
    """scripts/train.py::main with its standard output captured; the exit
    code must be 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_script.main(args)
    if rc != 0:
        raise AssertionError(f"train CLI exit {rc}: {buf.getvalue()}")
    return buf.getvalue()


def run_stream(dev, power, tmp):
    """The training CLI on a data root of STREAM_DATASETS at STREAM_EXTENT
    with the flagship configs (brain_id under the data root, joint; the
    train phase's memory settings): one epoch of STREAM_ITR iterations on
    the dataset stream (validation, checkpoints), --eval_only --resume on
    its checkpoint, then TRAIN_TIMED stream iterations timed in two parts
    (the item, the step), each ended by a synchronize. Ingest seconds (the
    CLI's codec ingest of every subject), peak memory and launch counts
    over the phase."""
    t0 = time.perf_counter()
    root = write_subject_root(os.path.join(tmp, "root"), STREAM_EXTENT)
    write_s = time.perf_counter() - t0
    gen_yaml = os.path.join(tmp, "stream_gen.yaml")
    with open(os.path.join(ROOT, "cfgs/generator/train/brain_id.yaml")) as f:
        text = f.read()
    with open(gen_yaml, "w") as f:
        f.write(f"{text}\ndata_root: {root[0]}\nsplit_root: {root[1]}\n"
                f"dataset_names: {list(STREAM_DATASETS)}\n")
    out = os.path.join(tmp, "stream_run")
    args = ["--gen_cfg", gen_yaml, "--train_cfg", "joint", "--epochs", "1",
            "--itr_per_epoch", str(STREAM_ITR), "--out_dir", out,
            "--remat", TRAIN_REMAT, "--grad_accum", str(TRAIN_ACCUM),
            "--device", str(dev)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    text = _run_cli(args)
    cli_s = time.perf_counter() - t0
    m = re.search(r"datasets: (\{.*?\}) \(ingest ([\d.]+) s\)", text)
    n_subjects = ast.literal_eval(m[1]) if m else None
    ingest_s = float(m[2]) if m else None
    # the CLI logs every 10th step; the epoch line holds every step's mean
    # loss (NaN-free) and the share of skipped steps
    with open(os.path.join(out, "log.txt")) as f:
        epoch = json.loads(f.readline())
    ckpt = os.path.join(out, "ckp", f"ckpt_{STREAM_ITR:06d}")
    text = _run_cli(args + ["--eval_only", "--resume", ckpt])
    val = [ast.literal_eval(v) for v in re.findall(r"val\[\d+\]: (\{.*\})",
                                                   text)]

    cfg = train_script.train_config(gen_yaml, "joint")
    cfg.remat, cfg.grad_accum_samples = TRAIN_REMAT, TRAIN_ACCUM
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    _, weight_dict, loss_fn = make_criterion(cfg)
    t0 = time.perf_counter()
    stream = build_datasets(cfg, cfg.tasks, device=dev)["_concat"]
    ingest_timed_s = time.perf_counter() - t0
    state = TrainState(model, build_optimizer(cfg, model.parameters()), 0)
    step_fn = make_train_step(model, cfg, weight_dict, loss_fn,
                              state.optimizer, sample_accum=TRAIN_ACCUM)
    items = stream.epoch(0, TRAIN_TIMED, seed=1)
    names = []

    def item():
        name, target, samples = next(items)
        names.append(name)
        return stack_items([target], [samples])

    timed = _timed_iterations(TRAIN_TIMED, item,
                              lambda b: step_fn(state, b, 1e-4, 1e-2)[1])
    for t, name in zip(timed, names):
        t["dataset"] = name
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    bad = []
    if n_subjects != {n: 2 for n in STREAM_DATASETS}:
        bad.append(f"datasets {n_subjects}")
    if not (np.isfinite(epoch["train_loss_total"])
            and epoch["train_skipped"] == 0
            and np.isfinite(epoch["val_loss_total"])) or not all(
                np.isfinite(t["loss_total"]) and t["skipped"] == 0
                for t in timed):
        bad.append(f"epoch {epoch} timed {timed}")
    if len(val) != 2 or not all(np.isfinite(v["loss_total"]) for v in val):
        bad.append(f"eval_only {val}")
    if launches["warp_linear_f32"] < 1 or launches["lut_gather_i32"] < 1 \
            or launches["lut_gather_f32"] < 1 \
            or missed(launches, names=GN_KERNELS):
        bad.append(f"path missed a kernel: {launches}")
    emit({"phase": "stream", "extent": list(STREAM_EXTENT),
          "bank": list(BANK), "datasets": n_subjects,
          "size": list(cfg.generator.size), "f_maps": int(cfg.f_maps),
          "num_levels": int(cfg.num_levels), "amp": "bf16",
          "remat": TRAIN_REMAT, "itr_per_epoch": STREAM_ITR,
          "write_s": write_s, "ingest_s": ingest_s,
          "ingest_timed_s": ingest_timed_s, "cli_train_s": cli_s,
          "epoch": epoch, "eval_only_val": val, "timed": timed,
          "item_ms": [t["item_ms"] for t in timed],
          "step_ms": [t["step_ms"] for t in timed],
          "iter_ms": [t["iter_ms"] for t in timed], "peak_mem_gib": peak,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"stream phase failed: {bad}")
    figs = {k: [t[k] for t in timed] for k in ("item_ms", "step_ms",
                                               "iter_ms")}
    return launches, root, {**figs, "peak_mem_gib": peak}


# the generator's pathology spans and the solver's counters, under the keys
# the smoke phases report (utils/profiling.py)
_ITEM_SPANS = {"gen.shape": "shape_ms", "gen.lesion_warp": "lesion_warp_ms",
               "gen.advect": "advect_ms"}
_ITEM_COUNTS = {"ode.nt": "nt", "ode.steps": "steps",
                "ode.rejected": "rejected", "ode.evals": "evals"}


def item_record() -> dict:
    """The last recording's pathology stages (ms of host time, not
    synchronized) and solver counts."""
    out = {}
    for s in profiling.SPANS:
        if s.name in _ITEM_SPANS and s.t1 is not None:
            k = _ITEM_SPANS[s.name]
            out[k] = out.get(k, 0.0) + (s.t1 - s.t0) / 1e6
    out.update({v: profiling.COUNTS[k] for k, v in _ITEM_COUNTS.items()
                if k in profiling.COUNTS})
    return out


def run_pathology(dev, power):
    """PATHOLOGY_ITEMS items of the shape_id generator (160^3 from a 192^3
    bank, S=1, dopri5, augment_pathology) with pathology forced on, from a
    random shape and from the subject's lesion file alternately; each
    item's wall on the host clock split by the generator's spans
    (utils/profiling.py, host time) into the shape synthesis (or the
    lesion warp), the advection (with nt and the adaptive steps) and the
    rest; then the flagship model (joint: f_maps
    64, L6, bf16, AdamW) on the shape_id tasks trains one step on each
    item. An untimed item and step go first."""
    cfg = train_script.train_config("shape_id", "joint")
    cfg.remat, cfg.grad_accum_samples = TRAIN_REMAT, TRAIN_ACCUM
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    _, weight_dict, loss_fn = make_criterion(cfg)
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank(BANK)
    bank.add_debug_subject(seed=0, extent=tuple(s * 5 // 6 for s in BANK))
    bank.subjects[0]["pathol_prob"] = lesion_blob(BANK, 3, centre=(
        -1 / 6, -1 / 6, -1 / 6))   # the centre of the 160^3 subject
    subj = bank.to_device(0, dev)
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    state = TrainState(model, build_optimizer(cfg, model.parameters()), 0)
    step_fn = make_train_step(model, cfg, weight_dict, loss_fn,
                              state.optimizer, sample_accum=TRAIN_ACCUM)

    # warm-up: an untimed item and step (first calls, cuDNN's choices)
    target, samples = synth_item(torch.Generator(dev).manual_seed(19), subj,
                                 scfg, cfg.tasks, "synth", knobs,
                                 draws={"setup": {"pathol_u": 0.0,
                                                  "shape_u": 0.0}})
    state, _ = step_fn(state, stack_items([target], [samples]), 1e-4, 1e-2)
    del target, samples
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    items, bad = [], []
    seed = 20
    for i in range(PATHOLOGY_ITEMS):
        shape_u = 0.0 if i % 2 == 0 else 0.99   # random shape, lesion file
        draws = {"setup": {"pathol_u": 0.0, "shape_u": shape_u}}
        # a shape can be keep-masked away or advected below pathol_tol:
        # up to 3 draws for a non-empty target, each item timed
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiling.recording():
                target, samples = synth_item(torch.Generator(dev).manual_seed(
                    seed), subj, scfg, cfg.tasks, "synth", knobs,
                    draws=draws)
            torch.cuda.synchronize()
            item_ms = (time.perf_counter() - t0) * 1e3
            st = item_record()
            seed += 1
            parts = sum(st.get(k, 0.0) for k in ("shape_ms", "lesion_warp_ms",
                                                 "advect_ms"))
            rec = {"source": ("random shape" if shape_u < 0.5
                              else "lesion file"), "seed": seed - 1,
                   "item_ms": item_ms, "rest_ms": item_ms - parts,
                   "pathology_voxels": float(target["pathology"].sum()),
                   **st}
            items.append(rec)
            if rec["pathology_voxels"] > 0:
                break
        if not rec["pathology_voxels"] > 0:
            bad.append(rec)
        batch = stack_items([target], [samples])
        del target, samples
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, mt = step_fn(state, batch, 1e-4, 1e-2)
        torch.cuda.synchronize()
        rec.update(step_ms=(time.perf_counter() - t1) * 1e3,
                   loss_total=float(mt["loss_total"]),
                   skipped=int(mt["skipped"]))
        if rec["skipped"] or not np.isfinite(rec["loss_total"]):
            bad.append(rec)
        del batch
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the shape_id tasks (T1, pathology) have no segmentation: no label
    # lookup or nearest warp; K1 warps each item's wall (and each lesion
    # file), K2 looks up each item's contrast
    if launches["warp_linear_f32"] < PATHOLOGY_ITEMS \
            or launches["lut_gather_f32"] < PATHOLOGY_ITEMS \
            or missed(launches, names=GN_KERNELS):
        bad.append(f"path missed a kernel: {launches}")
    emit({"phase": "pathology", "size": list(scfg.size), "bank": list(BANK),
          "samples": scfg.all_samples, "tasks": list(cfg.tasks),
          "integ_method": scfg.integ_method, "f_maps": int(cfg.f_maps),
          "num_levels": int(cfg.num_levels), "items": items,
          "item_ms": [r["item_ms"] for r in items],
          "step_ms": [r["step_ms"] for r in items if "step_ms" in r],
          "peak_mem_gib": peak,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"pathology phase failed: {bad}")
    return launches


def variant_cfg(name):
    """The shipped trainer configs of the model variants, at full width:
    joint_age.yaml with brain_id_age.yaml (L6, 160^3, S=4), sep.yaml (L5)
    on twostage.yaml's generator (T1, pathology, segmentation, 160^3,
    S=2), the flagship with losses.implicit_pathol on (a random-init
    critic: UNet3D f_maps 64, 5 levels), and the two-stage pair
    (twostage.yaml with its generator: two UNet3D f_maps 64, 5 levels)."""
    if name == "joint_age":
        return train_script.train_config("brain_id_age", "joint_age")
    if name == "sep":
        return train_script.train_config("twostage", "sep")
    if name == "twostage":
        return train_script.train_config("twostage", "twostage")
    cfg = flagship_cfg()
    cfg.losses.implicit_pathol = True
    return cfg


def ref_variant_cfg(name):
    """A variant cut for the reference phases, as train_ref_cfg: f_maps
    8, 3 levels (the critic too), 32^3, fp32, SGD."""
    cfg = variant_cfg(name)
    cfg.f_maps, cfg.num_levels, cfg.task_f_maps = 8, 3, [8]
    cfg.critic_f_maps, cfg.critic_num_levels = 8, 3
    cfg.generator.size = [32, 32, 32]
    cfg.optimizer, cfg.lr, cfg.amp = "sgd", 1e-2, False
    return cfg


def ref_variant_batch(cfg, S):
    """ref_train_batch with an age and a pathology target."""
    batch = ref_train_batch(cfg, S=S)
    rng = np.random.default_rng(1)
    size = tuple(cfg.generator.size)
    batch["targets"]["age"] = torch.tensor([47.0])
    batch["targets"]["pathology"] = torch.from_numpy(
        (rng.random((1, 1, *size, 1)) < 0.2).astype(np.float32))
    return batch


def _reference_step(name, dev):
    """One step of the small `name` model on the GPU and the CPU from the
    same params, batch and (for the critic variant) frozen critic: the
    relative errors of the losses at fp32 and fp64 and of each gradient
    tensor at fp64 (relative L2), and whether the critic got gradients."""
    build = build_inpaint_model if name == "twostage" else build_model
    torch.manual_seed(0)
    cfg, m = build(ref_variant_cfg(name), device="cpu")
    _, weight_dict, loss_fn = make_criterion(cfg)
    critic, key = build_critic_from_cfg(cfg, device="cpu")
    b32 = ref_variant_batch(cfg, S=cfg.generator.all_samples)
    b64 = {k: {kk: vv.double() for kk, vv in v.items()}
           for k, v in b32.items()}
    runs = {"cpu32": (m, critic, b32),
            "gpu32": (copy.deepcopy(m).to(dev), critic and copy.deepcopy(
                critic).to(dev), _to_dev(b32, dev)),
            "cpu64": (copy.deepcopy(m).double(), critic and copy.deepcopy(
                critic).double(), b64),
            "gpu64": (copy.deepcopy(m).double().to(dev), critic and
                      copy.deepcopy(critic).double().to(dev),
                      _to_dev(b64, dev))}
    losses, grads = {}, {}
    for k, (model, crit, batch) in runs.items():
        losses[k], grads[k] = _loss_and_grads(
            model, cfg, weight_dict, loss_fn, batch, critic=crit,
            critic_image_key=key)

    def loss_rel(a, b):
        return {k: abs(losses[a][k] - losses[b][k])
                / max(abs(losses[b][k]), 1e-30) for k in losses[b]}

    grad_rel = {k: _rel_l2(grads["gpu64"][k], grads["cpu64"][k])
                for k in grads["cpu64"]}
    critic_grads = critic is not None and any(
        p.grad is not None for _, c, _ in runs.values()
        for p in c.parameters())
    return {"losses": losses["gpu32"], "fp32_loss_rel_err": loss_rel(
        "gpu32", "cpu32"), "fp64_loss_rel_err": loss_rel("gpu64", "cpu64"),
        "fp64_grad_rel_l2": grad_rel, "critic_got_gradients": critic_grads}


def _reference_bad(rec):
    bad = {f"fp32.{k}": v for k, v in rec["fp32_loss_rel_err"].items()
           if not v <= LOSS_TOL}
    bad |= {f"fp64.{k}": v for k, v in rec["fp64_loss_rel_err"].items()
            if not v <= LOSS_TOL}
    bad |= {k: v for k, v in rec["fp64_grad_rel_l2"].items()
            if not v <= GRAD_TOL}
    if rec["critic_got_gradients"]:
        bad["critic_got_gradients"] = True
    return bad


def _reference_summary(rec):
    g = rec["fp64_grad_rel_l2"]
    return {"losses": rec["losses"],
            "fp32_loss_rel_err_max": max(rec["fp32_loss_rel_err"].values()),
            "fp64_loss_rel_err_max": max(rec["fp64_loss_rel_err"].values()),
            "fp64_grad_rel_l2_max": max(g.values()),
            "fp64_grad_rel_l2_worst": max(g, key=g.get),
            "critic_got_gradients": rec["critic_got_gradients"]}


def check_variants_reference(dev):
    """The small joint_age, sep and critic-on models: one step's losses
    within LOSS_TOL at fp32 and fp64 and each gradient tensor within
    GRAD_TOL relative L2 at fp64, GPU against CPU; no gradient reaches
    the critic."""
    recs, bad = {}, {}
    for name in VARIANTS:
        rec = _reference_step(name, dev)
        recs[name] = _reference_summary(rec)
        bad |= {f"{name}.{k}": v for k, v in _reference_bad(rec).items()}
    emit({"phase": "variants_reference", "size": [32, 32, 32], "f_maps": 8,
          "num_levels": 3, "variants": recs, "loss_tol": LOSS_TOL,
          "grad_tol": GRAD_TOL})
    if bad:
        raise AssertionError(f"variants_reference failed: {bad}")


def missed(launches, backward=True, names=None):
    """The C functions of `names` (default: every kernel) that a path
    launched no time; a path without a backward pass is not asked for K5
    (chan_affine3), which runs only there."""
    names = launches if names is None else names
    return [k for k in names if launches[k] < 1
            and (backward or k not in GN_BACKWARD)]


def _kernel_check(launches, what):
    """Every kernel of the path launched at least once."""
    return [] if not missed(launches) else [
        f"{what}: path missed a kernel: {launches}"]


def run_variants(dev, power, tmp):
    """Each variant of VARIANTS at full width, at its VARIANT_FIT memory
    setting, bf16, AdamW: through train() for one epoch of VARIANT_ITR
    iterations (validation on one batch, the epoch and best checkpoints),
    then VARIANT_TIMED iterations timed as the train phase's. Per
    variant: every step finite and applied, the age, sep or critic
    losses present, peak memory and launch counts (counts set to 0 just
    before the variant's run). Returns the launches summed over the
    variants."""
    total = {k: 0 for k in kernels.LAUNCHES}
    bad = []
    for name in VARIANTS:
        remat, accum = VARIANT_FIT[name]
        cfg = variant_cfg(name)
        cfg.remat, cfg.grad_accum_samples, cfg.n_epochs = remat, accum, 1
        torch.manual_seed(0)
        cfg, model = build_model(cfg, device=dev)
        _, weight_dict, loss_fn = make_criterion(cfg)
        bank = SubjectBank(BANK)
        bank.add_debug_subject(seed=0, extent=tuple(s * 5 // 6 for s in BANK))
        out_dir = os.path.join(tmp, f"variant_{name}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = train(cfg, model, weight_dict, loss_fn, bank, out_dir,
                      itr_per_epoch=VARIANT_ITR, log_itr=1, val_itr=1,
                      n_val_items=1, seed=0)
        train_s = time.perf_counter() - t0
        steps = _read_steps(out_dir)
        with open(os.path.join(out_dir, "log.txt")) as f:
            epoch = json.loads(f.readline())
        scfg = SynthStatic.from_cfg(cfg)
        knobs = knobs_from_cfg(cfg, scfg, "synth")
        subj = bank.to_device(0, dev)
        gen = torch.Generator(dev).manual_seed(2)
        critic, key = build_critic_from_cfg(cfg, device=dev)
        step_fn = make_train_step(model, cfg, weight_dict, loss_fn,
                                  state.optimizer, sample_accum=accum,
                                  critic=critic, critic_image_key=key)
        timed = _timed_iterations(
            VARIANT_TIMED,
            lambda: make_batch([gen], subj, scfg, cfg.tasks, "synth", knobs),
            lambda b: step_fn(state, b, 1e-4, 1e-2)[1])
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        want = {"joint_age": "train_loss_age", "sep": "train_loss_pathol_ce",
                "critic": "train_loss_implicit_pathol_ce"}[name]
        every = steps + timed
        if len(steps) != VARIANT_ITR or not all(
                np.isfinite(s["loss_total"]) and s["skipped"] == 0
                for s in every):
            bad.append(f"{name}: steps {every}")
        if not (np.isfinite(epoch.get(want, np.nan))
                and np.isfinite(epoch["val_loss_total"])):
            bad.append(f"{name}: epoch {epoch}")
        bad += _kernel_check(launches, name)
        emit({"phase": "variants", "variant": name,
              "size": list(scfg.size), "bank": list(BANK),
              "samples": scfg.all_samples, "tasks": list(cfg.tasks),
              "backbone": cfg.backbone or "unet3d",
              "f_maps": int(cfg.f_maps), "num_levels": int(cfg.num_levels),
              "amp": "bf16", "optimizer": cfg.optimizer, "remat": remat,
              "grad_accum_samples": accum, "itr_per_epoch": VARIANT_ITR,
              "train_s": train_s, "steps": steps, "epoch": epoch,
              "timed": timed, "item_ms": [t["item_ms"] for t in timed],
              "step_ms": [t["step_ms"] for t in timed],
              "iter_ms": [t["iter_ms"] for t in timed], "peak_mem_gib": peak,
              "launches": launches, "gpu": power})
        for k, v in launches.items():
            total[k] += v
        del model, state, step_fn, critic, bank, subj
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"variants phase failed: {bad}")
    return total


def check_twostage_reference(dev):
    """The small two-stage pair (f_maps 8, 3 levels, 32^3, S=2): one
    step's losses and fp64 gradients of both stages, GPU against CPU, as
    variants_reference; then TwoStageInferencer (random weights from seed
    0 on both devices, fp32, TF32 off) on a small procedural head: every
    output within MODEL_TOL of the CPU's, the label maps agreeing on
    SEG_AGREE of the voxels, K2 launched for the GPU's label map."""
    rec = _reference_step("twostage", dev)
    bad = _reference_bad(rec)
    cfg = ref_variant_cfg("twostage")
    vol = procedural_head((32, 32, 32), (1.0, 1.0, 1.0), 5, "cpu")
    gpu = TwoStageInferencer(copy.deepcopy(cfg), device=dev)
    cpu = TwoStageInferencer(copy.deepcopy(cfg), device="cpu")
    kernels.reset_launches()
    og = gpu.evaluate_image(vol, keep_feat=False)
    launches = dict(kernels.LAUNCHES)
    oc = cpu.evaluate_image(vol, keep_feat=False)
    rel = {k: _rel_err(og[k], oc[k]) for k in og if k != "label"}
    agree = float((og["label"].cpu() == oc["label"]).float().mean())
    bad |= {f"serve.{k}": v for k, v in rel.items() if not v <= MODEL_TOL}
    if agree < SEG_AGREE:
        bad["label_agree"] = agree
    if launches["lut_gather_i32"] < 1:
        bad["launches"] = launches
    emit({"phase": "twostage_reference", "size": [32, 32, 32], "f_maps": 8,
          "num_levels": 3, "samples": 2, **_reference_summary(rec),
          "serve_rel_err": rel, "label_agree": agree, "launches": launches,
          "loss_tol": LOSS_TOL, "grad_tol": GRAD_TOL, "model_tol": MODEL_TOL,
          "seg_agree_min": SEG_AGREE})
    if bad:
        raise AssertionError(f"twostage_reference failed: {bad}")


TWOSTAGE_HEADS = {"T1": 1, "T2": 1, "FLAIR": 1, "CT": 1, "segmentation": 56,
                  "label": 1, "pathology": 1}


def run_twostage(dev, power, tmp, root):
    """The training CLI on twostage.yaml with cfgs/generator/train/
    twostage.yaml over the data root `root` (the stream phase's), at
    TWOSTAGE_FIT: one epoch of TWOSTAGE_ITR iterations with validation and
    checkpoints; TRAIN_TIMED stream iterations of the pair timed in two
    parts (item, step); then TwoStageInferencer on the run's ckp/ root
    (bf16) serving one procedural head whole at 220^3: forward_ms (model,
    processors, postprocess with K2 on the label map) after one untimed
    volume. Launch counts over the phase (set to 0 at its start), and by
    part: the CLI, the timed iterations, the served volume."""
    remat, accum = TWOSTAGE_FIT
    gen_yaml = os.path.join(tmp, "twostage_gen.yaml")
    with open(os.path.join(ROOT, "cfgs/generator/train/twostage.yaml")) as f:
        text = f.read()
    with open(gen_yaml, "w") as f:
        f.write(f"{text}\ndata_root: {root[0]}\nsplit_root: {root[1]}\n"
                f"dataset_names: {list(STREAM_DATASETS)}\n")
    out = os.path.join(tmp, "twostage_run")
    args = ["--gen_cfg", gen_yaml, "--train_cfg", "twostage", "--epochs", "1",
            "--itr_per_epoch", str(TWOSTAGE_ITR), "--out_dir", out,
            "--remat", remat, "--grad_accum", str(accum), "--device", str(dev)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _run_cli(args)
    cli_s = time.perf_counter() - t0
    cli_launches = dict(kernels.LAUNCHES)
    with open(os.path.join(out, "log.txt")) as f:
        epoch = json.loads(f.readline())

    cfg = train_script.train_config(gen_yaml, "twostage")
    cfg.remat, cfg.grad_accum_samples = remat, accum
    torch.manual_seed(0)
    cfg, pair = build_inpaint_model(cfg, device=dev)
    _, weight_dict, loss_fn = make_criterion(cfg)
    stream = build_datasets(cfg, cfg.tasks, device=dev)["_concat"]
    state = TrainState(pair, build_optimizer(cfg, pair.parameters()), 0)
    step_fn = make_twostage_train_step(pair, cfg, weight_dict, loss_fn,
                                       state.optimizer, sample_accum=accum)
    items = stream.epoch(0, TRAIN_TIMED, seed=1)

    def item():
        _, target, samples = next(items)
        return stack_items([target], [samples])

    before = dict(kernels.LAUNCHES)
    timed = _timed_iterations(TRAIN_TIMED, item,
                              lambda b: step_fn(state, b, 1e-4, 1e-2)[1])
    timed_launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    del pair, state, step_fn, stream, items
    torch.cuda.empty_cache()

    head = os.path.join(tmp, "twostage_head.nii")
    save_nifti(head, procedural_head(SERVE_SHAPE, SERVE_VOXEL_MM, 20, dev),
               serve_affine(SERVE_SHAPE, SERVE_VOXEL_MM))
    ckp = os.path.join(out, "ckp")
    inf = TwoStageInferencer(cfg, pathol_ckpt=ckp, task_ckpt=ckp,
                             compute_dtype=torch.bfloat16, exact=False,
                             device=dev)
    im = prepare_image(head, list(SERVE_WIN), device=dev)[0]
    inf.evaluate_image(im, keep_feat=False)   # cuDNN's choices, allocator
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.LAUNCHES)
    served, forward_ms = _synced_ms(
        lambda: inf.evaluate_image(im, keep_feat=False))
    serve_launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    peak_serve = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(kernels.LAUNCHES)

    # the CLI logs every 10th step; the epoch line holds every step's mean
    # loss (NaN-free) and the share of skipped steps
    bad = []
    if not all(np.isfinite(t["loss_total"]) and t["skipped"] == 0
               for t in timed):
        bad.append(f"timed {timed}")
    if epoch.get("train_skipped") != 0 or not all(
            np.isfinite(epoch.get(k, np.nan)) for k in (
                "train_loss_total", "train_loss_pathol_ce", "train_loss_T1",
                "val_loss_total")):
        bad.append(f"epoch {epoch}")
    for k, c in TWOSTAGE_HEADS.items():
        v = served.get(k)
        if v is None or tuple(v.shape) != (1, *SERVE_WIN, c) or (
                v.is_floating_point() and not bool(torch.isfinite(v).all())):
            bad.append(f"served {k}: {None if v is None else tuple(v.shape)}")
    p = served["pathology"]
    table = torch.tensor(cfg.label_list_segmentation, dtype=torch.int32,
                         device=dev)
    if not (float(p.min()) >= 0.0 and float(p.max()) <= 1.0) or not bool(
            torch.isin(served["label"], table).all()):
        bad.append("served mask outside [0, 1] or labels outside the table")
    bad += _kernel_check(launches, "twostage")
    if serve_launches["lut_gather_i32"] < 1:
        bad.append(f"served volume missed K2: {serve_launches}")
    emit({"phase": "twostage", "extent": list(STREAM_EXTENT),
          "size": list(cfg.generator.size),
          "samples": int(cfg.generator.all_samples),
          "tasks": list(cfg.tasks), "backbone": cfg.backbone,
          "f_maps": int(cfg.f_maps), "num_levels": int(cfg.num_levels),
          "amp": "bf16", "remat": remat, "grad_accum_samples": accum,
          "itr_per_epoch": TWOSTAGE_ITR, "cli_train_s": cli_s,
          "epoch": epoch, "timed": timed,
          "item_ms": [t["item_ms"] for t in timed],
          "step_ms": [t["step_ms"] for t in timed],
          "iter_ms": [t["iter_ms"] for t in timed],
          "peak_mem_gib": peak_train, "serve_win": list(SERVE_WIN),
          "serve_dtype": "bf16", "forward_ms": forward_ms,
          "peak_mem_gib_serve": peak_serve, "launches_cli": cli_launches,
          "launches_timed": timed_launches, "launches_served": serve_launches,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"twostage phase failed: {bad}")
    return launches


def block_labels(head, seed, block=16):
    """A label map over the head (0 outside it): blocks of `block` voxels,
    each one of EVAL_LABELS' brain labels (a few left-hemisphere ones
    among them)."""
    rng = np.random.default_rng(seed)
    coarse = rng.choice(EVAL_LABELS[7:], [n // block + 1 for n in head.shape])
    idx = np.ix_(*[np.arange(n) // block for n in head.shape])
    return np.where(head > 0, coarse[idx], 0).astype(np.int32)


def eval_inputs(root, n, shape, voxel_mm, seed, dev):
    """n procedural heads under root/data as the evaluation CLI reads them:
    sub<i>.nii.gz, its label map sub<i>.seg.nii.gz (block_labels) and its
    MNI-x map sub<i>.mni_reg.x.nii.gz (a step from -1 to 0.7 across the
    third voxel axis: no resampled value lies near the mask's threshold
    0). Returns the data directory."""
    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    aff = serve_affine(shape, voxel_mm)
    x = np.where(np.arange(shape[2]) < shape[2] // 2, -1.0, 0.7)
    x = (x[None, None] * np.ones(shape)).astype(np.float32)
    for i in range(n):
        head = procedural_head(shape, voxel_mm, seed + i, dev)
        stem = os.path.join(data, f"sub{i}")
        save_nifti(stem + ".nii.gz", head, aff)
        save_nifti(stem + ".seg.nii.gz", block_labels(head, seed + i), aff)
        save_nifti(stem + ".mni_reg.x.nii.gz", x, aff)
    return data


def write_ground_truth(data, setup_dir, n, win, dev):
    """Beside each subject's predictions in `setup_dir`, the ground truth
    the scoring reads: its prepared label map (out_label.gt) and prepared
    image (out_T1.gt)."""
    for i in range(n):
        stem = os.path.join(data, f"sub{i}")
        d = os.path.join(setup_dir, f"sub{i}")
        seg, aff, _, _ = prepare_image(stem + ".seg.nii.gz", list(win),
                                       is_label=True, rescale=False,
                                       device=dev)
        save_nifti(os.path.join(d, "out_label.gt.nii.gz"),
                   seg.cpu().numpy().astype(np.int32), aff)
        im, aff, _, _ = prepare_image(stem + ".nii.gz", list(win),
                                      device=dev)
        save_nifti(os.path.join(d, "out_T1.gt.nii.gz"), im.cpu().numpy(),
                   aff)


def _tree(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


def _score(setup_dir, pattern, metrics, save_dir, dev, is_seg=False,
           gt_suffix=".gt.nii.gz"):
    """The CLI's --pred_glob scoring of setup_dir/*/<pattern>.nii.gz
    against <pattern><gt_suffix> beside each; returns (mean scores, the
    CLI's wall ms)."""
    argv = ["--pred_glob", os.path.join(setup_dir, "*", pattern + ".nii.gz"),
            "--gt_suffix", gt_suffix, "--metrics", *metrics, "--save_dir",
            save_dir, "--device", str(dev)] + (["--is_seg"] if is_seg else [])
    t0 = time.perf_counter()
    eval_cli.main(argv)
    ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(save_dir, "scores.json")) as f:
        return json.load(f)["mean"], ms


def small_yaml(tmp):
    path = os.path.join(tmp, "small_model.yaml")
    with open(path, "w") as f:
        f.write("f_maps: 8\nnum_levels: 3\ntask_f_maps: [8]\n")
    return path


def eval_cfg(*extra):
    """The evaluation CLI's config: the three default YAMLs and `extra`."""
    return load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                        os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
                        os.path.join(ROOT, "cfgs/trainer/default_val.yaml"),
                        *extra])


def check_evaluate_reference(dev, tmp):
    """The evaluation CLI on the GPU and with --device cpu (fp32, TF32
    off): a small model (two .pth files of seeds 0 and 1) over two
    procedural 48^3 heads at 1 mm (a label map that is not resampled
    cannot flip on an fp32 knife edge), --spacings native 2,2,3 with
    --add_bf, hemisphere masking and the atlas. Every written volume
    within MODEL_TOL (labels and masks on SEG_AGREE of the voxels, the
    deformed atlas on ATLAS_AGREE within REPLAY_TOL), the scoring of the
    native setup (seg dice, recon psnr and ssim) within SCORE_TOL
    relative (SCORE_FLOOR says where it turns absolute). Then
    ms_ssim at 176^3, GPU against CPU, and a small train() with vis_itr=1
    against vis_itr=0."""
    root = os.path.join(tmp, "evaluate_reference")
    os.makedirs(root)
    win = (48, 48, 48)
    data = eval_inputs(root, 2, (44, 52, 40), (1.0, 1.0, 1.0), 50, dev)
    atlas = os.path.join(root, "atlas.mgz")
    write_mgz(atlas, procedural_atlas((64, 64, 64), 6, dev), (3.0, 3.0, 3.0))
    small = small_yaml(root)
    models = []
    for i, name in enumerate(("a", "b")):
        torch.manual_seed(i)
        _, model = build_model(eval_cfg(small), device="cpu")
        path = os.path.join(root, f"{name}.pth")
        torch.save({"model": model.state_dict()}, path)
        models.append(f"{name}={path}")
    common = ["--input_glob", os.path.join(data, "sub?.nii.gz"),
              "--models", *models, "--spacings", "native", "2,2,3",
              "--add_bf", "--hemis_seg_suffix", ".seg.nii.gz",
              "--atlas", atlas, "--win", *map(str, win),
              "--train_cfg", small]
    trees = {}
    for label, d in (("gpu", dev), ("cpu", "cpu")):
        out = os.path.join(root, f"out_{label}")
        kernels.reset_launches()
        eval_cli.main([*common, "--save_dir", out, "--device", str(d)])
        if label == "gpu":
            launches = dict(kernels.LAUNCHES)
        trees[label] = (out, d)
    g, c = trees["gpu"][0], trees["cpu"][0]
    bad = {}
    files = _tree(g)
    # per setup and head: the outputs, the deformed atlas, the mask
    if files != _tree(c) or len(files) != 8 * 2 * (len(SERVE_HEADS) + 2):
        bad["files"] = (len(files), len(_tree(c)))
    errs = {}
    for rel in files:
        a = torch.from_numpy(load_nifti(os.path.join(g, rel))[0].copy())
        b = torch.from_numpy(load_nifti(os.path.join(c, rel))[0].copy())
        name = os.path.basename(rel)[:-len(".nii.gz")]
        if name in ("out_label", "hemis_mask"):
            v = float((a == b).float().mean())
            errs[name] = min(errs.get(name, 1.0), v)
            if v < SEG_AGREE:
                bad[rel] = v
        elif name == "out_deformed_atlas":
            v = float(((a - b).abs() <= REPLAY_TOL).float().mean())
            errs[name] = min(errs.get(name, 1.0), v)
            if v < ATLAS_AGREE:
                bad[rel] = v
        else:
            v = _rel_err(a, b)
            errs[name] = max(errs.get(name, 0.0), v)
            if not v <= MODEL_TOL:
                bad[rel] = v
    scores = {}
    for label, (out, d) in trees.items():
        setup = os.path.join(out, "a_1-1-1")
        write_ground_truth(data, setup, 2, win, "cpu")
        seg, _ = _score(setup, "out_label", ["seg_dice"],
                        os.path.join(out, "scores_seg"), d, is_seg=True)
        rec, _ = _score(setup, "out_T1", ["recon_psnr", "recon_ssim"],
                        os.path.join(out, "scores_recon"), d)
        scores[label] = {**seg, **rec}
    score_rel = {k: abs(v - scores["cpu"][k])
                 / max(abs(scores["cpu"][k]), SCORE_FLOOR)
                 for k, v in scores["gpu"].items()}
    bad |= {k: v for k, v in score_rel.items() if not v <= SCORE_TOL}

    # ms_ssim needs 176^3 for its five levels (11 voxels at the coarsest)
    head = torch.from_numpy(procedural_head((176,) * 3, (1.0,) * 3, 9, dev))
    noisy = head + 5 * torch.from_numpy(np.random.default_rng(9)
                                        .standard_normal((176,) * 3)
                                        .astype(np.float32))
    ms = {label: float(ms_ssim_normalized(noisy.to(d), head.to(d)))
          for label, d in (("gpu", dev), ("cpu", "cpu"))}
    ms_rel = abs(ms["gpu"] - ms["cpu"]) / abs(ms["cpu"])
    if not ms_rel <= SCORE_TOL:
        bad["ms_ssim"] = ms

    vis = check_vis_train(dev, root)
    bad |= vis.pop("bad")
    for k in ("warp_linear_f32", "lut_gather_i32"):
        if launches[k] < 1:
            bad["launches"] = launches
    emit({"phase": "evaluate_reference", "win": list(win), "heads": 2,
          "models": 2, "setups": 4, "f_maps": 8, "num_levels": 3,
          "agreement": errs, "scores": scores, "score_rel": score_rel,
          "ms_ssim_176": ms, "ms_ssim_rel": ms_rel, "vis_train": vis,
          "launches": launches, "model_tol": MODEL_TOL,
          "seg_agree_min": SEG_AGREE, "atlas_agree_min": ATLAS_AGREE,
          "score_tol": SCORE_TOL, "score_floor": SCORE_FLOOR})
    if bad:
        raise AssertionError(f"evaluate_reference failed: {bad}")


def check_vis_train(dev, root):
    """A small model (f_maps 8, 3 levels, 32^3) through train() for 2
    steps with vis_itr=1, `visualizer.feat_vis` and `make_results`, and
    again with vis_itr=0: the montages, feature strips and NIfTI dumps
    written, the losses within VIS_LOSS_TOL. Returns a record with 'bad'."""
    cfg = small_model_cfg()
    cfg.num_levels, cfg.generator.size = 3, [32, 32, 32]
    cfg.n_epochs, cfg.remat = 1, False
    cfg.visualizer.feat_vis, cfg.visualizer.make_results = True, True
    bank = SubjectBank((48, 48, 48))
    bank.add_debug_subject(seed=0, extent=(40, 40, 40))
    steps, epoch = {}, {}
    for vis in (1, 0):
        torch.manual_seed(0)
        c, model = build_model(copy.deepcopy(cfg), device=dev)
        _, w, fn = make_criterion(c)
        out = os.path.join(root, f"vis_train_{vis}")
        train(c, model, w, fn, bank, out, itr_per_epoch=2, n_val_items=1,
              log_itr=1, vis_itr=vis, seed=0)
        steps[vis] = _read_steps(out)
        with open(os.path.join(out, "log.txt")) as f:
            line = json.loads(f.readline())
        # the epoch's mean losses, at full precision (train.log rounds)
        epoch[vis] = {k: v for k, v in line.items()
                      if k.startswith(("train_loss", "val_loss"))}
    files = _tree(os.path.join(root, "vis_train_1"))
    want = {"vis/vis_0000000.png", "vis/vis_0000001.png",
            "vis_feat/feat_0000000.png", "vis_feat/feat_0000001.png",
            "vis/results_1/input.nii.gz", "vis/results_1/pd_T1.nii.gz",
            "vis/results_1/gt_T1.nii.gz"}
    rel = max(abs(v - epoch[0][k]) / max(abs(epoch[0][k]), 1e-30)
              for k, v in epoch[1].items())
    bad = {}
    if not want <= set(files):
        bad["vis_files"] = sorted(want - set(files))
    if (epoch[1].keys() != epoch[0].keys() or not rel <= VIS_LOSS_TOL
            or [len(steps[v]) for v in (1, 0)] != [2, 2]
            or any(st["skipped"] for v in (1, 0) for st in steps[v])):
        bad["vis_losses"] = {"epoch": epoch, "steps": steps}
    return {"epoch_losses": epoch, "loss_rel": rel,
            "vis_files": [f for f in files if f.startswith("vis")],
            "bad": bad}


def run_evaluate(dev, power, tmp, ckpt):
    """The evaluation CLI on the L6 f_maps-64 weights `ckpt` over
    EVAL_HEADS procedural head(s) (SERVE_SHAPE at SERVE_VOXEL_MM, a
    non-RAS affine) at the 220^3 window in bf16: --spacings native
    1.5,1.5,5 --add_bf (4 setups), hemisphere masking, the 256^3
    procedural atlas, every output written as .nii.gz; then the scoring
    of the native setup's out_label (dice over the 33 evaluation labels,
    one-hot through K2) and out_T1 (psnr, ssim, ms_ssim at 220^3), one
    CLI run per metric; the random model's out_T1 is uncorrelated with the
    head (its ms_ssim clamps to 0), so out_T1 is also scored by ms_ssim
    against the same model's out_T1 under the bias field (the prediction's
    consistency, which must not be 0). Launch counts of the serving and of
    the scoring (the ground truth's prepares left out), peak memory over
    the phase."""
    root = os.path.join(tmp, "evaluate")
    os.makedirs(root)
    data = eval_inputs(root, EVAL_HEADS, SERVE_SHAPE, SERVE_VOXEL_MM, 40, dev)
    atlas = os.path.join(root, "atlas.mgz")
    write_mgz(atlas, procedural_atlas(ATLAS_SHAPE, 7, dev))
    out = os.path.join(root, "out")
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    eval_cli.main(["--input_glob", os.path.join(data, "sub?.nii.gz"),
                   "--gen_cfg", os.path.join(ROOT, "cfgs/generator/train/"
                                                   "brain_id.yaml"),
                   "--train_cfg", os.path.join(ROOT, "cfgs/trainer/train/"
                                                     "joint.yaml"),
                   "--models", f"joint={ckpt}", "--spacings", "native",
                   ",".join(str(v) for v in EVAL_SPACING), "--add_bf",
                   "--hemis_seg_suffix", ".seg.nii.gz", "--atlas", atlas,
                   "--bf16", "--device", str(dev), "--save_dir", out],
                  stats=stats)
    infer_s = time.perf_counter() - t0
    serve_launches = dict(kernels.LAUNCHES)
    peak_serve = torch.cuda.max_memory_allocated() / 2 ** 30

    bad = []
    tags = [eval_cli.setup_tag("joint", sp, bf) for sp, bf in
            eval_cli.parse_setups(["native", ",".join(
                str(v) for v in EVAL_SPACING)], [False, True])]
    want = sorted([f"out_{k}.nii.gz" for k in SERVE_HEADS]
                  + ["out_deformed_atlas.nii.gz", "hemis_mask.nii.gz"])
    for tag in tags:
        for i in range(EVAL_HEADS):
            got = sorted(os.listdir(os.path.join(out, tag, f"sub{i}")))
            if got != want:
                bad.append(f"{tag}/sub{i}: {got}")

    setup = os.path.join(out, "joint_1-1-1")
    write_ground_truth(data, setup, EVAL_HEADS, SERVE_WIN, dev)
    for i in range(EVAL_HEADS):
        shutil.copyfile(
            os.path.join(out, "joint_BF_1-1-1", f"sub{i}", "out_T1.nii.gz"),
            os.path.join(setup, f"sub{i}", "out_T1.bf.nii.gz"))
    kernels.reset_launches()
    scores, score_ms = {}, {}
    for key, metric, pattern, seg, gt in (
            ("seg_dice", "seg_dice", "out_label", True, ".gt.nii.gz"),
            ("recon_psnr", "recon_psnr", "out_T1", False, ".gt.nii.gz"),
            ("recon_ssim", "recon_ssim", "out_T1", False, ".gt.nii.gz"),
            ("recon_ms_ssim", "recon_ms_ssim", "out_T1", False,
             ".gt.nii.gz"),
            ("recon_ms_ssim_vs_bf", "recon_ms_ssim", "out_T1", False,
             ".bf.nii.gz")):
        mean, score_ms[key] = _score(
            setup, pattern, [metric], os.path.join(root, f"scores_{key}"),
            dev, is_seg=seg, gt_suffix=gt)
        scores[key] = mean[metric]
    score_launches = dict(kernels.LAUNCHES)
    launches = {k: v + score_launches[k] for k, v in serve_launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    if not all(np.isfinite(v) for v in scores.values()):
        bad.append(f"scores {scores}")
    if not scores["recon_ms_ssim_vs_bf"] > 0:
        bad.append(f"degenerate ms_ssim of out_T1 against its bias-field "
                   f"twin: {scores}")
    for k in ("warp_linear_f32", "lut_gather_i32") + GN_FORWARD:
        if launches[k] < 1:
            bad.append(f"evaluate path missed {k}: {launches}")
    emit({"phase": "evaluate", "heads": EVAL_HEADS, "win": list(SERVE_WIN),
          "input_shape": list(SERVE_SHAPE), "voxel_mm": list(SERVE_VOXEL_MM),
          "setups": tags, "dtype": "bf16", "written": "every output, .nii.gz",
          "infer_s": infer_s,
          "volume_ms": {t: [v["volume_ms"] for v in stats[t]] for t in tags},
          "prepare_ms": {t: [v["prepare_ms"] for v in stats[t]] for t in tags},
          "forward_ms": {t: [v["forward_ms"] for v in stats[t]] for t in tags},
          "write_ms": {t: [v["write_ms"] for v in stats[t]] for t in tags},
          "score_ms": score_ms, "scores": scores,
          "peak_mem_gib": peak, "peak_mem_gib_serve": peak_serve,
          "launches_serve": serve_launches, "launches_score": score_launches,
          "launches": launches,
          "gpu": power})
    if bad:
        raise AssertionError(f"evaluate phase failed: {bad}")
    return launches


def run_numerics(dev, power):
    """The interpol family, synth_intensities and odeint_adjoint on the
    card against the CPU: grid_pull, grid_push and grid_grad at 64^3
    (orders 1 and 3, bounds zero and dct2), resize_spline (x1.5, order 3,
    prefiltered) and restrict_spline (x0.5) at fp64 within NUMERICS_TOL;
    synth_intensities with injected noise bitwise its plain version (K2
    f32 on the card; its launches are this path's); odeint_adjoint rk4
    values and fp64 gradients. Then device times (CUDA events) of fp32
    grid_pull and grid_push at 160^3, C=1, orders 1 and 3, and of
    synth_intensities at 192^3. Returns the path's launches."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((64, 64, 64)))
    grid = torch.from_numpy(rng.uniform(-2.0, 65.0, (64, 64, 64, 3)))
    errs = {}
    for order in (1, 3):
        for bound in ("zero", "dct2"):
            kw = dict(interpolation=order, bound=bound)
            for name, fn in (
                    ("pull", lambda i, gr: grid_pull(i, gr, **kw)),
                    ("push", lambda i, gr: grid_push(i, gr, (64, 64, 64),
                                                     **kw)),
                    ("grad", lambda i, gr: grid_grad(i, gr, **kw))):
                errs[f"{name} order {order} {bound}"] = _rel_err(
                    fn(img.to(dev), grid.to(dev)), fn(img, grid))
    errs["resize_spline"] = _rel_err(
        resize_spline(img.to(dev), factor=1.5, interpolation=3),
        resize_spline(img, factor=1.5, interpolation=3))
    errs["restrict_spline"] = _rel_err(
        restrict_spline(img.to(dev), factor=0.5, interpolation=3),
        restrict_spline(img, factor=0.5, interpolation=3))

    # odeint_adjoint, rk4: values and fp64 gradients in y0 and k
    def ode(d):
        y0 = torch.from_numpy(rng_y0).to(d).requires_grad_()
        k = torch.tensor(0.7, dtype=torch.float64, device=d,
                         requires_grad=True)
        out = odeint_adjoint(lambda t, y: -k * y + float(np.sin(t)) * y ** 2,
                             y0, np.linspace(0.0, 1.0, 6), method="rk4")
        (out[-1] ** 2).sum().backward()
        return out.detach(), y0.grad, k.grad

    rng_y0 = rng.standard_normal((16, 16, 16))
    for name, a, b in zip(("odeint", "odeint_grad_y0", "odeint_grad_k"),
                          ode(dev), ode("cpu")):
        errs[name] = _rel_err(a, b)

    lab = torch.from_numpy(rng.choice(np.array(
        [0, 2, 3, 4, 41, 77, 120, 251, 255, 300], np.int32), (64, 64, 64)))
    mus = torch.from_numpy((25 + 200 * rng.random(256)).astype(np.float32))
    sig = torch.from_numpy((5 + 20 * rng.random(256)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((64, 64, 64))
                             .astype(np.float32))
    kernels.reset_launches()
    got = synth_intensities(Draws(), lab.to(dev), mus.to(dev), sig.to(dev),
                            noise=noise.to(dev))
    launches = dict(kernels.LAUNCHES)
    want = synth_intensities(Draws(), lab, mus, sig, noise=noise)
    intens_err = _max_err(got, want)

    # device times, fp32, C=1
    g = torch.Generator(dev).manual_seed(0)
    n = 160
    v160 = torch.randn((n, n, n), generator=g, device=dev)
    g160 = torch.rand((n, n, n, 3), generator=g, device=dev) * (n - 1)
    times = {}
    for order in (1, 3):
        times[f"grid_pull order {order}"] = time_ms(
            lambda o=order: grid_pull(v160, g160, o, "dct2"), reps=5,
            warmup=1)
        times[f"grid_push order {order}"] = time_ms(
            lambda o=order: grid_push(v160, g160, (n, n, n), o, "dct2"),
            reps=5, warmup=1)
    lab192 = torch.randint(0, 256, BANK, generator=g, device=dev,
                           dtype=torch.int32)
    mus_d, sig_d = mus.to(dev), sig.to(dev)
    times["synth_intensities 192^3"] = time_ms(
        lambda: synth_intensities(Draws(g, dev), lab192, mus_d, sig_d),
        reps=10)
    bad = {k: v for k, v in errs.items() if not v <= NUMERICS_TOL}
    if intens_err != 0:
        bad["synth_intensities"] = intens_err
    if launches["lut_gather_f32"] < 1:
        bad["launches"] = launches
    emit({"phase": "numerics_reference", "size": [64, 64, 64],
          "rel_err": errs, "synth_intensities_max_abs_err": intens_err,
          "numerics_tol": NUMERICS_TOL, "ms": times, "time_size": [n] * 3,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"numerics_reference failed: {bad}")
    return launches


# ------------------------------------------------------------- multi-GPU

def _free_port() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _wait_all(procs, timeout, what):
    """Wait for every process (killing the rest on a failure or at the
    deadline); raise with the output tail of a process that failed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what} process {i} exit {p.returncode}:\n"
                                 f"{out[-6000:]}")
    return outs


def mgpu_cfg():
    """The flagship config cut to the multigpu_reference model: L6,
    f_maps MGPU_F_MAPS, MGPU_SIZE, no autocast."""
    cfg = flagship_cfg()
    cfg.f_maps, cfg.task_f_maps = MGPU_F_MAPS, [MGPU_F_MAPS]
    cfg.generator.size = list(MGPU_SIZE)
    cfg.amp, cfg.remat = False, False
    return process_args(cfg)


def mgpu_batch(cfg, dev):
    """A random fp64 train batch of one item, S=2, on `dev`."""
    B, S = 1, 2
    rng = np.random.default_rng(3)
    size = tuple(cfg.generator.size)
    lab = rng.integers(0, cfg.n_labels, (B, 1, *size))
    b = {"samples": {"input": rng.random((B, S, *size, 1)),
                     "bias_field_log": 0.1 * rng.standard_normal(
                         (B, S, *size, 1))},
         "targets": {"T1": rng.random((B, 1, *size, 1)),
                     "segmentation": np.eye(cfg.n_labels)[lab],
                     "distance": rng.uniform(-2.5, 2.5, (B, 1, *size, 4)),
                     "registration": rng.standard_normal((B, 1, *size, 3))}}
    return {k: {kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()}
            for k, v in b.items()}


def _mgpu_loss_grads(model, cfg, batch, mesh):
    """The train step's loss and this rank's gradient share (summed over
    the world by the caller), or the whole without a mesh."""
    from brainfm_tpu_torch.parallel.mesh import axis_size

    _, w, fn = make_criterion(cfg)
    model.zero_grad(set_to_none=True)
    total = weighted_total(batch_losses(model, cfg, fn, batch, amp=False,
                                        mesh=mesh), w)
    scale = 1.0 if mesh is None else 1.0 / (axis_size(mesh, "data")
                                            * axis_size(mesh, "space"))
    (total * scale).backward()
    return float(total), {k: p.grad.detach().clone()
                          for k, p in model.named_parameters()}


def _mgpu_unet(dev, mesh, rank):
    """Check 1: the space-sharded L6 step at fp64 against the same model
    unsharded on the card (rank 0), with the kernels' launches of the
    sharded step and the model's number of GroupNorms (each one K4 launch
    in the forward, sharded or whole)."""
    cfg = mgpu_cfg()
    torch.manual_seed(0)
    _, model = build_model(cfg, device=dev)
    model.double()
    batch = mgpu_batch(cfg, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss, grads = _mgpu_loss_grads(model, cfg, batch, mesh)
    for g in grads.values():
        torch.distributed.all_reduce(g)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3
    out = {"loss": loss, "step_ms": sharded_ms,
           "launches": dict(kernels.LAUNCHES),
           "group_norms": sum(isinstance(m, torch.nn.GroupNorm)
                              for m in model.modules())}
    if rank == 0:
        t0 = time.perf_counter()
        ref_loss, ref = _mgpu_loss_grads(model, cfg, batch, None)
        torch.cuda.synchronize()
        out["unsharded_ms"] = (time.perf_counter() - t0) * 1e3
        keys = sorted(ref)
        a = torch.cat([grads[k].flatten() for k in keys])
        b = torch.cat([ref[k].flatten() for k in keys])
        out["loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
        out["grad_rel_l2"] = float((a - b).norm() / b.norm())
        per = {k: float((grads[k] - ref[k]).norm()
                        / max(float(ref[k].norm()), 1e-300)) for k in keys}
        out["tensor_rel_l2_max"] = max(per.values())
        out["tensor_rel_l2_argmax"] = max(per, key=per.get)
    return out


def _tensor_hashes(batch, row=None):
    import hashlib

    out = {}
    for part in ("targets", "samples"):
        for k, v in batch[part].items():
            a = v.detach().cpu().numpy()
            if row is not None:
                a = a[row:row + 1]
            out[f"{part}.{k}"] = hashlib.sha256(
                np.ascontiguousarray(a).tobytes()).hexdigest()
    return out


def _mgpu_synth_setup(dev):
    from brainfm_tpu_torch.synth.datasets import item_generator

    cfg = process_args(flagship_cfg())
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank(BANK)
    bank.add_debug_subject(seed=0)
    gens = [item_generator(0, 0, i, dev) for i in range(MGPU_WORLD)]
    return cfg, scfg, bank.to_device(0, dev), gens, knobs_from_cfg(
        cfg, scfg, "synth")


def _mgpu_synth(dev, mesh):
    """Check 2: this rank's flagship item by per-rank synthesis; its
    tensors' hashes (held by the parent against its serial batch) and the
    kernels' launches on the rank."""
    from brainfm_tpu_torch.synth.sharded import sharded_synth_batch

    cfg, scfg, subj, gens, knobs = _mgpu_synth_setup(dev)
    # warm-up (handles, allocator) on other generators
    from brainfm_tpu_torch.synth.datasets import item_generator

    sharded_synth_batch(mesh, [item_generator(9, 0, i, dev)
                               for i in range(MGPU_WORLD)], subj, scfg,
                        cfg.tasks, "synth", knobs)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    batch = sharded_synth_batch(mesh, gens, subj, scfg, cfg.tasks, "synth",
                                knobs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    return {"hashes": _tensor_hashes(batch), "item_ms": ms,
            "launches": launches,
            "rows": int(batch["samples"]["input"].shape[0])}


def _serve_compare(got, ref):
    return ({k: _rel_err(got[k], ref[k]) for k in ref if k != "label"},
            float((got["label"] == ref["label"]).float().mean()))


def _mgpu_serve(dev, mesh, pth, rank):
    """Check 3: the slice's weights serving one procedural head over
    space=2. In bf16 at SERVE_WIN (timed, peak memory per rank), held
    beside rank 0 serving it alone and beside rank 0 serving the head
    scaled by 1 + 2^-20 (the bf16 model's own noise floor); then at fp64
    at MGPU_EXACT_WIN against rank 0 alone, the gate."""
    def make(dtype, exact):
        return Inferencer(flagship_cfg(), ckpt_path=pth, compute_dtype=dtype,
                          exact=exact, device=dev, mesh=mesh)

    def alone(inf, x):   # rank 0 serves x without the mesh
        inf.mesh = None
        out = inf.evaluate_image(x, keep_feat=False)
        torch.cuda.synchronize()
        inf.mesh = mesh
        return out

    inf = make(torch.bfloat16, False)
    vol = procedural_head(SERVE_WIN, (1.0, 1.0, 1.0), 21, dev)
    inf.evaluate_image(vol, keep_feat=False)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = inf.evaluate_image(vol, keep_feat=False)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3,
           "launches": dict(kernels.LAUNCHES),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "shape": list(got["label"].shape),
           "finite": all(bool(torch.isfinite(v.float()).all())
                         for v in got.values())}
    if rank != 0:
        del got
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        alone(inf, vol)   # warm-up alone
        t0 = time.perf_counter()
        ref = alone(inf, vol)
        out["single_ms"] = (time.perf_counter() - t0) * 1e3
        out["bf16_rel_err"], out["bf16_label_agree"] = _serve_compare(got,
                                                                      ref)
        del got
        nudged = alone(inf, vol * np.float32(1 + 2 ** -20))
        out["bf16_floor_rel_err"], out["bf16_floor_label_agree"] = \
            _serve_compare(nudged, ref)
        del nudged, ref
    del inf
    torch.cuda.empty_cache()
    torch.distributed.barrier()

    inf = make(torch.float64, True)
    vol = procedural_head(MGPU_EXACT_WIN, (1.0, 1.0, 1.0), 22, dev)
    got = inf.evaluate_image(vol, keep_feat=False)
    torch.cuda.synchronize()
    if rank != 0:
        del got, inf
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        out["fp64_rel_err"], out["fp64_label_agree"] = _serve_compare(
            got, alone(inf, vol))
        del got, inf
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    return out


def _mgpu_slab_gn(dev, mesh, rank):
    """Check 4: this rank's D slab of one bf16 1 x GN_F_MAPS x SERVE_WIN
    tensor (the same on every rank) through fused_group_norm with the
    space group, against the unsharded function of the whole tensor,
    sliced: within one bf16 ulp, or GN_BF16_ATOL near 0 (the rule of
    tests/test_torch_parallel.py); and K3 on the slab against its plain
    version (GN_SUMS_RTOL)."""
    from brainfm_tpu_torch.parallel.mesh import axis_size, local_slice

    g = torch.Generator(dev).manual_seed(4)
    x = (torch.randn((1, GN_F_MAPS, *SERVE_WIN), generator=g, device=dev)
         + 0.5).to(torch.bfloat16)
    w = torch.linspace(0.5, 1.5, GN_F_MAPS, device=dev)
    b = torch.linspace(-0.2, 0.2, GN_F_MAPS, device=dev)
    n = axis_size(mesh, "space")
    slab = local_slice(x, n, rank, 2).contiguous()
    want = local_slice(groupnorm.fused_group_norm(x, w, b, 8), n, rank, 2)
    del x
    got = groupnorm.fused_group_norm(slab, w, b, 8,
                                     group=mesh.get_group("space"))
    ulp = 2.0 ** -7 * torch.maximum(got.float().abs(), want.float().abs())
    excess = float(((got.float() - want.float()).abs() - ulp).max())
    sums, plain = groupnorm.chan_sums(slab), groupnorm.chan_sums_plain(slab)
    return {"shape": list(slab.shape), "dtype": str(got.dtype),
            "ulp_excess_max": excess,
            "sums_rel_err": float((sums - plain).abs().max()
                                  / plain.abs().max())}


def multigpu_rank(rank, world, port, out_path, pth):
    """One rank of multigpu_reference (a process of its own on the card)."""
    import faulthandler

    from brainfm_tpu_torch.parallel import init_distributed, make_mesh

    faulthandler.enable()   # a crashed rank shows where

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", world, rank, backend=MGPU_BACKEND)
    dev = torch.device("cuda", torch.cuda.current_device())
    space = make_mesh(1, world, device_type="cuda")
    data = make_mesh(world, 1, device_type="cuda")
    res = {"rank": rank, "backend": torch.distributed.get_backend()}
    # No FSDP check here: two ranks of FSDP2 over gloo on CUDA segfault on
    # the H100 (a 2-layer Linear and the L3 joint model, fp32 and fp64, at
    # the latest in DTensor.full_tensor: brainfm_tpu_torch/scripts/
    # probe_fsdp_gloo.py), so FSDP2 against the replicated step stays with
    # the CPU test (tests/test_torch_fsdp.py); the multigpu phase runs
    # FSDP2 on NCCL.
    checks = [("unet", lambda: _mgpu_unet(dev, space, rank)),
              ("synth", lambda: _mgpu_synth(dev, data)),
              ("serve", lambda: _mgpu_serve(dev, space, pth, rank)),
              ("slab_gn", lambda: _mgpu_slab_gn(dev, space, rank))]
    for name, check in checks:
        print(f"rank {rank}: {name}", flush=True)
        res[name] = check()
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def check_multigpu_reference(dev, power, pth, tmp):
    """MGPU_WORLD ranks, each a process of this script on the one card
    (cuda:0), in a gloo process group (MGPU_BACKEND): the space-sharded
    fp64 step against the unsharded one, one flagship item per rank by
    per-rank synthesis against this process's serial batch (bitwise),
    and the slice's model serving a head over space=2 (bf16 at SERVE_WIN,
    fp64 at MGPU_EXACT_WIN) against one rank alone (_mgpu_serve). The
    kernels' libraries are built by this process before the spawn.
    Returns the launches summed over the ranks."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)
    outs = [os.path.join(tmp, f"mgpu_rank{r}.json")
            for r in range(MGPU_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(MGPU_WORLD), "--port", port, "--out", outs[r],
         "--pth", pth], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(MGPU_WORLD)]
    _wait_all(procs, MGPU_TIMEOUT, "multigpu_reference rank")
    ranks_s = time.perf_counter() - t0
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))

    # the serial batch of the same per-item generators, in this process
    cfg, scfg, subj, gens, knobs = _mgpu_synth_setup(dev)
    serial = make_batch(gens, subj, scfg, cfg.tasks, "synth", knobs)
    synth_equal = [res[r]["synth"]["hashes"] == _tensor_hashes(serial, r)
                   for r in range(MGPU_WORLD)]
    del serial, subj
    torch.cuda.empty_cache()

    launches = {k: sum(r[c]["launches"][k] for r in res
                       for c in ("unet", "synth", "serve"))
                for k in kernels.LAUNCHES}
    u, sv = res[0]["unet"], res[0]["serve"]
    bad = {}
    if not (u["loss_rel"] <= MGPU_LOSS_TOL and u["grad_rel_l2"]
            <= MGPU_GRAD_TOL and u["tensor_rel_l2_max"] <= MGPU_TENSOR_TOL):
        bad["unet"] = u
    if not all(synth_equal) or any(r["synth"]["rows"] != 1 for r in res):
        bad["synth_equal"] = synth_equal
    if not all(v <= MODEL_TOL for v in sv["fp64_rel_err"].values()) \
            or sv["fp64_label_agree"] < SEG_AGREE or not sv["finite"]:
        bad["serve"] = sv
    for r in res:
        sl, ul, vl = (r[c]["launches"] for c in ("synth", "unet", "serve"))
        # every GroupNorm of the sharded step through K4 once, sharded
        # levels included; K3 and K5 in its backward; K3 and K4 serving
        if sl["warp_linear_f32"] < 1 or sl["lut_gather_i32"] < 1 \
                or sl["lut_gather_f32"] < 1 or vl["lut_gather_i32"] < 1 \
                or ul["chan_affine"] != r["unet"]["group_norms"] \
                or ul["chan_sums"] < 1 or ul["chan_affine3"] < 1 \
                or vl["chan_sums"] < 1 or vl["chan_affine"] < 1:
            bad[f"rank{r['rank']}_launches"] = [sl, ul, vl]
        gn = r["slab_gn"]
        if gn["dtype"] != "torch.bfloat16" or not gn["ulp_excess_max"] \
                <= GN_BF16_ATOL or not gn["sums_rel_err"] <= GN_SUMS_RTOL:
            bad[f"rank{r['rank']}_slab_gn"] = gn
    emit({"phase": "multigpu_reference", "ranks": MGPU_WORLD,
          "backend": res[0]["backend"],
          "backend_why": "two ranks share one card; NCCL refuses that",
          "unet": {"size": list(MGPU_SIZE), "f_maps": MGPU_F_MAPS,
                   "num_levels": 6, "dtype": "float64", **u,
                   "loss_tol": MGPU_LOSS_TOL, "grad_tol": MGPU_GRAD_TOL,
                   "tensor_tol": MGPU_TENSOR_TOL,
                   "launches_per_rank": [r["unet"]["launches"]
                                         for r in res]},
          "synth": {"bitwise_serial": synth_equal,
                    "item_ms": [r["synth"]["item_ms"] for r in res],
                    "launches_per_rank": [r["synth"]["launches"]
                                          for r in res]},
          "serve": {"win": list(SERVE_WIN), "dtype": "bfloat16",
                    "space": MGPU_WORLD,
                    "ms": [r["serve"]["ms"] for r in res],
                    "single_ms": sv["single_ms"],
                    "peak_mem_gib": [r["serve"]["peak_mem_gib"]
                                     for r in res],
                    "bf16_rel_err": sv["bf16_rel_err"],
                    "bf16_label_agree": sv["bf16_label_agree"],
                    "bf16_floor_rel_err": sv["bf16_floor_rel_err"],
                    "bf16_floor_label_agree": sv["bf16_floor_label_agree"],
                    "fp64_win": list(MGPU_EXACT_WIN),
                    "fp64_rel_err": sv["fp64_rel_err"],
                    "fp64_label_agree": sv["fp64_label_agree"],
                    "model_tol": MODEL_TOL, "seg_agree_min": SEG_AGREE,
                    "launches_per_rank": [r["serve"]["launches"]
                                          for r in res]},
          "slab_gn": {"per_rank": [r["slab_gn"] for r in res],
                      "ulp_excess_tol": GN_BF16_ATOL,
                      "sums_rtol": GN_SUMS_RTOL},
          "fsdp": "with the CPU test: FSDP2 over gloo on CUDA segfaulted",
          "ranks_s": ranks_s, "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"multigpu_reference failed: {bad}")
    return launches


def cli_timed(out_json, args):
    """scripts/train.py::main(args) with every train step and every
    per-rank batch synthesis timed (each ended by a synchronize); writes
    {steps, launches, peak_mem_gib, stdout} to out_json."""
    from brainfm_tpu_torch.synth.datasets import SynthDataset
    from brainfm_tpu_torch.train import loop

    steps, items = [], []
    make, get = loop.make_train_step, SynthDataset.get_batch_sharded

    def timed_get(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = get(self, *a, **k)
        torch.cuda.synchronize()
        items.append((time.perf_counter() - t0) * 1e3)
        return b

    def timed_make(*a, **k):
        step = make(*a, **k)

        def run(state, batch, lr, wd):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, lr, wd)
            torch.cuda.synchronize()
            steps.append({"step_ms": (time.perf_counter() - t0) * 1e3,
                          "loss_total": float(m["loss_total"]),
                          "skipped": int(m["skipped"])})
            return state, m
        return run

    loop.make_train_step = timed_make
    SynthDataset.get_batch_sharded = timed_get
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    text = _run_cli(args)
    res = {"steps": steps, "item_ms": items,
           "launches": dict(kernels.LAUNCHES),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "stdout": text[-4000:]}
    with open(out_json, "w") as f:
        json.dump(res, f)
    return 0


def run_multigpu(dev, power, root, tmp, stream_figs):
    """The training CLI with the flagship configs on the stream phase's
    data root, launched as torchrun launches one rank (RANK=0,
    WORLD_SIZE=1, NCCL) with --mesh 1 --fsdp: MULTIGPU_WARM iterations,
    then MULTIGPU_TIMED timed ones (the per-rank item, the step), beside
    the single-device stream phase's figures. The run that reaches
    init_distributed's environment path, NCCL and FSDP2 at full width."""
    gen_yaml = os.path.join(tmp, "mgpu_gen.yaml")
    with open(os.path.join(ROOT, "cfgs/generator/train/brain_id.yaml")) as f:
        text = f.read()
    with open(gen_yaml, "w") as f:
        f.write(f"{text}\ndata_root: {root[0]}\nsplit_root: {root[1]}\n"
                f"dataset_names: {list(STREAM_DATASETS)}\n")
    out = os.path.join(tmp, "mgpu_run")
    n = MULTIGPU_WARM + MULTIGPU_TIMED
    args = ["--gen_cfg", gen_yaml, "--train_cfg", "joint", "--epochs", "1",
            "--itr_per_epoch", str(n), "--out_dir", out, "--remat",
            TRAIN_REMAT, "--grad_accum", str(TRAIN_ACCUM), "--mesh", "1",
            "--fsdp"]
    res_path = os.path.join(tmp, "mgpu_cli.json")
    # the run peaks at the stream phase's 58 GiB beside this process on
    # the card; expandable segments keep FSDP2's and remat's differently
    # sized blocks from fragmenting the rest (one run without them failed
    # to find 5.9 GiB with 10.9 GiB reserved and unallocated)
    gc.collect()
    torch.cuda.empty_cache()
    parent_gib = torch.cuda.memory_reserved() / 2 ** 30
    env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=_free_port(),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli-timed", res_path,
         "--", *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True)
    _wait_all([proc], MGPU_TIMEOUT, "multigpu CLI")
    cli_s = time.perf_counter() - t0
    with open(res_path) as f:
        res = json.load(f)
    timed = [{"item_ms": i, **s} for i, s in zip(res["item_ms"][-MULTIGPU_TIMED:],
                                                 res["steps"][-MULTIGPU_TIMED:])]
    for t in timed:
        t["iter_ms"] = t["item_ms"] + t["step_ms"]
    launches = res["launches"]
    bad = []
    if len(res["steps"]) != n or not all(
            np.isfinite(s["loss_total"]) and s["skipped"] == 0
            for s in res["steps"]):
        bad.append(f"steps {res['steps']}")
    if f"final step {n}" not in res["stdout"]:
        bad.append(res["stdout"][-1500:])
    if launches["warp_linear_f32"] < 1 or launches["lut_gather_i32"] < 1 \
            or launches["lut_gather_f32"] < 1 \
            or missed(launches, names=GN_KERNELS):
        bad.append(f"path missed a kernel: {launches}")
    if not os.path.isdir(os.path.join(out, "ckp", f"ckpt_{n:06d}")):
        bad.append("no checkpoint")
    emit({"phase": "multigpu", "mesh": "1 (data) x 1 (space)", "fsdp": True,
          "backend": "nccl", "launch": "RANK=0 WORLD_SIZE=1 (torchrun env)",
          "size": list(flagship_cfg().generator.size), "amp": "bf16",
          "remat": TRAIN_REMAT, "iterations": n, "timed": timed,
          "item_ms": [t["item_ms"] for t in timed],
          "step_ms": [t["step_ms"] for t in timed],
          "iter_ms": [t["iter_ms"] for t in timed],
          "peak_mem_gib": res["peak_mem_gib"],
          "single_device_stream": stream_figs, "cli_s": cli_s,
          "parent_reserved_gib": parent_gib,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"multigpu phase failed: {bad}")
    return launches


def run_roofline(dev, power):
    """The roofline twin (brainfm_tpu_torch/scripts/roofline.py) in this
    process: the delivered matmul, conv, elementwise and GroupNorm-chain
    rates, then the FLOP counts of the 220^3 forward and the bench's two
    train steps. No rate may pass ROOFLINE_MARGIN of the data sheet's
    peak: no card delivers that, so such a reading is a timing fault."""
    from brainfm_tpu_torch.scripts import roofline

    recs = [{"probe": name, "kind": kind, **rec}
            for kind, gen in (("rate", roofline.probes(dev)),
                              ("flops", roofline.flop_counts(dev)))
            for name, rec in gen]
    bad = [r["probe"] for r in recs for k, peak in roofline.PEAK.items()
           if k in r and not 0 < r[k] <= ROOFLINE_MARGIN * peak]
    bad += [r["probe"] for r in recs if r["kind"] == "flops"
            and not r["flops"] > 0]
    emit({"phase": "roofline", "peak": roofline.PEAK,
          "margin": ROOFLINE_MARGIN, "probes": recs, "gpu": power})
    if bad:
        raise AssertionError(f"roofline readings out of bounds: {bad}")


def run_bench(power, figures):
    """`python -m brainfm_tpu_torch.bench` as a child process at full size:
    its standard output holds only contract lines, the last with a finite
    value above 0; its summary (the last line of standard error) has every
    key of the root bench's summary, no failed stage, min <= median <= max
    for every timed key, and the generator stage launched K1 linear, K1
    nearest and K2 f32 once per item and K2 i32 once or twice (with the
    vflip). Its whole-volume and generator clocks are printed beside the
    serve phase's forward and the slice's item (`figures`), not gated.
    Returns the bench's launches over its timed calls."""
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-m", "brainfm_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    bad = []
    if proc.returncode != 0:
        bad.append(f"exit {proc.returncode}: {proc.stderr[-3000:]}")
    contract = []
    for line in proc.stdout.splitlines():
        try:
            contract.append(json.loads(line))
        except json.JSONDecodeError:
            bad.append(f"not a contract line: {line[:200]!r}")
    if not contract or any(
            not isinstance(c, dict)
            or set(c) != {"metric", "value", "unit", "vs_baseline"}
            or c["metric"] != "inference_vols_per_sec_per_chip"
            for c in contract):
        bad.append(f"contract lines {contract}")
    elif not (math.isfinite(contract[-1]["value"])
              and contract[-1]["value"] > 0):
        bad.append(f"contract value {contract[-1]['value']}")
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    summary = (json.loads(last[len(BENCH_SUMMARY):])
               if last.startswith(BENCH_SUMMARY) else {})
    missing = [k for k in JAX_SUMMARY_KEYS if k not in summary]
    if missing or summary.get("failed"):
        bad.append(f"summary missing {missing}, failed "
                   f"{summary.get('failed')}")
    spread = {k: (summary[f"{k}_min"], summary[k], summary[f"{k}_max"])
              for k in summary if f"{k}_min" in summary}
    bad += [f"{k} {v}" for k, v in spread.items() if not v[0] <= v[1] <= v[2]]
    runs = summary.get("launches", {})
    launches = {name: sum(rec[name] for stage in runs.values()
                          for rec in stage.values())
                for name in kernels.LAUNCHES}
    # the served volume and the tiled pass run the model's forward, the
    # train step its backward too
    for stage, backward in (("primary", False), ("tiled", False),
                            ("train_step", True)):
        for key, rec in runs.get(stage, {}).items():
            if missed(rec, backward, names=GN_KERNELS):
                bad.append(f"{stage} {key} missed a kernel: {rec}")
    gen = runs.get("generator", {}).get("generator_ms_per_item", {})
    n = gen.get("calls", 0)
    if not (n > 0 and gen["warp_linear_f32"] == n
            and gen["warp_nearest_i32"] == n and gen["lut_gather_f32"] == n
            and n <= gen["lut_gather_i32"] <= 2 * n):
        bad.append(f"generator launches {gen}")
    emit({"phase": "bench", "summary": summary, "contract": contract[-1:],
          "whole_volume_ms": summary.get("whole_volume_ms"),
          "serve_forward_ms": figures["serve_forward_ms"],
          "generator_ms_per_item": summary.get("generator_ms_per_item"),
          "slice_item_ms": figures["slice_item_ms"],
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"bench phase failed: {bad}")
    return launches


def run_entry(dev, power):
    """entry()'s fn on the card against the CPU, timed, then
    dryrun_multichip(1) on one NCCL rank. Returns the kernel launches on
    the dry run's rank (its steps and its synthesis)."""
    from brainfm_tpu_torch import entry as port_entry

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn, (params, x) = port_entry.entry()
    x_shape, size = list(x.shape), tuple(x.shape[1:4])
    n_seg = len(LABELS_EXTRACEREBRAL)
    want = {"T1": (1, *size, 1), "segmentation": (1, *size, n_seg)}
    with torch.no_grad():
        outs = dict(zip(want, fn(params, x)))
    torch.cuda.synchronize()
    cpu_fn, (cpu_params, cpu_x) = port_entry.entry(
        device="cpu", overrides={"generator": {
            "left_hemis_only": False, "size": list(ENTRY_CPU_SIZE)}})
    with torch.no_grad():
        cpu_outs = dict(zip(want, cpu_fn(cpu_params, cpu_x)))
    del cpu_fn, cpu_params, cpu_x
    bad, values = [], {}
    for k, v in outs.items():
        if tuple(v.shape) != want[k]:
            bad.append(f"{k} shape {tuple(v.shape)} != {want[k]}")
        if not bool(torch.isfinite(v).all()):
            bad.append(f"{k} not finite")
        lo, hi = float(v.min()), float(v.max())
        c_lo, c_hi = float(cpu_outs[k].min()), float(cpu_outs[k].max())
        values[k] = {"gpu": [lo, hi], "cpu": [c_lo, c_hi]}
        if not lo == hi == c_lo == c_hi:
            bad.append(f"{k} not the CPU's constant field: {values[k]}")
    del outs, cpu_outs

    def call():
        with torch.no_grad():
            fn(params, x)

    times = []
    for i in range(ENTRY_WARM + ENTRY_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        if i >= ENTRY_WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del fn, params, x
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = port_entry.dryrun_multichip(1, timeout=ENTRY_TIMEOUT)
    dryrun_s = time.perf_counter() - t0
    losses = {k: res[k] for k in ("loss_total", "fsdp_loss_total",
                                  "synth_loss_total")}
    if not all(math.isfinite(v) for v in losses.values()):
        bad.append(f"dry run losses {losses}")
    fsdp_rel = abs(losses["fsdp_loss_total"] - losses["loss_total"]) / abs(
        losses["loss_total"])
    if not fsdp_rel <= port_entry.FSDP_RTOL:
        bad.append(f"FSDP loss {fsdp_rel} from the data-parallel one")
    launches = {k: sum(r[k] for r in res["launches_by_rank"])
                for k in kernels.LAUNCHES}
    if missed(launches):
        bad.append(f"path missed a kernel: {launches}")
    emit({"phase": "entry", "model": "joint 8-task UNet3D f64 L6, zero "
          "parameters", "x": x_shape, "amp": "bf16",
          "shapes": {k: list(v) for k, v in want.items()},
          "constant_values": values, "cpu_size": list(ENTRY_CPU_SIZE),
          "fn_ms": statistics.median(times), "fn_ms_all": times,
          "peak_mem_gib": peak, "dryrun": {
              "mesh": res["mesh"], "backend": "nccl", **losses,
              "fsdp_rel_err": fsdp_rel, "seconds": dryrun_s},
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"entry phase failed: {bad}")
    return launches


def run_profile_train(dev, power):
    """brainfm_tpu_torch/scripts/profile_train.py's sweep at its defaults
    (128^3, L6, f_maps 64): each mode timed, then counted. Only
    PROFILE_TRAIN_MAY_OOM may fail, and only by running out of memory; the
    counts of the modes that ran must keep their order (FLOPs: full above
    save_convs, save_convs equal to off; bytes: off, save_convs, full
    rising)."""
    from brainfm_tpu_torch.scripts import profile_train as pt

    gc.collect()
    torch.cuda.empty_cache()
    ap = pt.build_parser()
    recs, lines = {}, []
    for extra in ((), ("--ledger",)):
        args = ap.parse_args([*PROFILE_TRAIN_ARGS, *extra])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            recs["ledger" if extra else "timed"] = pt.sweep(
                args, pt.parse_modes(ap, args.modes), dev)
        lines += buf.getvalue().splitlines()
    bad = []
    for kind, by_mode in recs.items():
        for mode, rec in by_mode.items():
            if "failed" in rec and not (
                    mode == PROFILE_TRAIN_MAY_OOM
                    and rec["failed"].startswith("OutOfMemoryError")):
                bad.append(f"{kind} {mode}: {rec['failed']}")
    led = {m: r for m, r in recs["ledger"].items() if "failed" not in r}
    if "full" in led and "save_convs" in led:
        if not led["full"]["flops"] > led["save_convs"]["flops"]:
            bad.append("full counts no recompute")
        if not led["full"]["bytes"] > led["save_convs"]["bytes"]:
            bad.append("full moves no more bytes than save_convs")
    if "off" in led and "save_convs" in led:
        if led["off"]["flops"] != led["save_convs"]["flops"] \
                or not led["off"]["bytes"] < led["save_convs"]["bytes"]:
            bad.append("off against save_convs")
    emit({"phase": "profile_train", "args": list(PROFILE_TRAIN_ARGS),
          "lines": lines, "timed": recs["timed"], "ledger": recs["ledger"],
          "gpu": power})
    if bad:
        raise AssertionError(f"profile_train phase failed: {bad}")


def orbax_cfg(name):
    """The configs of the committed orbax fixtures: "small" (joint.yaml
    over brain_id) and "twostage" (twostage.yaml with its generator) at
    f_maps 8, 3 levels, 32^3, unit_feat off, no autocast; "flagship" the
    flagship's."""
    if name == "flagship":
        return flagship_cfg()
    cfg = (flagship_cfg() if name == "small"
           else train_script.train_config("twostage", "twostage"))
    cfg.f_maps, cfg.num_levels, cfg.task_f_maps = 8, 3, [8]
    cfg.generator.size = list(ORBAX_SIZE)
    cfg.amp, cfg.unit_feat = False, False
    return cfg


def orbax_inferencers(dev, flagship_dtype=torch.bfloat16):
    """Each committed orbax fixture served by its inferencer on `dev`,
    loaded strictly (every key must map): {"small", "twostage",
    "flagship"} -> (inferencer, seconds to build and load)."""
    out = {}
    for name in ("small", "twostage", "flagship"):
        path = os.path.join(ORBAX_DIR, name)
        t0 = time.perf_counter()
        if name == "twostage":
            inf = TwoStageInferencer(orbax_cfg(name), pathol_ckpt=path,
                                     task_ckpt=path, device=dev)
        else:
            inf = Inferencer(orbax_cfg(name), ckpt_path=path, device=dev,
                             compute_dtype=(flagship_dtype if name ==
                                            "flagship" else torch.float32))
        out[name] = (inf, time.perf_counter() - t0)
    return out


def _orbax_compare(out, name):
    """Relative errors of the served outputs at the fixture's sampled
    voxels, and the label maps' agreement."""
    ref = np.load(os.path.join(ORBAX_DIR, f"{name}_outputs.npz"))
    idx = torch.from_numpy(ref["voxels"])
    rel = {}
    for k in ref.files:
        if k in ("voxels", "label"):
            continue
        got = out[k].reshape(-1, out[k].shape[-1]).cpu()[idx]
        rel[k] = _rel_err(got, torch.from_numpy(ref[k]))
    agree = float((out["label"].cpu() == torch.from_numpy(ref["label"]))
                  .double().mean())
    missing = sorted(set(ref.files) - {"voxels"} - set(out))
    return rel, agree, missing


def run_orbax(dev, power):
    """The JAX package's orbax checkpoints (ORBAX_DIR), read by the port:
    (a) the small fixture served on the card against the JAX Inferencer's
    outputs, its full state through load_checkpoint held bitwise to the
    decoded arrays, one train step; the decoder's rate on its chunks; (b)
    the two-stage fixture served; (c) the flagship zero state loaded
    strictly into the flagship Inferencer, one 220^3 volume served in
    bf16 (K2 in postprocess), the params-only and the full-state reads
    timed. Returns the launches of the serving."""
    from brainfm_tpu_torch.models.params_io import (find_state,
                                                    from_jax_params)
    from brainfm_tpu_torch.runtime import zstd
    from brainfm_tpu_torch.train import orbax_read
    from brainfm_tpu_torch.train.checkpoint import resolve_checkpoint

    bad = []
    # each fixture is a run's ckp/ root holding one step directory
    paths = {n: resolve_checkpoint(os.path.join(ORBAX_DIR, n))
             for n in ("small", "flagship")}
    # fixture (a)'s read; the chunks that the reader hands the decoder
    real = zstd.decode_batch
    batch = []

    def captured(frames, sizes):
        batch[:] = [(frames, sizes)]
        return real(frames, sizes)

    reads = []
    try:
        orbax_read.zstd.decode_batch = captured
        for _ in range(ORBAX_READS):
            t0 = time.perf_counter()
            tree = orbax_read.restore(paths["small"])
            reads.append(time.perf_counter() - t0)
    finally:
        orbax_read.zstd.decode_batch = real
    frames, sizes = batch[0]
    small_bytes = sum(sizes)
    decoder = decoder_rates(frames, sizes)

    x = np.random.default_rng(0).random(ORBAX_SIZE).astype(np.float32)
    kernels.reset_launches()
    infs = orbax_inferencers(dev)
    served = {}
    for name in ("small", "twostage"):
        inf, load_s = infs.pop(name)
        out, ms = _synced_ms(lambda: inf.evaluate_image(x, keep_feat=False))
        rel, agree, missing = _orbax_compare(out, name)
        served[name] = {"load_s": load_s, "serve_ms": ms, "rel_err": rel,
                        "label_agree": agree}
        bad += [f"{name}: {k} {v} > {MODEL_TOL}" for k, v in rel.items()
                if not v <= MODEL_TOL]
        if missing:
            bad.append(f"{name}: outputs {missing} not served")
        if agree < ORBAX_LABEL_AGREE:
            bad.append(f"{name}: labels agree on {agree}")
        del inf, out
    inf, flag_load_s = infs.pop("flagship")
    vol = procedural_head(SERVE_WIN, (1.0, 1.0, 1.0), 0, dev)
    out, flag_ms = _synced_ms(lambda: inf.evaluate_image(vol,
                                                         keep_feat=False))
    flag_out = {k: list(v.shape) for k, v in out.items()}
    if not all(bool(torch.isfinite(v.float()).all()) for v in out.values()):
        bad.append("flagship: outputs not finite")
    launches = dict(kernels.LAUNCHES)
    if launches["lut_gather_i32"] < 1 or missed(
            launches, backward=False, names=GN_KERNELS):
        bad.append(f"path missed a kernel: {launches}")
    del inf, out, vol
    gc.collect()
    torch.cuda.empty_cache()

    # (a)'s full state through load_checkpoint, bitwise, and one step
    cfg, model = build_model(orbax_cfg("small"), device=dev)
    state = load_checkpoint(paths["small"], TrainState(
        model, build_optimizer(cfg, model.parameters()), 0))
    want = {f"param.{k}": v for k, v in
            from_jax_params(tree["params"]).items()}
    adam = find_state(tree["opt_state"], ("count", "mu", "nu"))
    order = [n for n, _ in model.named_parameters()]
    for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        sd = from_jax_params(adam[moment])
        want |= {f"opt.{i}.{key}": sd[n] for i, n in enumerate(order)}
    got = {k: v for k, v in _state_tensors(state).items()
           if not k.endswith(".step")}
    changed = _bitwise_diff({k: v.cpu() for k, v in got.items()}, want)
    steps = {int(v) for k, v in _state_tensors(state).items()
             if k.endswith(".step")}
    if changed:
        bad.append(f"load_checkpoint: {len(changed)} tensors differ, "
                   f"{changed[:3]}")
    if state.step != int(tree["step"]) or steps != {int(adam["count"])}:
        bad.append(f"load_checkpoint: step {state.step}, Adam steps "
                   f"{steps}; saved {int(tree['step'])}, "
                   f"{int(adam['count'])}")
    _, weight_dict, loss_fn = make_criterion(cfg)
    step = make_train_step(state.model, cfg, weight_dict, loss_fn,
                           state.optimizer)
    state, metrics = step(state, _to_dev(ref_train_batch(cfg), dev),
                          cfg.lr, 0.0)
    loss = float(metrics["loss_total"])
    if not math.isfinite(loss) or state.step != int(tree["step"]) + 1:
        bad.append(f"train step: loss {loss}, step {state.step}")
    del state, model, step, tree
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the flagship reads: params only, then the full state
    t0 = time.perf_counter()
    params = orbax_read.restore(paths["flagship"], ("params",))
    params_s = time.perf_counter() - t0
    params_bytes = sum(v.numel() * v.element_size()
                       for _, v in _leaves(params))
    del params
    cfg, model = build_model(orbax_cfg("flagship"), device=dev)
    opt = build_optimizer(cfg, model.parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = load_checkpoint(paths["flagship"], TrainState(model, opt, 0))
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_bytes = sum(v.numel() * v.element_size()
                     for v in _state_tensors(state).values())
    del state, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "orbax", "fixtures": ORBAX_DIR, "size": list(ORBAX_SIZE),
          "small": {"bytes_decoded": small_bytes,
                    "read_s": statistics.median(reads), "read_s_all": reads,
                    "decoder": decoder,
                    **served["small"], "train_step_loss": loss,
                    "load_checkpoint_bitwise": not changed},
          "twostage": served["twostage"],
          "flagship": {"load_s": flag_load_s, "serve_ms": flag_ms,
                       "outputs": flag_out, "window": list(SERVE_WIN),
                       "params_bytes": params_bytes,
                       "params_read_s": params_s,
                       "params_mb_s": params_bytes / params_s / 1e6,
                       "full_state_bytes": full_bytes,
                       "load_checkpoint_s": full_s},
          "model_tol": MODEL_TOL, "label_agree_min": ORBAX_LABEL_AGREE,
          "launches": launches, "gpu": power})
    if bad:
        raise AssertionError(f"orbax phase failed: {bad}")
    return launches


def decoder_rates(frames, sizes):
    """The zstd decoder's MB/s (decoded bytes) on fixture (a)'s chunks:
    the batch repeated to DECODE_BATCH_BYTES, so that the pool's thread
    start-up is small beside the work (median of ORBAX_READS), and its
    largest chunk decoded alone on one thread, repeated to
    DECODE_CHUNK_BYTES."""
    from brainfm_tpu_torch.runtime import zstd

    reps = -(-DECODE_BATCH_BYTES // sum(sizes))
    times = []
    for _ in range(ORBAX_READS):
        t0 = time.perf_counter()
        zstd.decode_batch(frames * reps, sizes * reps)
        times.append(time.perf_counter() - t0)
    batch_s = statistics.median(times)
    big = max(range(len(sizes)), key=sizes.__getitem__)
    n = -(-DECODE_CHUNK_BYTES // sizes[big])
    t0 = time.perf_counter()
    for _ in range(n):
        zstd.decompress(frames[big], sizes[big])
    chunk_s = time.perf_counter() - t0
    total = sum(sizes) * reps
    return {"batch_bytes": total, "batch_frames": len(sizes) * reps,
            "threads": zstd.THREADS, "batch_s": batch_s,
            "batch_mb_s": total / batch_s / 1e6,
            "chunk_bytes": sizes[big], "chunk_reps": n,
            "chunk_mb_s": sizes[big] * n / chunk_s / 1e6}


def _leaves(tree, prefix=()):
    """(path, tensor) of every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    elif torch.is_tensor(tree):
        yield prefix, tree


def run_after_slice(dev, power, state, ckpt, lap, slice_item_ms):
    """The phases after the slice, each ended by lap(name); the slice's
    `state` is served by `serve`, its .pth `ckpt` by `evaluate`; the
    bench's clocks are printed beside the slice's `slice_item_ms` and the
    serve phase's forward. Returns the launches by path."""
    with tempfile.TemporaryDirectory() as tmp:
        check_serve_reference(dev, tmp)
        lap("serve_reference")
        serve_launches, serve_forward_ms = run_serve(flagship_cfg(), state,
                                                     dev, power, tmp)
        lap("serve")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        check_train_reference(dev, tmp)
        lap("train_reference")
        train_launches = run_train(dev, power, tmp)
        lap("train")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        check_stream_reference(dev, tmp)
        lap("stream_reference")
        stream_launches, root, stream_figs = run_stream(dev, power, tmp)
        lap("stream")
        # the data root stays for the multigpu phase
        held = tempfile.mkdtemp()
        shutil.move(os.path.dirname(root[0]), held)
        base = os.path.join(held, os.path.basename(os.path.dirname(root[0])))
        root = tuple(os.path.join(base, os.path.basename(r)) for r in root)
        torch.cuda.empty_cache()
        pathology_launches = run_pathology(dev, power)
        lap("pathology")
        torch.cuda.empty_cache()
        check_variants_reference(dev)
        lap("variants_reference")
        variants_launches = run_variants(dev, power, tmp)
        lap("variants")
        torch.cuda.empty_cache()
        check_twostage_reference(dev)
        lap("twostage_reference")
        twostage_launches = run_twostage(dev, power, tmp, root)
        lap("twostage")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        check_evaluate_reference(dev, tmp)
        lap("evaluate_reference")
        torch.cuda.empty_cache()
        evaluate_launches = run_evaluate(dev, power, tmp, ckpt)
        lap("evaluate")
    torch.cuda.empty_cache()
    orbax_launches = run_orbax(dev, power)
    lap("orbax")
    torch.cuda.empty_cache()
    numerics_launches = run_numerics(dev, power)
    lap("numerics_reference")
    torch.cuda.empty_cache()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            mgpu_ref_launches = check_multigpu_reference(dev, power, ckpt,
                                                         tmp)
            lap("multigpu_reference")
            mgpu_launches = run_multigpu(dev, power, root, tmp, stream_figs)
            lap("multigpu")
    finally:
        shutil.rmtree(held, ignore_errors=True)
    torch.cuda.empty_cache()
    run_roofline(dev, power)
    lap("roofline")
    bench_launches = run_bench(power, {"slice_item_ms": slice_item_ms,
                                       "serve_forward_ms": serve_forward_ms})
    lap("bench")
    entry_launches = run_entry(dev, power)
    lap("entry")
    run_profile_train(dev, power)
    lap("profile_train")
    return {"serve": serve_launches, "train": train_launches,
            "stream": stream_launches, "pathology": pathology_launches,
            "variants": variants_launches, "twostage": twostage_launches,
            "evaluate": evaluate_launches, "orbax": orbax_launches,
            "numerics": numerics_launches,
            "multigpu_reference": mgpu_ref_launches,
            "multigpu": mgpu_launches, "bench": bench_launches,
            "entry": entry_launches}


def _sub_main(argv):
    """The processes this script starts: `--rank R --world W --port P
    --out JSON --pth PTH` (a multigpu_reference rank) or `--cli-timed JSON
    -- ARGS` (the multigpu phase's training CLI)."""
    if argv[0] == "--cli-timed":
        return cli_timed(argv[1], argv[3:])
    a = dict(zip(argv[::2], argv[1::2]))
    return multigpu_rank(int(a["--rank"]), int(a["--world"]), a["--port"],
                         a["--out"], a["--pth"])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        return _sub_main(sys.argv[1:])
    dev = torch.device("cuda")
    # fp32 parity needs full fp32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    power = gpu_name_power()
    built = kernels.build()
    emit({"phase": "build", "seconds": max(b["seconds"] for b in
                                           built.values()),
          "ptxas": {k: b["ptxas"] for k, b in built.items()}, "gpu": power})

    cfg = process_args(flagship_cfg())   # derives cfg.tasks
    scfg = SynthStatic.from_cfg(cfg)
    elapsed, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        elapsed[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    recs, by_path = check_kernels(scfg, dev)
    lap("kernel")
    check_slice_reference(cfg, dev)
    lap("slice_reference")
    check_groupnorm_reference(dev)
    lap("groupnorm_reference")
    slice_launches, state, slice_item_ms = run_slice(cfg, dev, power)
    lap("slice")
    # the slice's weights, served by the evaluate phase as a .pth
    ckdir = tempfile.mkdtemp()
    try:
        ckpt = os.path.join(ckdir, "slice_l6.pth")
        torch.save({"model": state}, ckpt)
        state = {k: v.cpu() for k, v in state.items()}
        paths = run_after_slice(dev, power, state, ckpt, lap, slice_item_ms)
        del state
    finally:
        shutil.rmtree(ckdir)
    emit({"phase": "elapsed_s", **elapsed})
    paths = {"slice": slice_launches, **paths}

    keys = ("case", "max_abs_err", "ms", "ms_cold", "plain_ms", "library_ms",
            "bound_ms", "bound_by")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name],
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {k: p[name] for k, p in paths.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         **{key: ({k: cases[name][k] for k in keys}
                  if name in cases else None)
            for key, cases in by_path.items()}}
        for name, r in recs.items()]})
    print(gpu_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
