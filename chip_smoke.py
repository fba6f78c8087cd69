#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (brainfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build   - compile the CUDA kernels of brainfm_tpu_torch/csrc (nvcc,
               sm_90a, one process per source, all at once).
  2. kernel  - each kernel against its plain PyTorch version on the card, at
               the generator path's and the serving path's shapes, edge
               cases included (`kernel_cases`); kernel (warm and cold L2),
               plain and library times (CUDA events) beside the byte bound.
               K1 linear at C=12 is also timed on 4 flagship deformation
               draws (seeds 0-3).
  3. slice_reference - a small item made on the GPU and replayed on the CPU
               from the same recorded draws (CPU = the plain versions), and a
               small model run on both.
  4. slice   - the flagship item (cfgs brain_id + joint: 160^3 from a 192^3
               bank, S=4) through synth_item, the L6 f_maps-64 joint forward
               under bf16 autocast and apply_processors; launch counts of
               every kernel over that run.
  5. serve_reference - a small head file served by the small model on the
               GPU and on the CPU (prepare_image, evaluate_image with
               postprocess, get_deformed_atlas), compared.
  6. serve   - three procedural heads served whole at 220^3 by the L6
               f_maps-64 model (the slice's weights) in bf16 through
               Inferencer.evaluate_path, the deformed atlas on a 256^3
               atlas, one tiled pass; stage times per volume; launch counts
               over those steps.
  7. train_reference - a small model (f_maps 8, 3 levels, 32^3, S=4, fp32,
               TF32 off): one train step's losses and gradients on the GPU
               against the CPU from the same params and batch, the params
               after one SGD step, a batch with a NaN voxel that must leave
               the GPU state bitwise as it was, and a checkpoint saved and
               loaded back bitwise on the card.
  8. train   - the flagship training configuration (the slice's, bf16,
               AdamW with its warmup) through train/loop.py::train for one
               epoch of TRAIN_ITR iterations with validation and
               checkpoints, then TRAIN_TIMED timed iterations (item, step);
               every step's loss and skip flag, peak memory, launch counts
               over the phase.
  9. stream_reference - procedural subject files (write_subject_root) read
               through the codec into the datasets of synth/datasets.py on
               the GPU and on the CPU; one item per dataset with
               deform_one_hots, pathology forced on from the lesion pool
               and the surface task's inverse field, made on the GPU and
               replayed on the CPU from its recorded draws, compared; a
               small model on both.
 10. stream  - the training CLI (scripts/train.py::main) with the flagship
               configs on a data root of two datasets at 180^3 (HCP: T1,
               T2; ATLAS: T1 and a lesion pool): one epoch of STREAM_ITR
               iterations on the dataset stream, then --eval_only --resume
               on its checkpoint, then TRAIN_TIMED timed stream iterations
               (item, step); ingest seconds, peak memory, launch counts.
 11. pathology - items of the shape_id generator (160^3, dopri5,
               augment_pathology) with pathology forced on, from random
               shapes and from a lesion file, timed by part (shape or
               lesion warp, advection with its adaptive steps, the rest);
               then the flagship model trains a step on each.
Then the elapsed seconds per phase, the `kernels` summary line (launches on
the slice, serve, train, stream and pathology paths), the card's name and
power limit, and the result line. Exits non-zero, printing no result, when
a phase fails or no GPU is present.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import gzip
import io
import json
import os
import re
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
from brainfm_tpu_torch.infer import (Inferencer, get_deformed_atlas,
                                     prepare_image, tile_plan)
from brainfm_tpu_torch.models import (apply_processors, build_model,
                                      process_args)
from brainfm_tpu_torch.models.criterion import make_criterion, weighted_total
from brainfm_tpu_torch.ops.interp import nearest3d, trilinear3d
from brainfm_tpu_torch.ops.lut import lut_apply, lut_apply_plain
from brainfm_tpu_torch.ops.warp import warp_labels, warp_volume
from brainfm_tpu_torch.synth import (Draws, LABELS_EXTRACEREBRAL, SubjectBank,
                                     SynthStatic, build_lut, deform_grid,
                                     knobs_from_cfg, random_affine,
                                     random_nonlinear_field, sample_setup,
                                     synth_item)
from brainfm_tpu_torch.scripts import train as train_script
from brainfm_tpu_torch.synth.batch import stack_items
from brainfm_tpu_torch.synth.datasets import DATASET_SETUPS, build_datasets
from brainfm_tpu_torch.train import (build_optimizer, build_schedules,
                                     load_checkpoint, make_batch,
                                     make_train_step, save_checkpoint, train)
from brainfm_tpu_torch.train.step import TrainState, batch_losses
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

SOURCES = {"warp_linear_f32": "brainfm_tpu_torch/csrc/warp.cu",
           "warp_nearest_i32": "brainfm_tpu_torch/csrc/warp.cu",
           "lut_gather_i32": "brainfm_tpu_torch/csrc/lut.cu",
           "lut_gather_f32": "brainfm_tpu_torch/csrc/lut.cu"}
REPLACES = {"warp_linear_f32": "brainfm_tpu/ops/pallas_warp_blocks.py:300",
            "warp_nearest_i32": "brainfm_tpu/ops/pallas_warp_blocks.py:300",
            "lut_gather_i32": "brainfm_tpu/ops/pallas_lut.py:53",
            "lut_gather_f32": "brainfm_tpu/ops/pallas_lut.py:53"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def path_grid(scfg, dev, seed):
    """Source coordinates of one flagship deformation (160^3 into a 160^3
    subject of the 192^3 bank)."""
    d = Draws(torch.Generator(dev).manual_seed(seed), dev)
    setup = sample_setup(d.sub("setup"), scfg)
    shp = torch.tensor([160.0] * 3, device=dev)
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
    if case.exact:
        err = float((got.long() - want.long()).abs().max())
        ok = err == 0
    else:
        err = float((got - want).abs().max())
        ok = err <= LINEAR_TOL
    rec = {"phase": "kernel", "case": case.name, "max_abs_err": err,
           "ms": time_ms(case.kernel),
           "ms_cold": time_ms(case.kernel, cold=True),
           "plain_ms": time_ms(case.plain),
           "library_ms": (None if case.library is None
                          else time_ms(case.library)),
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
    return cases


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


def check_kernels(scfg, dev):
    """Each case against its plain version, timed; the first case of each
    C function stands for it in the `kernels` line, the serving cases
    beside it. Then the cold timing's floor (an empty pair of events) and
    K1 C=12 on 4 deformation draws. Returns (records by C function, serving
    records by C function)."""
    recs, serving = {}, {}
    for case in kernel_cases(scfg, dev):
        rec = run_case(case)
        recs.setdefault(case.fn, rec)
        if case.name in SERVING_CASES:
            serving[case.fn] = rec
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
    return recs, serving


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
    if k1 < 2 or k2 < 3 or min(launches.values()) < 1:
        raise AssertionError(f"path missed a kernel: {launches}")
    emit({"phase": "slice", "size": list(size), "bank": list(BANK),
          "samples": S, "tasks": list(cfg.tasks), "f_maps": int(cfg.f_maps),
          "num_levels": int(cfg.num_levels), "item_ms": item_ms,
          "forward_ms": fwd_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "gpu": power})
    return launches, model.state_dict()


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

    def _fetch_outputs(self, outs, exclude_keys):
        k2 = kernels.LAUNCHES["lut_gather_i32"]
        self.volumes.append({
            "shapes": {k: list(v.shape) for k, v in outs.items()},
            "nonfinite": [k for k, v in outs.items() if v.is_floating_point()
                          and not bool(torch.isfinite(v).all())],
            "labels_in_table": bool(torch.isin(outs["label"],
                                               self.table).all()),
            "k2_launches": k2 - sum(v["k2_launches"] for v in self.volumes)})
        return super()._fetch_outputs(outs, exclude_keys)


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
        inf._fetch_outputs(out, ("segmentation",))
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
    return launches


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


def _loss_and_grads(model, cfg, weight_dict, loss_fn, batch):
    """The losses and every parameter's gradient of one backward."""
    model.zero_grad(set_to_none=True)
    losses = batch_losses(model, cfg, loss_fn, batch, amp=False)
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
    with open(os.path.join(out_dir, "train.log")) as f:
        steps = [{"epoch": int(m[1]), "it": int(m[2]), "lr": float(m[3]),
                  "loss_total": float(m[4]), "skipped": int(m[5])}
                 for m in STEP_LINE.finditer(f.read())]

    scfg = SynthStatic.from_cfg(cfg)
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    subj = bank.to_device(0, dev)
    gen = torch.Generator(dev).manual_seed(2)
    lr_s, wd_s = build_schedules(cfg, TRAIN_ITR)
    step_fn = make_train_step(model, cfg, weight_dict, loss_fn,
                              state.optimizer, sample_accum=TRAIN_ACCUM)
    timed = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = make_batch([gen], subj, scfg, cfg.tasks, "synth", knobs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch, float(lr_s[-1]), float(wd_s[-1]))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del batch
        timed.append({"item_ms": (t1 - t0) * 1e3, "step_ms": (t2 - t1) * 1e3,
                      "iter_ms": (t2 - t0) * 1e3,
                      "loss_total": float(m["loss_total"]),
                      "skipped": int(m["skipped"])})
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
    if min(launches.values()) < 1:
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
        rec, st = {}, {}
        tg, sg = gds.get(0, torch.Generator(dev).manual_seed(5), record=rec,
                         stats=st)
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
    timed = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        name, target, samples = next(items)
        batch = stack_items([target], [samples])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, mt = step_fn(state, batch, 1e-4, 1e-2)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del batch, target, samples
        timed.append({"dataset": name, "item_ms": (t1 - t0) * 1e3,
                      "step_ms": (t2 - t1) * 1e3, "iter_ms": (t2 - t0) * 1e3,
                      "loss_total": float(mt["loss_total"]),
                      "skipped": int(mt["skipped"])})
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
            or launches["lut_gather_f32"] < 1:
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
    return launches


def run_pathology(dev, power):
    """PATHOLOGY_ITEMS items of the shape_id generator (160^3 from a 192^3
    bank, S=1, dopri5, augment_pathology) with pathology forced on, from a
    random shape and from the subject's lesion file alternately; each
    item's wall on the host clock split by synth_item's stats into the
    shape synthesis (or the lesion warp), the advection (with nt and the
    adaptive steps) and the rest; then the flagship model (joint: f_maps
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
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            target, samples = synth_item(torch.Generator(dev).manual_seed(
                seed), subj, scfg, cfg.tasks, "synth", knobs, draws=draws,
                stats=st)
            torch.cuda.synchronize()
            item_ms = (time.perf_counter() - t0) * 1e3
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
            or launches["lut_gather_f32"] < PATHOLOGY_ITEMS:
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    recs, serving = check_kernels(scfg, dev)
    lap("kernel")
    check_slice_reference(cfg, dev)
    lap("slice_reference")
    slice_launches, state = run_slice(cfg, dev, power)
    lap("slice")
    with tempfile.TemporaryDirectory() as tmp:
        check_serve_reference(dev, tmp)
        lap("serve_reference")
        serve_launches = run_serve(flagship_cfg(), state, dev, power, tmp)
        lap("serve")
    del state
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
        stream_launches = run_stream(dev, power, tmp)
        lap("stream")
    torch.cuda.empty_cache()
    pathology_launches = run_pathology(dev, power)
    lap("pathology")
    emit({"phase": "elapsed_s", **elapsed})
    paths = {"slice": slice_launches, "serve": serve_launches,
             "train": train_launches, "stream": stream_launches,
             "pathology": pathology_launches}

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
         "serving_case": ({k: serving[name][k] for k in keys}
                          if name in serving else None)}
        for name, r in recs.items()]})
    print(gpu_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
