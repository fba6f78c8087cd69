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
Then the `kernels` summary line (launches on both paths), the card's name
and power limit, and the result line. Exits non-zero, printing no result,
when a phase fails or no GPU is present.
"""

from __future__ import annotations

import gzip
import json
import os
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
from brainfm_tpu_torch.config import load_config, merge_missing
from brainfm_tpu_torch.infer import (Inferencer, get_deformed_atlas,
                                     prepare_image, tile_plan)
from brainfm_tpu_torch.models import (apply_processors, build_model,
                                      process_args)
from brainfm_tpu_torch.ops.interp import nearest3d, trilinear3d
from brainfm_tpu_torch.ops.lut import lut_apply, lut_apply_plain
from brainfm_tpu_torch.ops.warp import warp_labels, warp_volume
from brainfm_tpu_torch.synth import (Draws, LABELS_EXTRACEREBRAL, SubjectBank,
                                     SynthStatic, build_lut, deform_grid,
                                     knobs_from_cfg, random_affine,
                                     random_nonlinear_field, sample_setup,
                                     synth_item)
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
    gen = load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                       "brain_id"],
                      cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    tr = load_config([os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
                      "joint"],
                     cfg_dir=os.path.join(ROOT, "cfgs/trainer/train"))
    return merge_missing(tr, gen)


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
    zero = torch.zeros((), device=dev)
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
    emit({"phase": "elapsed_s", **elapsed})

    keys = ("case", "max_abs_err", "ms", "ms_cold", "plain_ms", "library_ms",
            "bound_ms", "bound_by")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name],
         "launches": slice_launches[name] + serve_launches[name],
         "launches_by_path": {"slice": slice_launches[name],
                              "serve": serve_launches[name]},
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
