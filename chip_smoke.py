#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (brainfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build   - compile the CUDA kernels of brainfm_tpu_torch/csrc (nvcc,
               sm_90a, one process per source, all at once).
  2. kernel  - each kernel against its plain PyTorch version on the card, at
               the generator path's shapes, edge cases included; kernel,
               plain and library times (CUDA events) beside the byte bound.
  3. slice_reference - a small item made on the GPU and replayed on the CPU
               from the same recorded draws (CPU = the plain versions), and a
               small model run on both.
  4. slice   - the flagship item (cfgs brain_id + joint: 160^3 from a 192^3
               bank, S=4) through synth_item, the L6 f_maps-64 joint forward
               under bf16 autocast and apply_processors; launch counts of
               every kernel over that run.
Then the `kernels` summary line, the card's name and power limit, and the
result line. Exits non-zero, printing no result, when a phase fails or no
GPU is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from brainfm_tpu_torch import kernels
from brainfm_tpu_torch.config import load_config, merge_missing
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

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
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


def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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
    """Coordinates exactly on 0 and D-1, just inside and just outside, on
    each axis in turn, at the head of the flattened grid."""
    one = torch.tensor(1.0)
    hi = torch.tensor(float(D - 1))
    e = torch.stack([torch.tensor(0.0), hi, torch.nextafter(0 * one, one),
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


def kernel_case(name, kernel, plain, library, nbytes, exact):
    """Run `kernel` and its plain version, compare, time all three."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    if exact:
        err = float((got.long() - want.long()).abs().max())
        ok = err == 0
    else:
        err = float((got - want).abs().max())
        ok = err <= LINEAR_TOL
    rec = {"phase": "kernel", "case": name, "max_abs_err": err,
           "ms": time_ms(kernel), "plain_ms": time_ms(plain),
           "library_ms": None if library is None else time_ms(library),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
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
    ok = ((ii > 0) & (jj > 0) & (kk > 0) & (ii <= D - 1) & (jj <= H - 1)
          & (kk <= W - 1))[None, None]
    dflt = torch.as_tensor(default, dtype=torch.float32,
                           device=src.device).reshape(1, -1, 1, 1, 1)
    return lambda: torch.where(ok, F.grid_sample(
        vol, g, mode=mode, padding_mode="border", align_corners=True), dflt)


def check_kernels(scfg, dev):
    g = torch.Generator(dev).manual_seed(0)
    grid = path_grid(scfg, dev, seed=0)
    n_out = grid[0].numel()
    n_src = int(np.prod(BANK))
    recs = {}

    # K1 linear: the fused target wall (C=12, per-channel defaults) and the
    # real-image warp (C=1)
    egrid = with_edges(grid, BANK[0])
    for C in (12, 1):
        shape = BANK + ((C,) if C > 1 else ())
        src = torch.randn(shape, generator=g, device=dev)
        dflt = torch.randn(C, generator=g, device=dev) if C > 1 else 0.0
        rec = kernel_case(
            f"warp_linear_f32 C={C}",
            lambda: warp_volume(src, egrid, default=dflt),
            lambda: trilinear3d(src, *egrid, dflt),
            grid_sample_yardstick(src, egrid, "bilinear", dflt),
            4 * (n_src * C + 3 * n_out + C + n_out * C), exact=False)
        recs.setdefault("warp_linear_f32", rec)

    # K1 nearest: compact labels, with .5 ties
    labels = torch.randint(0, 56, BANK, generator=g, device=dev,
                           dtype=torch.int32)
    tgrid = with_ties(grid)
    recs["warp_nearest_i32"] = kernel_case(
        "warp_nearest_i32", lambda: warp_labels(labels, tgrid),
        lambda: nearest3d(labels, *tgrid),
        grid_sample_yardstick(labels, tgrid, "nearest"),
        4 * (n_src + 3 * n_out + n_out), exact=True)

    # K2: label compaction (10000,) i32 over 192^3, vflip (56,) i32 over
    # 160^3, GMM (256, 8) f32 over 192^3; indices -1 and >= K included
    def lut_case(name, table, idx_shape):
        K = table.shape[0]
        C = 1 if table.dim() == 1 else table.shape[1]
        idx = torch.randint(-1, K + 2, idx_shape, generator=g, device=dev,
                            dtype=torch.int32)
        t2 = table if table.dim() == 2 else table[:, None]
        valid = ((idx >= 0) & (idx < K))[..., None]
        idc = idx.long().clamp(0, K - 1)
        n = idx.numel()
        return kernel_case(
            name, lambda: lut_apply(table, idx),
            lambda: lut_apply_plain(table, idx),
            lambda: torch.where(valid, t2[idc], 0),
            table.element_size() * K * C + 4 * n + table.element_size() * n * C,
            exact=table.dtype == torch.int32)

    lut = torch.from_numpy(build_lut(LABELS_EXTRACEREBRAL)).to(dev)
    recs["lut_gather_i32"] = lut_case("lut_gather_i32 K=10000", lut, BANK)
    lut_case("lut_gather_i32 K=56", torch.arange(56, dtype=torch.int32,
                                                 device=dev).flip(0),
             tuple(scfg.size))
    gmm = torch.rand((256, 8), generator=g, device=dev) * 200
    recs["lut_gather_f32"] = lut_case("lut_gather_f32 K=256 C=8", gmm, BANK)
    return recs


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
    recs = check_kernels(scfg, dev)
    check_slice_reference(cfg, dev)
    launches = run_slice(cfg, dev, power)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in recs.items()]})
    print(gpu_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
