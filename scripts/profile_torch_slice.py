#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's flagship slice on one GPU.

    python3 scripts/profile_torch_slice.py

Builds the same flagship item and L6 f_maps-64 model as chip_smoke.py
(cfgs brain_id + joint, 160^3 from a 192^3 bank, S=4, bf16 forward), runs
one warm-up pass, then profiles one synth_item and one forward, each in its
own torch.profiler session (CPU + CUDA activity). For each it prints one
JSON line: host wall ms, the summed device time of all GPU kernels (they
run on one stream, so this is the device's busy time), the idle share
1 - busy/wall, the share of the port's own CUDA kernels (csrc/), and the
top kernels by device time. Chrome traces go to outs/profile_torch_slice/
(git-ignored).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (flagship config and constants)
from brainfm_tpu_torch.models import apply_processors, build_model  # noqa: E402
from brainfm_tpu_torch.synth import (SubjectBank, SynthStatic,  # noqa: E402
                                     knobs_from_cfg, synth_item)

# kernel names of brainfm_tpu_torch/csrc
OWN = ("warp_linear_kernel", "warp_nearest_kernel", "lut_row_kernel",
       "lut_word_kernel", "lut_scalar_kernel")
TOP = 15


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def breakdown(name, fn, out_dir):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    kern = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kern[evt.key] = (kern.get(evt.key, (0.0, 0))[0] + us,
                             kern.get(evt.key, (0.0, 0))[1] + evt.count)
    busy_ms = sum(us for us, _ in kern.values()) / 1e3
    own_ms = sum(us for k, (us, _) in kern.items()
                 if any(o in k for o in OWN)) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]
    rec = {"phase": f"profile_{name}", "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if wall_ms > 0 else None,
           "own_kernels_ms": own_ms, "n_kernel_names": len(kern),
           "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                   for k, (us, n) in top]}
    print(json.dumps(rec), flush=True)
    if busy_ms == 0:
        raise RuntimeError("the profiler recorded no device time")


def main():
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "outs", "profile_torch_slice")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    cfg = chip_smoke.flagship_cfg()
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    model.eval()
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank(chip_smoke.BANK)
    bank.add_debug_subject(seed=0)
    subj = bank.to_device(0, dev)
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    gen = torch.Generator(dev).manual_seed(1)
    draws = {"setup": {"flip_n": 0.0}}
    held = {}

    def item():
        held["samples"] = synth_item(gen, subj, scfg, cfg.tasks, "synth",
                                     knobs, draws=draws)[1]

    def forward():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            apply_processors(model(held["samples"]["input"]), cfg)

    item()
    forward()
    print(chip_smoke.gpu_name_power(), flush=True)
    breakdown("item", item, out_dir)
    breakdown("forward", forward, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
