#!/usr/bin/env python3
"""Time the kernels of one tree of the port at the flagship path's shapes,
for comparing two trees on one card.

    python3 scripts/compare_kernels.py [--tree DIR] [--label NAME]

Imports `brainfm_tpu_torch` from DIR (default: this checkout; for another
commit, unpack it with `git archive <commit> | tar -x -C DIR`; to time a
variant, unpack a copy with the edited constant), builds its kernels and
times its wrappers on one GPU on chip_smoke.py's kernel cases
(`chip_smoke.kernel_cases`: seed-0 flagship deformation, 192^3 bank), plus
K1 linear at C=12 and C=1 on the same grid flattened to 1-D and on an
undeformed 160^3 grid (every warp reads whole rows). One JSON line per
case: warm and cold device ms (chip_smoke.time_ms), the byte bound and the
max abs error against the plain version; then the card's name and power
limit. Compare two trees only inside one call on one card, in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def extra_grids(cs, scfg, dev):
    """K1 linear on the flagship grid flattened to 1-D and on the output
    grid placed undeformed in the bank's centre."""
    from brainfm_tpu_torch.ops.interp import trilinear3d
    from brainfm_tpu_torch.ops.warp import warp_volume

    g = torch.Generator(dev).manual_seed(1)
    grid = cs.path_grid(scfg, dev, seed=0)
    offset = (cs.BANK[0] - grid[0].shape[0]) / 2 + 0.5
    views = {"flat": [c.reshape(-1) for c in grid],
             "identity": [c.contiguous() for c in torch.meshgrid(
                 *(torch.arange(m, device=dev, dtype=torch.float32) + offset
                   for m in grid[0].shape), indexing="ij")]}
    out = []
    for C in (12, 1):
        src = torch.randn(cs.BANK + ((C,) if C > 1 else ()), generator=g,
                          device=dev)
        dflt = (torch.randn(C, generator=g, device=dev) if C > 1
                else torch.zeros((), device=dev))
        for view, gr in views.items():
            out.append(cs.Case(
                f"warp_linear_f32 C={C} {view}", "warp_linear_f32",
                lambda s=src, d=dflt, gr=gr: warp_volume(s, gr, default=d),
                lambda s=src, d=dflt, gr=gr: trilinear3d(s, *gr, d), None,
                cs.linear_bytes(cs.BANK, gr, C), exact=False))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from brainfm_tpu_torch import kernels
    if not kernels.__file__.startswith(tree):
        raise RuntimeError(f"imported {kernels.__file__}, not from {tree}")
    cs = load_chip_smoke()
    dev = torch.device("cuda")
    power = cs.gpu_name_power()
    scfg = cs.SynthStatic.from_cfg(cs.process_args(cs.flagship_cfg()))
    kernels.build()
    for case in cs.kernel_cases(scfg, dev) + extra_grids(cs, scfg, dev):
        got, want = case.kernel(), case.plain()
        err = float((got.double() - want.double()).abs().max())
        print(json.dumps({
            "tree": args.label, "case": case.name,
            "ms": cs.time_ms(case.kernel),
            "ms_cold": cs.time_ms(case.kernel, cold=True),
            "bound_ms": case.nbytes / cs.HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "gpu": power}), flush=True)
    print(power, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
