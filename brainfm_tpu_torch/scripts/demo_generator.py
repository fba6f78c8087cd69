"""Generator demo on the PyTorch port (twin of scripts/demo_generator.py,
the JAX package's):

    python -m brainfm_tpu_torch.scripts.demo_generator [--gen_cfg NAME]
        [--num_deformations 2] [--mode synth|T1|T2|FLAIR|CT]
        [--save_dir outs/demo_generator] [--seed 0] [--device cpu]

Synthesizes one item per deformation from the first subject of the bank
(scripts/train.py::build_bank: the configured data root, or procedural
subjects) and writes each sample's input as d{d}_s{s}_input and each
target as d{d}_target_{name} (the segmentation as its argmax) in NIfTI
under --save_dir. Deformation d draws from a torch.Generator seeded from
(--seed, d); jax.random's numbers cannot be replayed, so the two twins
write different volumes of the same names and shapes. Runs on CUDA unless
--device says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import load_config
from ..device import resolve_device
from ..synth import SynthStatic, synth_item
from ..synth.engine import build_knobs_stack
from ..utils.nifti import viewVolume
from .train import build_bank

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TARGETS = ("T1", "segmentation", "distance", "registration")


def deformation_generator(dev, seed: int, d: int) -> torch.Generator:
    """The generator of deformation d, seeded from (seed, d) only."""
    s = np.random.SeedSequence((seed, d)).generate_state(1, np.uint64)
    return torch.Generator(dev).manual_seed(int(s[0] >> np.uint64(1)))


def main(argv=None, record=None):
    """The CLI. `record` (a list), when given, receives each deformation's
    recorded draws, so synth_item(draws=record[d]) replays it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gen_cfg", default=None)
    ap.add_argument("--save_dir", default="outs/demo_generator")
    ap.add_argument("--num_deformations", type=int, default=2)
    ap.add_argument("--mode", default="synth",
                    choices=["synth", "T1", "T2", "FLAIR", "CT"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                       args.gen_cfg],
                      cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    scfg = SynthStatic.from_cfg(cfg)
    tasks = tuple(k for k, v in dict(cfg.task).items() if v)
    bank = build_bank(cfg)
    knobs = build_knobs_stack(scfg, args.mode)
    os.makedirs(args.save_dir, exist_ok=True)

    subject = bank.to_device(0, dev)
    if args.mode != "synth":
        # the real-image branch reads subject['image']
        if args.mode not in subject:
            raise SystemExit(f"subject has no {args.mode} volume")
        subject = dict(subject)
        subject["image"] = subject[args.mode]

    for d in range(args.num_deformations):
        t0 = time.time()
        rec = {} if record is not None else None
        target, samples = synth_item(deformation_generator(dev, args.seed, d),
                                     subject, scfg, tasks, args.mode, knobs,
                                     record=rec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"deformation {d}: {time.time() - t0:.2f}s")
        if record is not None:
            record.append(rec)
        for s in range(scfg.all_samples):
            viewVolume(samples["input"][s, ..., 0].float().cpu().numpy(),
                       names=[f"d{d}_s{s}_input"], save_dir=args.save_dir)
        for name in TARGETS:
            if name in target:
                arr = target[name]
                arr = (arr.argmax(-1).float() if name == "segmentation"
                       else arr[..., 0])
                viewVolume(arr.float().cpu().numpy(),
                           names=[f"d{d}_target_{name}"],
                           save_dir=args.save_dir)
    print("outputs in", args.save_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
