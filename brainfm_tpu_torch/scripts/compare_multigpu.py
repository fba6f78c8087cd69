#!/usr/bin/env python3
"""Run one tree's `multigpu_reference` phase of chip_smoke.py alone, for
comparing two trees on one card.

    python3 brainfm_tpu_torch/scripts/compare_multigpu.py [--tree DIR]

Imports chip_smoke.py and `brainfm_tpu_torch` from DIR (default: this
checkout; for another commit, unpack it with `git archive <commit> | tar
-x -C DIR`), builds its kernels, gives the flagship model the slice's
weights (seed 0, as chip_smoke.py's `slice` phase makes them) and calls
that tree's `check_multigpu_reference`, which spawns its two ranks on the
card and prints its JSON line. Compare two trees only inside one call on
one card, in turns (parent, change, change, parent). Run it by its path:
`python -m` would import this checkout's package first.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    tree = os.path.abspath(ap.parse_args(argv).tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not "
                           f"{tree}")
    if not torch.cuda.is_available():
        print("compare_multigpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.kernels.build()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    _, model = cs.build_model(cs.process_args(cs.flagship_cfg()), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "slice_l6.pth")
        torch.save({"model": model.state_dict()}, pth)
        del model
        torch.cuda.empty_cache()
        print(f"# tree {tree}", flush=True)
        cs.check_multigpu_reference(dev, cs.gpu_name_power(), pth, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
