"""Whole-volume and tiled inference demo on the PyTorch port (twin of
scripts/demo_test.py, the JAX package's demo):

    python -m brainfm_tpu_torch.scripts.demo_test IMG [--tiled] [--exact]
        [--atlas MNI.mgz] [--ckp_path MODEL.pth] [--device cpu]

Serves one volume with the model built once, renders the deformed atlas
from the predicted registration when the atlas file exists, and writes
every output as NIfTI under --save_dir. Runs on CUDA unless --device says
otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import load_config
from ..infer.api import Inferencer, default_atlas_path, get_deformed_atlas
from ..infer.prepare import prepare_image
from ..utils.nifti import viewVolume

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("img_path")
    ap.add_argument("--ckp_path", default=None)
    ap.add_argument("--save_dir", default="outs/demo_test")
    ap.add_argument("--tiled", action="store_true")
    ap.add_argument("--win", type=int, nargs=3, default=[220, 220, 220])
    ap.add_argument("--tile_win", type=int, nargs=3, default=[160, 160, 160])
    ap.add_argument("--stride", type=int, nargs=3, default=[80, 80, 80])
    ap.add_argument("--gen_cfg", default=None)
    ap.add_argument("--train_cfg", default=None)
    ap.add_argument("--atlas", default=None,
                    help="MNI atlas volume for deformed-atlas rendering; "
                         "defaults to the `atlas_path` config key, then "
                         "$BRAINFM_ATLAS_PATH, then files/gca.mgz")
    ap.add_argument("--exact", action="store_true",
                    help="fp32 with TF32 off (reference parity); default "
                         "is bf16 autocast")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = load_config([
        os.path.join(ROOT, "cfgs/generator/default.yaml"),
        os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
        os.path.join(ROOT, "cfgs/trainer/default_val.yaml"),
        args.gen_cfg, args.train_cfg])
    if args.atlas is None:
        args.atlas = default_atlas_path(cfg)

    inf = Inferencer(cfg, ckpt_path=args.ckp_path,
                     compute_dtype=(torch.float32 if args.exact
                                    else torch.bfloat16),
                     exact=args.exact, device=args.device)
    im, aff, _, _ = prepare_image(args.img_path, list(args.win),
                                  device=inf.device)
    os.makedirs(args.save_dir, exist_ok=True)

    if args.tiled:
        outs = inf.evaluate_tiled(im, tuple(args.stride), tuple(args.tile_win))
    else:
        outs = inf.evaluate_image(im)
        outs = {k: v[0] for k, v in outs.items() if k != "feat"}

    # deformed-atlas rendering from predicted MNI coords
    # (parity: demo_test.py:61-63,102-104)
    if all(k in outs for k in ("regx", "regy", "regz", "label")) \
            and os.path.isfile(args.atlas):
        outs["deformed_atlas"] = get_deformed_atlas(
            outs["label"][..., 0], outs["regx"][..., 0],
            outs["regy"][..., 0], outs["regz"][..., 0], args.atlas)

    for k, v in outs.items():
        arr = v.cpu().numpy().squeeze()
        viewVolume(arr, aff, names=[f"out_{k}"], save_dir=args.save_dir)
        print("saved", k, arr.shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
