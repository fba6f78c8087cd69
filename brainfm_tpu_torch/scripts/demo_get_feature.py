"""Feature extraction demo on the PyTorch port (twin of
scripts/demo_get_feature.py, after the reference's `get_brainid_feat`):
the last decoder feature map of any input volume.

    python -m brainfm_tpu_torch.scripts.demo_get_feature IMG
        [--ckp_path MODEL.pth] [--save_path FEAT.npy] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import load_config
from ..infer.api import Inferencer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def get_brainid_feat(img_path, ckp_path=None, win_size=None, cfg_paths=(),
                     device=None):
    cfg = load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                       os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
                       *cfg_paths])
    inf = Inferencer(cfg, ckpt_path=ckp_path, device=device)
    return inf.get_feature(img_path, win_size)  # (1, D, H, W, f_maps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("img_path")
    ap.add_argument("--ckp_path", default=None)
    ap.add_argument("--save_path", default=None)
    ap.add_argument("--train_cfg", default=None)
    ap.add_argument("--win", type=int, nargs=3, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    feat = get_brainid_feat(args.img_path, args.ckp_path, win_size=args.win,
                            cfg_paths=((args.train_cfg,) if args.train_cfg
                                       else ()),
                            device=args.device)
    print("feature:", tuple(feat.shape), feat.dtype)
    if args.save_path:
        np.save(args.save_path, feat.cpu().numpy())
        print("saved to", args.save_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
