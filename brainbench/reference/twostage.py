"""The plain reference of BrainFM's two-stage mask-then-inpaint pair
(jhuldr/BrainFM `cfgs/trainer/train/twostage.yaml`: backbone
`unet3d+unet3d`), served.

Stage 0 is a UNet3D with a one-channel pathology head; its sigmoid is the
lesion mask m. Stage 1 is a second UNet3D of the same geometry whose input
is the two channels cat([x * (1 - m), m]); its head has every other
output. The processors run on stage 1's outputs with `pathology` = m (a
sigmoid already, not squashed again); `postprocess` is model.py's.

Built from model.py's UNet3D, TaskHead and Joiner (plain `F.conv3d` and
`F.group_norm`, channels last at the joiners, float32), so `quant` works
as there (model.set_arithmetic). Parameter names are the port's TwoStage
ones (`pathol.*`, `task.*`), so one state dict loads into both.

Departures from the published description: the forward returns the head
outputs only, not the two stages' feature pyramids (`feat_pathol`,
`feat_task`), which nothing served reads; the mask is not detached (the
published training's `train_stage0` switch), which changes no value of a
forward.
"""

from __future__ import annotations

import torch
from torch import nn

from . import model as rm


class TwoStage(nn.Module):
    def __init__(self, pathol, task):
        super().__init__()
        self.pathol = pathol
        self.task = task

    def forward(self, x):
        """x (N, D, H, W, 1) -> stage 1's raw outputs and the mask
        'pathology', channels last."""
        m = torch.sigmoid(self.pathol(x)["pathology"])
        out = self.task(torch.cat([x * (1.0 - m), m], dim=-1))
        out["pathology"] = m
        return out


def build_model(cfg, device):
    """The reference pair of a processed config, float32 on `device`:
    (cfg, TwoStage)."""
    cfg = rm.process_args(cfg)
    if (cfg.backbone or "unet3d+unet3d") != "unet3d+unet3d":
        raise ValueError("the reference pair is unet3d+unet3d")
    if (cfg.layer_order or "gcl") != "gcl":
        raise ValueError("the reference builds 'gcl' blocks only")
    fm, tfm = int(cfg.f_maps or 64), tuple(cfg.task_f_maps or [64])
    geo = (fm, int(cfg.num_levels or 5), int(cfg.num_groups or 8),
           bool(cfg.unit_feat))
    cin = int(cfg.in_channels or 1)
    rest = {k: v for k, v in cfg.out_channels.items() if k != "pathology"}
    pair = TwoStage(
        rm.Joiner(rm.UNet3D(cin, *geo), rm.TaskHead(fm, tfm,
                                                    {"pathology": 1})),
        rm.Joiner(rm.UNet3D(cin + 1, *geo), rm.TaskHead(fm, tfm, rest)))
    return cfg, pair.to(device)


def apply_processors(out: dict, cfg) -> dict:
    """model.py's processors on stage 1's outputs; the mask kept as it
    is."""
    rest = rm.apply_processors({k: v for k, v in out.items()
                                if k != "pathology"}, cfg)
    rest["pathology"] = out["pathology"]
    return rest
