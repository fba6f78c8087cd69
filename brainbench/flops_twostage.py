"""Analytic forward FLOPs of the two-stage pair (backbone `unet3d+unet3d`),
from the configuration alone, by flops.py's conventions applied to each
stage: stage 0 is a UNet3D on the one-channel scan with the pathology
head alone; stage 1 a UNet3D on two channels (the masked scan and the
mask), so its first convolution has two input channels, with every other
head. The sigmoid, the masking and the concatenation between them are not
convolutions and are not counted.
"""

from __future__ import annotations

import copy

from . import flops


def stage_cfgs(cfg):
    """(stage 0's, stage 1's) configuration as flops.py counts a single
    UNet3D with its head."""
    tasks = {k: bool(v) for k, v in dict(cfg["task"]).items()}
    if not tasks.get("pathology"):
        raise ValueError("a two-stage pair needs the pathology task")
    cin = int(cfg.get("in_channels") or 1)
    s0, s1 = copy.deepcopy(dict(cfg)), copy.deepcopy(dict(cfg))
    s0.update(backbone="unet3d", in_channels=cin,
              task={k: k == "pathology" for k in tasks})
    s1.update(backbone="unet3d", in_channels=cin + 1,
              task={k: v and k != "pathology" for k, v in tasks.items()})
    return s0, s1


def stage_forward_flops(cfg, size):
    """(stage 0's, stage 1's) forward FLOPs of one sample at `size`."""
    s0, s1 = stage_cfgs(cfg)
    return flops.forward_flops(s0, size), flops.forward_flops(s1, size)


def forward_flops(cfg, size) -> int:
    """One sample's forward through both stages at spatial `size`."""
    return sum(stage_forward_flops(cfg, size))
