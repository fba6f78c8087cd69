"""The analytic count of brainbench/flops_twostage.py against what the
port's two-stage pair runs, at a small size on the CPU, and at 220^3."""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode

from brainbench import cells, flops_twostage

SIZE = (32, 32, 32)


def small():
    cfg = copy.deepcopy(cells.load("twostage.serve").config["cfg"])
    cfg["f_maps"], cfg["num_levels"], cfg["task_f_maps"] = 8, 3, [8]
    return cfg


def port_pair(cfg):
    from brainfm_tpu_torch.config import AttrDict
    from brainfm_tpu_torch.models.build import build_inpaint_model

    torch.manual_seed(0)
    return build_inpaint_model(AttrDict.from_nested(copy.deepcopy(cfg)),
                               device="cpu")[1]


def _flops(fn):
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_forward_flops_equal_the_ports():
    cfg = small()
    pair = port_pair(cfg)
    x = torch.randn(1, *SIZE, 1)
    assert _flops(lambda: pair(x)) == flops_twostage.forward_flops(cfg, SIZE)


def test_each_stage_equals_the_ports():
    """Stage 0 on the scan; stage 1 on its two channels, the masked scan
    and the mask."""
    cfg = small()
    pair = port_pair(cfg)
    x = torch.randn(1, *SIZE, 1)
    m = torch.rand(1, *SIZE, 1)
    want = flops_twostage.stage_forward_flops(cfg, SIZE)
    assert _flops(lambda: pair.pathol(x)) == want[0]
    assert _flops(lambda: pair.task(x * (1 - m), cond=m)) == want[1]


def test_pair_forward_at_220():
    cfg = cells.load("twostage.serve").config["cfg"]
    s0, s1 = flops_twostage.stage_forward_flops(cfg, (220, 220, 220))
    assert (round(s0 / 1e12, 4), round(s1 / 1e12, 4)) == (20.4251, 20.5239)
    assert round(flops_twostage.forward_flops(cfg, (220, 220, 220)) / 1e12,
                 4) == 40.949
