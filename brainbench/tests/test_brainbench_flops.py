"""The analytic counts of brainbench/flops.py against what the port runs,
at a small size on the CPU."""

from __future__ import annotations

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from brainbench import cells, flops

SIZE = (32, 32, 32)


def small(name, remat=False):
    cfg = copy.deepcopy(cells.load(f"{name}.train").config["cfg"])
    cfg["f_maps"], cfg["num_levels"], cfg["task_f_maps"] = 8, 3, [8]
    cfg["generator"]["size"] = list(SIZE)
    cfg["remat"] = remat
    return cfg


def port_model(cfg):
    from brainfm_tpu_torch.config import AttrDict
    from brainfm_tpu_torch.models import build_model

    torch.manual_seed(0)
    return build_model(AttrDict.from_nested(copy.deepcopy(cfg)),
                       device="cpu")[1]


def _outputs(out):
    return [v for k, v in out.items() if not k.startswith("feat")]


@pytest.mark.parametrize("name", ["joint", "sep"])
def test_forward_flops_equal_the_ports(name):
    cfg = small(name)
    model = port_model(cfg)
    x = torch.randn(1, *SIZE, 1)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x)
    assert fc.get_total_flops() == flops.forward_flops(cfg, SIZE)


@pytest.mark.parametrize("name", ["joint", "sep"])
def test_step_flops_equal_the_ports(name):
    cfg = small(name)
    model = port_model(cfg)
    x = torch.randn(2, *SIZE, 1)
    with FlopCounterMode(display=False) as fc:
        loss = sum(v.float().square().mean() for v in _outputs(model(x)))
        loss.backward()
    assert fc.get_total_flops() == 2 * flops.step_flops(cfg, SIZE)


def test_flagship_forward_at_220():
    cfg = cells.load("joint.serve").config["cfg"]
    assert round(flops.forward_flops(cfg, (220, 220, 220)) / 1e12, 4) \
        == 21.0507


def _seen_groupnorm_inputs(monkeypatch, cfg, device):
    """(elements, bytes, needs a gradient) of the input of every GroupNorm
    call of the port's forward under bf16 autocast on `device`."""
    from brainfm_tpu_torch.models import unet3d

    seen = []

    def record(fn, n_tensors):
        def wrapped(*args, **kwargs):
            ts = args[:n_tensors]
            seen.append((sum(t.numel() for t in ts),
                         sum(t.numel() * t.element_size() for t in ts),
                         ts[0].requires_grad))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(unet3d, "fused_group_norm",
                        record(unet3d.fused_group_norm, 1))
    monkeypatch.setattr(unet3d, "pair_group_norm",
                        record(unet3d.pair_group_norm, 2))
    model = port_model(cfg).to(device)
    x = torch.randn(1, *SIZE, 1, device=device)
    with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
        model(x)
    return seen


@pytest.mark.parametrize("name", ["joint", "sep"])
def test_groupnorm_inputs_are_the_ones_the_port_normalises(name,
                                                           monkeypatch):
    """Elements and gradients on the CPU (whose autocast pools in fp32, so
    the bytes are held on the card, below)."""
    cfg = small(name)
    seen = _seen_groupnorm_inputs(monkeypatch, cfg, "cpu")
    want = flops.gn_inputs(cfg, SIZE)
    assert [(n, g) for n, _, g in seen] == [(n, not first)
                                           for n, _, first in want]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["joint", "sep"])
def test_groupnorm_bytes_equal_the_tensors_the_port_normalises(name,
                                                               monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("the bytes are those of bf16 autocast on the card")
    cfg = small(name)
    seen = _seen_groupnorm_inputs(monkeypatch, cfg, "cuda")
    assert sum(2 * b for _, b, _ in seen) == flops.gn_forward_bytes(cfg,
                                                                     SIZE)
    assert sum((3 if g else 2) * b for _, b, g in seen) \
        == flops.gn_backward_bytes(cfg, SIZE)
