"""Cells cut to a size a CPU test can run: f_maps 8, 3 levels, 32^3
crops from a 48^3 bank of two 40^3 subjects over at most two ranks;
serving two 40x48x32 heads in a 40^3 window, one request compared. The
limits stay the cell's own."""

from __future__ import annotations

import copy
import time

from brainbench import cells, run


def shrink(cell):
    c = copy.deepcopy(cell)
    cfg = c.config["cfg"]
    cfg["f_maps"], cfg["num_levels"], cfg["task_f_maps"] = 8, 3, [8]
    cfg["generator"]["size"] = [32, 32, 32]
    t = c.traffic
    if cells.is_training(t):
        t.update(subjects=2, extent=[40, 40, 40], bank_shape=[48, 48, 48])
        if "ranks" in t:
            t["ranks"] = min(int(t["ranks"]), 2)
    else:
        t.update(inputs=2, shape=[40, 48, 32], win=[40, 40, 40], samples=1,
                 sample_from=2)
    return c


def tiny_cell(name):
    return shrink(cells.load(name))


def execute(name, seed=12345678901, seconds=0.5, trace=0, cell=None):
    """One tiny run of `name` on the CPU: the result object."""
    return run.execute(cell or tiny_cell(name), seed, seconds, trace, "cpu",
                       time.time())
