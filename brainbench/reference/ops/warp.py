"""Trilinear and nearest warps of a volume at source coordinates, in plain
PyTorch on any device: the versions the port's hand-written warp kernel is
held to (frozen copies of brainfm_tpu_torch/ops/warp.py's CPU path)."""

from __future__ import annotations

from .interp import nearest3d, trilinear3d


def warp_volume(vol, grid, default=0.0, approx=False):
    """Trilinear warp of a float32 volume (D,H,W[,C]) at the source
    coordinates `grid` = (ii, jj, kk); `default` is a scalar or a (C,)
    vector."""
    del approx
    ii, jj, kk = grid
    return trilinear3d(vol, ii, jj, kk, default)


def warp_labels(vol, grid):
    """Nearest-neighbour warp of an int32 label volume (D,H,W[,C]):
    coordinates round half to even, then clip to the volume."""
    ii, jj, kk = grid
    return nearest3d(vol, ii, jj, kk)
