"""Coordinate warps of the generator (port of brainfm_tpu/ops/warp_auto.py
and ops/pallas_warp_blocks.py).

`warp_volume` (trilinear, per-channel out-of-bounds defaults) and
`warp_labels` (nearest, int32 labels) launch K1 (csrc/warp.cu,
`warp_linear_f32` / `warp_nearest_i32`) on CUDA tensors and take the plain
versions of ops/interp.py on CPU tensors only.

The TPU path needs a block plan (`plan_trim`, `_blocks_plan`), an
overflow count and an exact-gather fallback (`_overflow_guard`) only
because Mosaic cannot gather: its kernel reads a static patch of the
source per output tile. The CUDA kernel gathers directly, has no static
patch and nothing to overflow, so these functions return the warped volume
only. The kernel's bound on the H100 is bytes: source, coordinates and
output each moved once.
"""

from __future__ import annotations

import torch

from .. import kernels
from .interp import nearest3d, trilinear3d


def _check_cuda(name, vol, grid, vol_dtype):
    ii, jj, kk = grid
    dev = vol.device
    if dev.type != "cuda" or any(c.device != dev for c in grid):
        raise ValueError(f"{name}: volume on {dev}, coordinates on "
                         f"{[str(c.device) for c in grid]}; all must be on "
                         "one CUDA device or all on the CPU")
    if vol.dtype != vol_dtype or any(c.dtype != torch.float32 for c in grid):
        raise TypeError(f"{name}: volume {vol.dtype} (want {vol_dtype}), "
                        f"coordinates {[c.dtype for c in grid]} (want float32)")
    if vol.dim() not in (3, 4) or not (ii.shape == jj.shape == kk.shape):
        raise ValueError(f"{name}: volume (D,H,W[,C]) and three coordinate "
                         "tensors of one shape")
    if not (vol.is_contiguous() and all(c.is_contiguous() for c in grid)):
        raise ValueError(f"{name}: tensors must be contiguous")
    D, H, W = vol.shape[:3]
    C = 1 if vol.dim() == 3 else vol.shape[3]
    out_shape = ii.shape if vol.dim() == 3 else (*ii.shape, C)
    return D, H, W, C, out_shape


def warp_volume(vol, grid, default=0.0, approx=False):
    """Trilinear warp of a float32 volume (D,H,W[,C]) at the source
    coordinates `grid` = (ii, jj, kk); `default` is a scalar or a (C,)
    vector. `approx` selected a bf16 mode of the TPU kernel; the CUDA
    kernel always accumulates in fp32, so it has no effect here."""
    del approx
    ii, jj, kk = grid
    if vol.device.type == "cpu" and all(c.device.type == "cpu" for c in grid):
        return trilinear3d(vol, ii, jj, kk, default)
    D, H, W, C, out_shape = _check_cuda("warp_volume", vol, grid,
                                        torch.float32)
    dflt = torch.as_tensor(default, dtype=torch.float32, device=vol.device)
    dflt = dflt.reshape(-1).expand(C).contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=vol.device)
    kernels.launch("warp_linear_f32", vol.data_ptr(), ii.data_ptr(),
                   jj.data_ptr(), kk.data_ptr(), dflt.data_ptr(),
                   out.data_ptr(), D, H, W, C, ii.numel())
    return out


def warp_labels(vol, grid):
    """Nearest-neighbour warp of an int32 label volume (D,H,W[,C]):
    coordinates round half to even, then clip to the volume."""
    ii, jj, kk = grid
    if vol.device.type == "cpu" and all(c.device.type == "cpu" for c in grid):
        return nearest3d(vol, ii, jj, kk)
    D, H, W, C, out_shape = _check_cuda("warp_labels", vol, grid, torch.int32)
    out = torch.empty(out_shape, dtype=torch.int32, device=vol.device)
    kernels.launch("warp_nearest_i32", vol.data_ptr(), ii.data_ptr(),
                   jj.data_ptr(), kk.data_ptr(), out.data_ptr(), D, H, W, C,
                   ii.numel())
    return out
