"""The resize family (port of brainfm_tpu/ops/resize.py): the spline
resize with its anchors and its adjoint, the restriction
(`resize_spline`, `restrict_spline`), and the center-aligned zoom and
resolution change of serving (`myzoom`, `myzoom_anisotropic`,
`volume_resize`).

`resize_spline` is ops/pushpull.py::grid_pull at the anchored coordinates
(after the recursive prefilter of ops/coeff.py); `restrict_spline` is
`grid_push` at the same coordinates, the exact transpose of the resize
without prefilter, where the JAX package takes `jax.linear_transpose`.

`myzoom` is separable: three per-axis matrix products
(ops/separable.py::separable_resample) with the reference's
`delta=(1-f)/(2f)` offset and clamped coordinates. The JAX package runs it
at `highest` matmul precision; here the products and the anti-alias blur's
cuDNN convolutions run under `device.exact_fp32` (TF32 off for the call
only). Tensors stay on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import exact_fp32
from ..utils.profiling import count
from .blur import gaussian_blur_3d
from .coeff import spline_coeff_nd
from .pushpull import grid_pull, grid_push
from .separable import separable_resample


def _zoom_axis_coords(n_in: int, n_out: int, f: float, device):
    """Source coordinates of one axis, in fp32 as the JAX package computes
    them (`delta + arange(n_out) / f`, clipped to [0, n_in-1]); made on the
    host so every device samples at the same coordinates."""
    v = (np.float32((1.0 - f) / (2.0 * f))
         + np.arange(n_out, dtype=np.float32) / np.float32(f))
    count("host_syncs")   # the coordinates copied to the card
    return torch.from_numpy(np.clip(v, np.float32(0.0),
                                    np.float32(n_in - 1))).to(device)


def myzoom(x, factor, newsize=None):
    """Center-aligned linear zoom (parity: Generator/utils.py:200-249).

    x: (D,H,W) or (D,H,W,C) tensor. factor: 3 floats. An identity zoom
    returns `x` itself."""
    factor = np.asarray(factor, np.float64)
    insize = tuple(x.shape[:3])
    if newsize is None:
        newsize = np.round(np.array(insize) * factor).astype(int)
    newsize = tuple(int(v) for v in newsize)
    if newsize == insize and np.allclose(factor, 1.0):
        return x
    coords = [_zoom_axis_coords(insize[a], newsize[a], factor[a], x.device)
              for a in range(3)]
    with exact_fp32():
        return separable_resample(x, coords)


def myzoom_anisotropic(x, newsize, aff=None):
    """Zoom to an explicit output size (parity: utils/misc.py:1051-1115).
    Returns (y, new_aff) if aff given."""
    newsize = np.asarray(newsize, int)
    factors = newsize / np.array(x.shape[:3])
    y = myzoom(x, factors, newsize)
    if aff is None:
        return y
    aff_new = aff.copy()
    for c in range(3):
        aff_new[:-1, c] = aff_new[:-1, c] / factors[c]
    aff_new[:-1, -1] = aff_new[:-1, -1] - aff[:-1, :-1] @ (0.5 - 0.5 / factors)
    return y, aff_new


def volume_resize(img, aff, resolution, power_factor_at_half_width=5):
    """Gaussian-antialiased resolution change with affine update (parity:
    `torch_resize`, utils/misc.py:1117-1187).

    img: (D,H,W) or (D,H,W,C) tensor; aff: (4,4) numpy affine. A volume
    already at `resolution` is returned as it is, with a copy of aff."""
    if np.isscalar(resolution):
        resolution = np.full(3, float(resolution))
    voxsize = np.sqrt(np.sum(np.asarray(aff)[:-1, :-1] ** 2, axis=0))
    newsize = np.round(np.array(img.shape[:3]) * (voxsize / resolution)).astype(int)
    factors = np.array(img.shape[:3]) / newsize
    k = np.log(power_factor_at_half_width) / np.pi
    sigmas = k * factors
    sigmas[sigmas <= k] = 0.0
    if tuple(newsize) == tuple(img.shape[:3]) and not np.any(sigmas > 0):
        return img, np.asarray(aff).copy()

    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    with exact_fp32():
        blurred = torch.stack([gaussian_blur_3d(img[..., c], sigmas,
                                                truncate=2.5)
                               for c in range(img.shape[-1])], dim=-1)
    out, aff2 = myzoom_anisotropic(blurred, newsize, np.asarray(aff))
    if squeeze:
        out = out[..., 0]
    return out, aff2


def _anchor_coords(anchor: str, f: float, n_in: int, n_out: int, dtype,
                   device):
    """Source coordinates of the n_out output voxels of one axis."""
    a = anchor[0].lower()
    if a == "c":  # centres
        return torch.linspace(0.0, n_in - 1, n_out, dtype=dtype,
                              device=device)
    ar = torch.arange(n_out, dtype=dtype, device=device)
    if a == "e":  # edges
        scale = n_in / n_out
        return ar * scale + 0.5 * (scale - 1.0)
    if a == "f":  # first voxel
        return ar / f
    if a == "l":  # last voxel
        return ar / f + ((n_in - 1) - (n_out - 1) / f)
    raise ValueError(f"unknown anchor {anchor}")


def _resize_grid(inshape, shape, factor, anchor, dtype, device):
    anchors = [anchor] * len(shape) if isinstance(anchor, str) \
        else list(anchor)
    lin = [_anchor_coords(a, f, i, o, dtype, device)
           for a, f, i, o in zip(anchors, factor, inshape, shape)]
    return torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=-1)


def _coord_dtype(img):
    return img.dtype if img.is_floating_point() else torch.float32


def resize_spline(img, shape=None, factor=None, anchor="c", interpolation=1,
                  bound="nearest", prefilter=True, extrapolate=True):
    """Spline resize (parity: utils/interpol/resize.py:13). img:
    (*spatial,) or (*spatial, C), channels last; `shape` or `factor` gives
    the output grid; anchor c(entres), e(dges), f(irst) or l(ast), one or
    one per axis. Coordinates take the image's floating dtype."""
    ndim = img.dim()
    if shape is not None and img.dim() == len(shape) + 1:
        ndim = img.dim() - 1
    elif factor is not None and not np.isscalar(factor) \
            and img.dim() == len(factor) + 1:
        ndim = img.dim() - 1
    has_c = ndim < img.dim()
    inshape = tuple(img.shape[:ndim])
    if factor is not None:
        factor = [factor] * ndim if np.isscalar(factor) else list(factor)
    if shape is None:
        shape = [int(i * f) for i, f in zip(inshape, factor)]
    shape = list(shape)
    if factor is None:
        factor = [o / i for o, i in zip(shape, inshape)]
    grid = _resize_grid(inshape, shape, factor, anchor, _coord_dtype(img),
                        img.device)
    src = img
    if prefilter:
        if has_c:
            src = torch.movedim(spline_coeff_nd(
                torch.movedim(src, -1, 0), bound, interpolation, ndim), 0, -1)
        else:
            src = spline_coeff_nd(src, bound, interpolation, ndim)
    return grid_pull(src, grid, interpolation=interpolation, bound=bound,
                     extrapolate=extrapolate)


def restrict_spline(img, shape=None, factor=None, anchor="c",
                    interpolation=1, bound="nearest", reduce_sum=False,
                    normalize: str = "fullscale"):
    """Restriction to a coarser grid: the adjoint of `resize_spline`
    without prefilter (parity: utils/interpol/restrict.py), as grid_push
    at the coordinates the resize from the coarse grid would pull at.

    img: the fine-grid image (*fine_spatial[, C]; a 4-D image has a
    channel axis); `shape` / `factor` give the coarse output grid.
    reduce_sum keeps the summed splat. Otherwise `normalize`: 'fullscale'
    divides by the reference's constant, prod((n_fine-1)/(n_coarse-1)) per
    centres anchor and n_fine/n_coarse otherwise; 'count' divides by each
    voxel's adjoint mass (a local average everywhere)."""
    ndim = img.dim() if img.dim() <= 3 else img.dim() - 1
    spatial = tuple(img.shape[:ndim])
    if shape is None:
        if factor is None:
            raise ValueError("restrict_spline needs shape or factor")
        f = factor if isinstance(factor, (list, tuple)) else [factor] * ndim
        shape = tuple(int(round(s * ff)) for s, ff in zip(spatial, f))
    shape = tuple(shape)
    # the resize from the coarse grid to the fine one pulls here
    grid = _resize_grid(shape, spatial, [o / i for o, i in
                                         zip(spatial, shape)],
                        anchor, _coord_dtype(img), img.device)

    def push(x):
        return grid_push(x, grid, shape, interpolation=interpolation,
                         bound=bound, extrapolate=True)

    out = push(img)
    if reduce_sum:
        return out
    if normalize == "count":
        return out / push(torch.ones_like(img)).clamp(min=1e-12)
    fullscale = 1.0
    for s_f, s_c in zip(spatial, shape):
        if anchor.startswith("c"):
            fullscale *= (s_f - 1) / max(s_c - 1, 1)
        else:
            fullscale *= s_f / s_c
    return out / fullscale
