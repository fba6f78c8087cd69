"""The center-aligned zoom and resolution change of serving (`myzoom`,
`myzoom_anisotropic`, `volume_resize`): a frozen copy of those functions
of the port's brainfm_tpu_torch/ops/resize.py.

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
from .blur import gaussian_blur_3d
from .separable import separable_resample


def _zoom_axis_coords(n_in: int, n_out: int, f: float, device):
    """Source coordinates of one axis, in fp32 as the JAX package computes
    them (`delta + arange(n_out) / f`, clipped to [0, n_in-1]); made on the
    host so every device samples at the same coordinates."""
    v = (np.float32((1.0 - f) / (2.0 * f))
         + np.arange(n_out, dtype=np.float32) / np.float32(f))
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
