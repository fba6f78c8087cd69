"""Separable 3-D Gaussian blur (port of brainfm_tpu/ops/blur.py).

Concrete sigmas give the reference's exact kernels (half-width
ceil(truncate*sigma)). Sigmas held in a tensor use a fixed-width kernel
(radius from the static `max_sigma`) whose taps beyond ceil(truncate*sigma)
are zeroed, which equals the reference kernel after normalization.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, truncate: float = 3.0):
    """Kernel for a concrete sigma."""
    sl = int(np.ceil(truncate * float(sigma)))
    ts = np.arange(-sl, sl + 1, dtype=np.float32)
    g = np.exp(-((ts / float(sigma)) ** 2) / 2.0)
    return torch.from_numpy(g / g.sum())


def _masked_kernel(sigma, radius: int, truncate: float):
    ts = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=sigma.device)
    safe = sigma.clamp(min=1e-6)
    g = torch.exp(-((ts / safe) ** 2) / 2.0)
    support = torch.ceil(truncate * sigma)
    g = torch.where(ts.abs() <= support, g, 0.0)
    g = g / g.sum()
    delta = (ts == 0).float()
    return torch.where(sigma > 0, g, delta)


def _conv_axis(x, kernel, axis: int):
    """Correlate `x` with a 1-D kernel along `axis`, 'same' zero padding,
    in float32."""
    k = kernel.shape[0]
    x = torch.movedim(x, axis, -1)
    shp = x.shape
    xr = x.reshape(-1, 1, shp[-1]).float()
    out = F.conv1d(xr, kernel.reshape(1, 1, k).float().to(x.device),
                   padding=k // 2)
    return torch.movedim(out.reshape(shp), -1, axis)


def gaussian_blur_3d(x, sigmas, truncate: float = 3.0,
                     max_sigma: float | None = None):
    """Separable blur of a (D,H,W) volume; axes with sigma <= 0 are left
    untouched."""
    concrete = (isinstance(sigmas, (list, tuple, np.ndarray))
                or np.isscalar(sigmas))
    if concrete:
        sig = np.broadcast_to(np.asarray(sigmas, np.float64), (3,))
        for ax in range(3):
            if sig[ax] > 0:
                x = _conv_axis(x, gaussian_kernel_1d(sig[ax], truncate), ax)
        return x
    if max_sigma is None:
        raise ValueError("sigmas held in a tensor need a static max_sigma")
    radius = int(math.ceil(truncate * max_sigma))
    for ax in range(3):
        x = _conv_axis(x, _masked_kernel(sigmas[ax], radius, truncate), ax)
    return x
