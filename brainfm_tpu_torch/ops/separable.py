"""Separable resampling as per-axis matrix products (port of
brainfm_tpu/ops/separable.py).

Axis-aligned resampling (zoom, restore-to-grid, gaussian blur) applies an
independent 1-D linear operator per axis; the operators are built from
coordinates that may be tensors, so random effective sizes need no
data-dependent shapes.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count


def linear_resample_matrix(coords, n_in: int, upper=None,
                           mask_oob: bool = False):
    """(n_out, n_in) row-stochastic linear interpolation matrix sampling at
    `coords`. `upper`: effective last valid index (default n_in-1), where
    rows clamp. `mask_oob=True` zeroes rows whose coordinate falls outside
    [tiny, upper], `tiny` the smallest normal float of the coordinates'
    type: the reference tests `coords > 0` under XLA, which flushes
    denormals to zero, so a denormal coordinate is out of bounds there
    (the rule of ops/interp.py::trilinear3d)."""
    if not (torch.is_tensor(upper) and upper.device == coords.device):
        count("host_syncs")   # the bound copied to the card
    up = torch.as_tensor(n_in - 1 if upper is None else upper,
                         dtype=torch.float32, device=coords.device)
    tiny = torch.finfo(coords.dtype).tiny
    ok = (coords >= tiny) & (coords <= up) if mask_oob else None
    c = torch.minimum(coords.clamp(min=0.0), up)
    f = torch.floor(c)
    w = (c - f)[:, None]
    cols = torch.arange(n_in, device=coords.device)[None, :]
    fcol = f[:, None]
    lo = (cols == fcol).float()
    hi = (cols == torch.minimum(fcol + 1, up)).float()
    W = lo * (1.0 - w) + hi * w
    if mask_oob:
        W = W * ok[:, None]
    return W


def gaussian_matrix(sigma, n: int, truncate: float = 3.0):
    """(n, n) gaussian blur matrix with zero ('same') padding and support
    masked at ceil(truncate*sigma), as ops/blur.py's kernels."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    idx = torch.arange(n, dtype=torch.float32, device=sigma.device)
    d = idx[:, None] - idx[None, :]
    safe = sigma.clamp(min=1e-6)
    g = torch.exp(-(d / safe) ** 2 / 2.0)
    support = torch.ceil(truncate * sigma)
    g = torch.where(d.abs() <= support, g, 0.0)
    # normalized by the unpadded kernel sum: zero padding loses mass at the
    # edges, as a convolution with zero padding does
    k = torch.arange(-n + 1, n, dtype=torch.float32, device=sigma.device)
    gk = torch.exp(-(k / safe) ** 2 / 2.0)
    gk = torch.where(k.abs() <= support, gk, 0.0)
    g = g / gk.sum()
    eye = (d == 0).float()
    return torch.where(sigma > 0, g, eye)


def apply_axis_matrix(x, W, axis: int):
    """Contract axis `axis` of x with the (n_out, n_in) matrix W, in
    promote(x.dtype, float32)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xm = torch.movedim(x, axis, -1).to(acc)
    return torch.movedim(xm @ W.to(acc).T, -1, axis)


def separable_resample(x, coords_per_axis):
    """Resample (D,H,W[,C]) at per-axis coordinate vectors; keeps a floating
    input's dtype."""
    orig = x.dtype
    for ax, coords in enumerate(coords_per_axis):
        W = linear_resample_matrix(coords, x.shape[ax])
        x = apply_axis_matrix(x, W, ax)
    return x.to(orig) if orig.is_floating_point else x


def separable_blur_matmul(x, sigmas, truncate: float = 3.0):
    """Gaussian blur of (D,H,W) as three matrix products."""
    for ax in range(3):
        W = gaussian_matrix(sigmas[ax], x.shape[ax], truncate).to(x.device)
        x = apply_axis_matrix(x, W, ax)
    return x
