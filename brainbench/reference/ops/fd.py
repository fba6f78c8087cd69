"""Finite-difference gradients and curl (port of brainfm_tpu/ops/fd.py).

Forward, backward and central differences with one-sided boundary rows
over the last `ndim` axes of a tensor with any leading batch dimensions,
and the 3-D curl that makes the pathology generator's divergence-free
velocities.
"""

from __future__ import annotations

import torch


def _axis_diff(x, axis: int, kind: str):
    n = x.shape[axis]

    def sl(a, b):
        return x.narrow(axis, a, b - a)

    if kind == "f":  # forward interior, backward at the top edge
        interior = sl(1, n) - sl(0, n - 1)
        top = sl(n - 1, n) - sl(n - 2, n - 1)
        return torch.cat([interior, top], dim=axis)
    if kind == "b":  # backward interior, forward at the bottom edge
        bottom = sl(1, 2) - sl(0, 1)
        interior = sl(1, n) - sl(0, n - 1)
        return torch.cat([bottom, interior], dim=axis)
    if kind == "c":  # central interior, one-sided edges
        bottom = sl(1, 2) - sl(0, 1)
        interior = (sl(2, n) - sl(0, n - 2)) / 2.0
        top = sl(n - 1, n) - sl(n - 2, n - 1)
        return torch.cat([bottom, interior, top], dim=axis)
    raise ValueError(kind)


def axis_derivative(x, d: int, kind: str, ndim: int = 3, spacing=1.0):
    """One component of the gradient: the difference along spatial axis `d`
    of the last `ndim` axes, over `spacing`."""
    return _axis_diff(x, x.dim() - ndim + d, kind) / spacing


def _gradient(x, kind: str, ndim: int = 3, spacing=(1.0, 1.0, 1.0)):
    return torch.stack([axis_derivative(x, d, kind, ndim, spacing[d])
                        for d in range(ndim)], dim=-1)


def gradient_f(x, ndim: int = 3, spacing=(1.0, 1.0, 1.0)):
    return _gradient(x, "f", ndim, spacing)


def gradient_b(x, ndim: int = 3, spacing=(1.0, 1.0, 1.0)):
    return _gradient(x, "b", ndim, spacing)


def gradient_c(x, ndim: int = 3, spacing=(1.0, 1.0, 1.0)):
    return _gradient(x, "c", ndim, spacing)


def curl_3d(phi_a, phi_b, phi_c, spacing=(1.0, 1.0, 1.0)):
    """Curl of a 3-component potential: a divergence-free velocity. Only
    the six derivatives the curl uses are taken."""
    def dc(x, d):
        return axis_derivative(x, d, "c", 3, spacing[d])

    vx = dc(phi_c, 1) - dc(phi_b, 2)
    vy = dc(phi_a, 2) - dc(phi_c, 0)
    vz = dc(phi_b, 0) - dc(phi_a, 1)
    return vx, vy, vz
