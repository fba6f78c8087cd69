"""Loss primitives (port of brainfm_tpu/models/losses.py).

Weighted l1/l2, gaussian/laplace NLL (uncertainty heads), forward-difference
gradient loss, smoothness, and the determinant-of-Hessian regularizer.
Channels-last: images are (..., D, H, W, C); the spatial axes are the three
before the channel.
"""

from __future__ import annotations

import math

import torch


def l1_loss(outputs, targets, weights=1.0):
    return torch.mean(torch.abs(outputs - targets) * weights)


def l2_loss(outputs, targets, weights=1.0):
    return torch.mean((outputs - targets) ** 2 * weights)


def gaussian_loss(mu, log_sigma, targets, weights=1.0):
    variance = torch.exp(log_sigma)
    nll = (0.5 * torch.log(2 * math.pi * variance)
           + 0.5 * (targets - mu) ** 2 / variance)
    return torch.mean(nll * weights)


def laplace_loss(mu, log_b, targets, weights=1.0):
    b = torch.exp(log_b)
    nll = torch.log(2 * b) + torch.abs(targets - mu) / b
    return torch.mean(nll * weights)


def _fwd_diff(x):
    """Forward differences along the 3 spatial axes (-4, -3, -2), each with
    its last slice zeroed: roll by one, subtract, zero."""
    outs = []
    for ax in (-4, -3, -2):
        d = torch.roll(x, -1, dims=ax) - x
        d.narrow(ax, x.shape[ax] - 1, 1).zero_()
        outs.append(d)
    return outs


def gradient_loss(inp, target, weights=1.0, mode="l1"):
    fn = l1_loss if mode == "l1" else l2_loss
    di = _fwd_diff(inp)
    dt = _fwd_diff(target)
    return (fn(di[0], dt[0], weights) + fn(di[1], dt[1], weights)
            + fn(di[2], dt[2], weights))


def smoothness_loss(inp, mode="l2"):
    d = _fwd_diff(inp)
    if mode == "l1":
        return torch.mean(torch.abs(d[0]) + torch.abs(d[1]) + torch.abs(d[2]))
    return torch.mean(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)


def hessian_loss(inp, mode="l2"):
    """Det-of-Hessian, including the reference's reuse of the mixed
    partials from the later difference calls: ddxy, ddxz and ddyz are
    rebound, as in the JAX package."""
    dx, dy, dz = _fwd_diff(inp)
    ddxx, ddxy, ddxz = _fwd_diff(dx)
    ddxy, ddyy, ddyz = _fwd_diff(dy)
    ddxz, ddyz, ddzz = _fwd_diff(dz)
    det = (ddxx * (ddyy * ddzz - ddyz ** 2)
           - ddxy * (ddxy * ddzz - ddxz * ddyz)
           + ddxz * (ddxy * ddyz - ddxz * ddyy))
    if mode == "l1":
        return torch.sum(torch.abs(det))
    return torch.sum(det ** 2)
