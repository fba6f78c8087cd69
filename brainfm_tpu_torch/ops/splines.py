"""B-spline basis weights and their first and second derivatives, orders
0-7 (port of brainfm_tpu/ops/splines.py: the centered B-spline pieces of
Thevenaz & Unser, the order resolved in Python)."""

from __future__ import annotations

import torch


def _w(x, order: int):
    """Weight polynomial on |x| (the caller applies the support window)."""
    if order == 0:
        return torch.ones_like(x)
    x = x.abs()
    if order == 1:
        return 1.0 - x
    if order == 2:
        return torch.where(x < 0.5, 0.75 - x * x, 0.5 * (1.5 - x) ** 2)
    if order == 3:
        low = (x * x * (x - 2.0) * 3.0 + 4.0) / 6.0
        up = (2.0 - x) ** 3 / 6.0
        return torch.where(x < 1.0, low, up)
    if order == 4:
        x2 = x * x
        low = x2 * (x2 * 0.25 - 0.625) + 115.0 / 192.0
        mid = x * (x * (x * (5.0 - x) / 6.0 - 1.25) + 5.0 / 24.0) + 55.0 / 96.0
        up = (x - 2.5) ** 4 / 24.0
        return torch.where(x < 0.5, low, torch.where(x < 1.5, mid, up))
    if order == 5:
        x2 = x * x
        low = x2 * (x2 * (0.25 - x / 12.0) - 0.5) + 0.55
        mid = x * (x * (x * (x * (x / 24.0 - 0.375) + 1.25) - 1.75)
                   + 0.625) + 0.425
        up = (3.0 - x) ** 5 / 120.0
        return torch.where(x < 1.0, low, torch.where(x < 2.0, mid, up))
    if order == 6:
        x2 = x * x
        low = (x2 * (x2 * (7.0 / 48.0 - x2 / 36.0) - 77.0 / 192.0)
               + 5887.0 / 11520.0)
        midl = (x * (x * (x * (x * (x * (x / 48.0 - 7.0 / 48.0) + 0.328125)
                - 35.0 / 288.0) - 91.0 / 256.0) - 7.0 / 768.0)
                + 7861.0 / 15360.0)
        midu = (x * (x * (x * (x * (x * (7.0 / 60.0 - x / 120.0) - 0.65625)
                + 133.0 / 72.0) - 2.5703125) + 1267.0 / 960.0)
                + 1379.0 / 7680.0)
        up = (x - 3.5) ** 6 / 720.0
        return torch.where(x < 0.5, low, torch.where(
            x < 1.5, midl, torch.where(x < 2.5, midu, up)))
    if order == 7:
        x2 = x * x
        low = (x2 * (x2 * (x2 * (x / 144.0 - 1.0 / 36.0) + 1.0 / 9.0)
                     - 1.0 / 3.0) + 151.0 / 315.0)
        midl = (x * (x * (x * (x * (x * (x * (0.05 - x / 240.0) - 7.0 / 30.0)
                + 0.5) - 7.0 / 18.0) - 0.1) - 7.0 / 90.0) + 103.0 / 210.0)
        midu = (x * (x * (x * (x * (x * (x * (x / 720.0 - 1.0 / 36.0)
                + 7.0 / 30.0) - 19.0 / 18.0) + 49.0 / 18.0) - 23.0 / 6.0)
                + 217.0 / 90.0) - 139.0 / 630.0)
        up = (4.0 - x) ** 7 / 5040.0
        return torch.where(x < 1.0, low, torch.where(
            x < 2.0, midl, torch.where(x < 3.0, midu, up)))
    raise NotImplementedError(order)


def spline_weight(x, order: int):
    w = _w(x, order)
    return torch.where(x.abs() >= (order + 1) / 2.0, 0.0, w)


def _g(x, order: int):
    """First-derivative polynomial on |x|; order 1 is -1, the derivative
    of the hat function."""
    if order == 1:
        return -torch.ones_like(x)
    if order == 2:
        return torch.where(x < 0.5, -2.0 * x, x - 1.5)
    if order == 3:
        return torch.where(x < 1.0, x * (x * 1.5 - 2.0), -0.5 * (2.0 - x) ** 2)
    if order == 4:
        low = x * (x * x - 1.25)
        mid = x * (x * (x * (-2.0 / 3.0) + 2.5) - 2.5) + 5.0 / 24.0
        up = (2.0 * x - 5.0) ** 3 / 48.0
        return torch.where(x < 0.5, low, torch.where(x < 1.5, mid, up))
    if order == 5:
        low = x * (x * (x * (x * (-5.0 / 12.0) + 1.0)) - 1.0)
        mid = x * (x * (x * (x * (5.0 / 24.0) - 1.5) + 3.75) - 3.5) + 0.625
        up = (x - 3.0) ** 4 / (-24.0)
        return torch.where(x < 1.0, low, torch.where(x < 2.0, mid, up))
    if order == 6:
        x2 = x * x
        low = x * (x2 * (7.0 / 12.0) - x2 * x2 / 6.0 - 77.0 / 96.0)
        midl = (x * (x * (x * (x * (x * 0.125 - 35.0 / 48.0) + 1.3125)
                - 35.0 / 96.0) - 0.7109375) - 7.0 / 768.0)
        midu = (x * (x * (x * (x * (x / (-20.0) + 7.0 / 12.0) - 2.625)
                + 133.0 / 24.0) - 5.140625) + 1267.0 / 960.0)
        up = (2.0 * x - 7.0) ** 5 / 3840.0
        return torch.where(x < 0.5, low, torch.where(
            x < 1.5, midl, torch.where(x < 2.5, midu, up)))
    if order == 7:
        x2 = x * x
        low = x * (x2 * (x2 * (x * (7.0 / 144.0) - 1.0 / 6.0) + 4.0 / 9.0)
                   - 2.0 / 3.0)
        midl = (x * (x * (x * (x * (x * (x * (-7.0 / 240.0) + 3.0 / 10.0)
                - 7.0 / 6.0) + 2.0) - 7.0 / 6.0) - 1.0 / 5.0) - 7.0 / 90.0)
        midu = (x * (x * (x * (x * (x * (x * (7.0 / 720.0) - 1.0 / 6.0)
                + 7.0 / 6.0) - 38.0 / 9.0) + 49.0 / 6.0) - 23.0 / 3.0)
                + 217.0 / 90.0)
        up = (x - 4.0) ** 6 / (-720.0)
        return torch.where(x < 1.0, low, torch.where(
            x < 2.0, midl, torch.where(x < 3.0, midu, up)))
    raise NotImplementedError(order)


def spline_grad(x, order: int):
    if order == 0:
        return torch.zeros_like(x)
    g = _g(x.abs(), order) * torch.sign(x)
    return torch.where(x.abs() >= (order + 1) / 2.0, 0.0, g)


def _h(x, order: int):
    """Second-derivative polynomial on |x|, orders 2 and 3 (zero almost
    everywhere below order 2)."""
    if order == 2:
        return torch.where(x < 0.5, -2.0 * torch.ones_like(x),
                           torch.ones_like(x))
    if order == 3:
        return torch.where(x < 1.0, 3.0 * x - 2.0, 2.0 - x)
    raise NotImplementedError(f"spline_hess order {order} (use <=3)")


def spline_hess(x, order: int):
    if order <= 1:
        return torch.zeros_like(x)
    h = _h(x.abs(), order)
    return torch.where(x.abs() >= (order + 1) / 2.0, 0.0, h)
