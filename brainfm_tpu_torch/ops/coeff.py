"""Interpolating B-spline coefficients: the recursive prefilter (port of
brainfm_tpu/ops/coeff.py).

The Thevenaz & Unser filter with the boundary-specific initial conditions
of dct1, dct2 and dft (zero and replicate take dct1's and dct2's). The
causal and anticausal recursions run as a loop over the filtered axis,
every other axis at once; the initial conditions are the JAX package's
truncated sums.
"""

from __future__ import annotations

import math

import torch

from .bounds import bound_code


def get_poles(order: int):
    if order in (0, 1):
        return []
    if order == 2:
        return [math.sqrt(8.0) - 3.0]
    if order == 3:
        return [math.sqrt(3.0) - 2.0]
    if order == 4:
        return [math.sqrt(664.0 - math.sqrt(438976.0)) + math.sqrt(304.0)
                - 19.0,
                math.sqrt(664.0 + math.sqrt(438976.0)) - math.sqrt(304.0)
                - 19.0]
    if order == 5:
        return [math.sqrt(67.5 - math.sqrt(4436.25)) + math.sqrt(26.25) - 6.5,
                math.sqrt(67.5 + math.sqrt(4436.25)) - math.sqrt(26.25) - 6.5]
    if order == 6:
        return [-0.488294589303044755130118038883789062112279161239377608394,
                -0.081679271076237512597937765737059080653379610398148178525368,
                -0.00141415180832581775108724397655859252786416905534669851652709]
    if order == 7:
        return [-0.5352804307964381655424037816816460718339231523426924148812,
                -0.122554615192326690515272264359357343605486549427295558490763,
                -0.0091486948096082769285930216516478534156925639545994482648003]
    raise NotImplementedError(order)


def get_gain(poles):
    lam = 1.0
    for p in poles:
        lam *= (1.0 - p) * (1.0 - 1.0 / p)
    return lam


def _arange(start, end, x, step=1):
    return torch.arange(start, end, step, dtype=x.dtype, device=x.device)


def _dot0(w, x):
    """sum_k w[k] * x[k] over the leading axis."""
    return torch.tensordot(w, x, dims=([0], [0]))


def _initial(x, pole: float, code: int):
    """Causal initial condition c+[0]; x: (n, ...), filter axis first."""
    n = x.shape[0]
    max_iter = int(math.ceil(-30.0 / math.log(abs(pole))))
    if code in (0, 2):  # zero / dct1 (mirror)
        if max_iter < n:
            pw = pole ** _arange(1, max_iter, x)
            return x[0] + _dot0(pw, x[1:max_iter])
        polen = pole ** (n - 1)
        k = _arange(1, n - 1, x)
        pw = pole ** k + (polen * polen) / (pole ** k)
        out = x[0] + polen * x[-1] + _dot0(pw, x[1:-1])
        return out / (1.0 - pole ** (2 * (n - 1)))
    if code in (1, 3):  # replicate / dct2 (reflect), scipy's convention
        polen = pole ** n
        pole_last = polen * (1.0 + 1.0 / (pole + polen * polen))
        pw = pole ** _arange(1, n - 1, x) + pole ** _arange(2 * n - 2, n, x, -1)
        out = x[0] + pole_last * x[-1] + _dot0(pw, x[1:-1])
        out = out * (pole / (1.0 - polen * polen))
        return out + x[0]
    if code == 6:  # dft (wrap)
        m = min(max_iter, n)
        pw = (pole ** _arange(1, m, x)).flip(0)
        out = x[0] + _dot0(pw, x[1 - m:])
        return out / (1.0 - pole ** m)
    raise NotImplementedError(code)


def _final(cplus, pole: float, code: int):
    """Anticausal initial condition c-[n-1]; cplus: (n, ...), the causal
    output."""
    n = cplus.shape[0]
    if code in (0, 2):  # dct1
        return (pole / (pole * pole - 1.0)) * (pole * cplus[-2] + cplus[-1])
    if code in (1, 3):  # dct2
        return cplus[-1] * (pole / (pole - 1.0))
    if code == 6:  # dft
        max_iter = min(int(math.ceil(-30.0 / math.log(abs(pole)))), n)
        pw = pole ** _arange(2, max_iter + 1, cplus)
        out = pole * cplus[-1] + _dot0(pw, cplus[:max_iter - 1])
        return out / (pole ** max_iter - 1.0)
    raise NotImplementedError(code)


def _filter_axis0(x, poles, code: int):
    n = x.shape[0]
    if n == 1:
        return x
    x = x * get_gain(poles)
    for pole in poles:
        c = [_initial(x, pole, code)]
        for i in range(1, n):
            c.append(x[i] + pole * c[-1])
        cplus = torch.stack(c)
        c = [_final(cplus, pole, code)]
        for i in range(n - 2, -1, -1):
            c.append(pole * (c[-1] - cplus[i]))
        x = torch.stack(c[::-1])
    return x


def spline_coeff(inp, bound, order: int, axis: int = -1):
    """Prefilter along one axis."""
    if order in (0, 1):
        return inp
    x = torch.movedim(inp, axis, 0)
    x = _filter_axis0(x, get_poles(order), bound_code(bound))
    return torch.movedim(x, 0, axis)


def spline_coeff_nd(inp, bound, order, ndim: int | None = None):
    """Prefilter along the last `ndim` axes (bound and order: one value or
    one per axis)."""
    if ndim is None:
        ndim = inp.dim()
    bounds = bound if isinstance(bound, (list, tuple)) else [bound] * ndim
    orders = order if isinstance(order, (list, tuple)) else [order] * ndim
    for d, (b, o) in enumerate(zip(bounds, orders)):
        inp = spline_coeff(inp, b, o, axis=-ndim + d)
    return inp
