"""ODE integration for the pathology advection (port of
brainfm_tpu/ops/ode.py).

Fixed-grid euler, midpoint and rk4 (the 3/8 rule); fixed-step
Adams-Bashforth(-Moulton) 4 with an RK4 start; adaptive Dormand-Prince
('dopri5') and Tsitouras ('tsit5') 5(4) pairs with the same controller as
the JAX package: first-same-as-last stages, the step size and the last
stage carried across output intervals, the RMS error norm over
atol + rtol * max(|y_old|, |y_new|), at most 256 tries per interval.
'adams' (the reference's adaptive Adams) takes the dopri5 controller, as
in the JAX package.

The JAX package keeps time and step size as arrays of the state's dtype
inside a `lax.while_loop`; here the adaptive loop runs on the host, with
time and step size as numpy scalars of the state's dtype (the same IEEE
arithmetic) and one host read of the error ratio per step. The
counters `ode.steps` (adaptive steps, rejected ones included),
`ode.rejected`, `ode.evals` (right-hand-side evaluations) and
`host_syncs` (the reads of the error ratio) are kept by
utils/profiling.py while it records.

`odeint_adjoint` is the differentiable form: the fixed-step methods
recompute each interval in the backward pass
(`torch.utils.checkpoint`, the JAX package's `jax.checkpoint`); the
adaptive methods give values only, since the JAX package cannot
reverse-differentiate its adaptive loop either.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import count


def _f32(x):
    return np.asarray(x, np.float32)


_DOPRI5_C = _f32([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DOPRI5_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DOPRI5_B = _f32([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84, 0.0])
_DOPRI5_BERR = _DOPRI5_B - _f32(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
     187 / 2100, 1 / 40])

# Tsitouras 2011 5(4) pair (first same as last: row 7 equals b)
_TSIT5_C = _f32([0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0])
_TSIT5_A = [
    [],
    [0.161],
    [-0.008480655492356989, 0.335480655492357],
    [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
    [5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525],
    [5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383],
    [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774],
]
_TSIT5_B = _f32([0.09646076681806523, 0.01, 0.4798896504144996,
                 1.379008574103742, -3.290069515436081, 2.324710524099774,
                 0.0])
_TSIT5_BERR = _f32([0.00178001105222577714, 0.0008164344596567469,
                    -0.007880878010261995, 0.1447110071732629,
                    -0.5823571654525552, 0.45808210592918697, -1.0 / 66.0])

_TABLEAUS = {
    "dopri5": (_DOPRI5_C, _DOPRI5_A, _DOPRI5_B, _DOPRI5_BERR),
    "tsit5": (_TSIT5_C, _TSIT5_A, _TSIT5_B, _TSIT5_BERR),
}

# Adams-Bashforth 4 / Adams-Moulton 4 coefficients (newest first)
_AB4 = _f32([55.0, -59.0, 37.0, -9.0]) / _f32(24.0)
_AM4 = _f32([9.0, 19.0, -5.0, 1.0]) / _f32(24.0)

MAX_STEPS = 256


def _counted(func):
    def f(t, y):
        count("ode.evals")
        return func(t, y)
    return f


def _combine(coefs, ks):
    """sum_i coefs[i] * ks[i] (coefs: numpy float32)."""
    out = ks[0] * float(coefs[0])
    for c, k in zip(coefs[1:], ks[1:]):
        out = out + k * float(c)
    return out


def _euler_step(func, t, dt, y):
    return y + func(t, y) * dt


def _midpoint_step(func, t, dt, y):
    y_mid = y + func(t, y) * (dt / 2)
    return y + func(t + dt / 2, y_mid) * dt


def _rk4_step(func, t, dt, y):
    # the "3/8" alternative Runge-Kutta of the reference
    k1 = func(t, y)
    k2 = func(t + dt / 3, y + k1 * dt / 3)
    k3 = func(t + dt * 2 / 3, y + (k2 - k1 / 3) * dt)
    k4 = func(t + dt, y + (k1 - k2 + k3) * dt)
    return y + (k1 + 3 * (k2 + k3) + k4) * dt / 8


_FIXED_STEPS = {"euler": _euler_step, "midpoint": _midpoint_step,
                "rk4": _rk4_step}


def _np_times(t, y0):
    """Output times as numpy scalars of the state's dtype."""
    dt = np.float64 if y0.dtype == torch.float64 else np.float32
    return np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t, dt)


def _is_fsal(tab):
    C, A, B, BERR = tab
    last = A[-1]
    return (len(last) == len(B) - 1
            and np.allclose(np.asarray(last, np.float64), B[:-1]))


def _adaptive_interval(func, tab, y, t0, t1, rtol, atol, h, k1,
                       max_steps=MAX_STEPS):
    """Advance y from t0 to t1 with the embedded pair `tab`, starting from
    step size h and first stage k1. Returns (y, h, k1) for the next
    interval; a rejected step leaves (t, y, k1) as they were."""
    C, A, B, BERR = tab
    n_stage = len(C)
    fsal = _is_fsal(tab)
    one = h.dtype.type
    t, nsteps = t0, 0
    while t < t1 - one(1e-12) and nsteps < max_steps:
        h = np.minimum(h, t1 - t)
        ks = [k1]
        yi = y
        for i in range(1, n_stage):
            yi = y
            for j, a in enumerate(A[i]):
                yi = yi + ks[j] * float(h * one(a))
            ks.append(func(t + h * C[i], yi))
        y_new = yi if fsal else y + _combine(B, ks) * float(h)
        err = _combine(BERR, ks) * float(h)
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        ratio = one(float(torch.sqrt(torch.mean((err / scale) ** 2))))
        count("host_syncs")
        accept = ratio <= 1.0
        factor = np.clip(one(0.9) * (np.maximum(ratio, one(1e-10))
                                     ** one(-0.2)), one(0.2), one(10.0))
        h_next = h * factor
        if accept:
            k1 = ks[-1] if fsal else func(t + h, y_new)
            t = t + h
            y = y_new
        else:
            count("ode.rejected")
        h = h_next
        nsteps += 1
    count("ode.steps", nsteps)
    return y, h, k1


def _adams_integrate(func, y0, t, corrector: bool):
    """Fixed-step Adams-Bashforth(-Moulton) order 4 with an RK4 start."""
    n = t.shape[0]
    if n < 5:
        return _fixed_grid_integrate(func, y0, t, "rk4")
    ys = [y0]
    fs = [func(t[0], y0)]
    for i in range(3):
        y_next = _rk4_step(func, t[i], float(t[i + 1] - t[i]), ys[-1])
        ys.append(y_next)
        fs.append(func(t[i + 1], y_next))
    hist = [fs[3], fs[2], fs[1], fs[0]]   # newest first
    y = ys[3]
    for i in range(3, n - 1):
        dt = float(t[i + 1] - t[i])
        y_pred = y + _combine(_AB4, hist) * dt
        if corrector:
            f_new = func(t[i + 1], y_pred)
            y_new = y + _combine(_AM4, [f_new] + hist[:3]) * dt
        else:
            y_new = y_pred
        f_new = func(t[i + 1], y_new)
        hist = [f_new] + hist[:3]
        y = y_new
        ys.append(y)
    return torch.stack(ys)


def _fixed_grid_integrate(func, y0, t, method):
    step = _FIXED_STEPS[method]
    ys = [y0]
    for i in range(t.shape[0] - 1):
        ys.append(step(func, t[i], float(t[i + 1] - t[i]), ys[-1]))
    return torch.stack(ys)


def _dt0(dt, t):
    return t.dtype.type(dt if dt is not None else (t[1] - t[0]))


def odeint(func, y0, t, dt=None, rtol=1e-7, atol=1e-9, method=None):
    """Integrate dy/dt = func(t, y) through the output times `t` (T,).
    Returns (T, *y0.shape)."""
    method = method or "dopri5"
    t = _np_times(t, y0)
    func = _counted(func)
    if method in _FIXED_STEPS:
        return _fixed_grid_integrate(func, y0, t, method)
    if method == "adams":
        method = "dopri5"
    elif method in ("explicit_adams", "fixed_adams"):
        return _adams_integrate(func, y0, t,
                                corrector=(method != "explicit_adams"))
    if method not in _TABLEAUS:
        raise ValueError(f"unsupported method {method}")
    return _adaptive_integrate(func, y0, t, dt, rtol, atol, method)


def _adaptive_integrate(func, y0, t, dt, rtol, atol, method, k1=None):
    """The adaptive pair `method` through the output times t, with the
    step size and the first stage carried across the intervals."""
    tab = _TABLEAUS[method]
    h = _dt0(dt, t)
    k1 = func(t[0], y0) if k1 is None else k1
    ys, y = [y0], y0
    for i in range(t.shape[0] - 1):
        y, h, k1 = _adaptive_interval(func, tab, y, t[i], t[i + 1], rtol,
                                      atol, h, k1)
        ys.append(y)
    return torch.stack(ys)


def odeint_adjoint(func, y0, t, dt=None, rtol=1e-7, atol=1e-9, method=None):
    """odeint for reverse-mode differentiation (API parity:
    ShapeID/DiffEqs/adjoint.py `odeint_adjoint`). Returns (T, *y0.shape).

    euler, midpoint and rk4 give odeint's values, each interval under
    `torch.utils.checkpoint` (use_reentrant=False), so the backward pass
    recomputes an interval's stages instead of keeping them. 'adams',
    'explicit_adams' and 'fixed_adams' run the fixed-step Adams family
    (with the corrector but for 'explicit_adams'), as the JAX package's
    odeint_adjoint does; odeint takes the dopri5 controller for 'adams'.
    dopri5 and tsit5 give odeint's values and carry (h, k1) across the
    intervals; they take no gradient (their loop is driven by host reads of
    the error ratio), and raise when y0 or the right-hand side requires
    one."""
    method = method or "dopri5"
    t = _np_times(t, y0)
    func = _counted(func)
    if method in _FIXED_STEPS:
        step = _FIXED_STEPS[method]
        ys = [y0]
        for i in range(t.shape[0] - 1):
            ys.append(checkpoint(step, func, t[i], float(t[i + 1] - t[i]),
                                 ys[-1], use_reentrant=False))
        return torch.stack(ys)
    if method in ("explicit_adams", "fixed_adams", "adams"):
        return _adams_integrate(func, y0, t,
                                corrector=(method != "explicit_adams"))
    if method not in _TABLEAUS:
        raise ValueError(f"unsupported method {method}")
    k1 = func(t[0], y0)
    if torch.is_grad_enabled() and (y0.requires_grad or k1.requires_grad):
        raise RuntimeError(
            f"odeint_adjoint: the adaptive method {method!r} cannot be "
            "differentiated (its step controller reads the error on the "
            "host); use a fixed-step method (euler, midpoint, rk4) on a "
            "finer grid, or call it under torch.no_grad()")
    return _adaptive_integrate(func, y0, t, dt, rtol, atol, method, k1=k1)


def odeint_masked_final(func, y0, t, nt: int, dt=None, method="rk4",
                        rtol=1e-7, atol=1e-9):
    """y at t[nt-1]: the first nt-1 intervals of the grid `t` (the JAX
    package masks the rest of a static-length scan; here the loop stops).
    The Adams family takes the adaptive dopri5 controller, as in the JAX
    package."""
    t = _np_times(t, y0)
    func = _counted(func)
    nt = int(nt)
    if method in ("adams", "explicit_adams", "fixed_adams"):
        method = "dopri5"
    if method in _TABLEAUS:
        tab = _TABLEAUS[method]
        h, k1 = _dt0(dt, t), func(t[0], y0)
        y = y0
        for i in range(min(nt - 1, t.shape[0] - 1)):
            y, h, k1 = _adaptive_interval(func, tab, y, t[i], t[i + 1],
                                          rtol, atol, h, k1)
        return y
    if method not in _FIXED_STEPS:
        raise ValueError(f"unsupported method {method}")
    step = _FIXED_STEPS[method]
    y = y0
    for i in range(min(nt - 1, t.shape[0] - 1)):
        y = step(func, t[i], float(t[i + 1] - t[i]), y)
    return y
