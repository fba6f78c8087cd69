"""Spline sampling on deformed grids: pull, push, count, gradient and
hessian (port of brainfm_tpu/ops/pushpull.py).

Spline orders 0-7 per dimension, the seven boundary conditions of
ops/bounds.py, optional extrapolation masking. The corners of the
(order+1)^ndim support are a Python loop; each is one gather (pull) or one
`index_add_` (push) over the flattened volume. Autograd through
`grid_pull` gives the gradients in the image and in the grid that the JAX
package gets from `jax.grad`; `grid_push` is its adjoint.

Channels last: `inp` is (*spatial, C) or (*spatial,); `grid` is
(*out_spatial, ndim) in voxel coordinates.
"""

from __future__ import annotations

import itertools

import torch

from .bounds import apply_bound
from .splines import spline_grad, spline_hess, spline_weight

# a coordinate this far outside [0, n-1] still counts as inside when the
# result is masked (extrapolate=False)
_TINY = 5e-2


def _as_list(v, ndim):
    if isinstance(v, (list, tuple)):
        if len(v) != ndim:
            raise ValueError(f"{len(v)} values for {ndim} dimensions")
        return list(v)
    return [v] * ndim


def _node_span(x, order: int):
    """The first interpolation node of each coordinate."""
    if order % 2 == 1:
        return torch.floor(x).long() - (order - 1) // 2
    return torch.floor(x + 0.5).long() - order // 2


def _nodes(x, n, order, bound, derivs=1):
    """For each of the order+1 nodes: (index, weight * sign, and with
    derivs >= 1 the first, with derivs >= 2 the second derivative's
    weight * sign)."""
    b0 = _node_span(x, order)
    fns = (spline_weight, spline_grad, spline_hess)[:derivs + 1]
    out = []
    for k in range(order + 1):
        node = b0 + k
        t = x - node.to(x.dtype)
        idx, sign = apply_bound(node, n, bound)
        out.append((idx, *[f(t, order) * sign for f in fns]))
    return out


def _strides(shape):
    strides, s = [], 1
    for n in reversed(shape):
        strides.insert(0, s)
        s *= n
    return strides, s


def _corners(per_dim, strides):
    """(flat index, per-dimension node entries) of every support corner,
    in the JAX package's order."""
    for corner in itertools.product(*[range(len(p)) for p in per_dim]):
        entries = [per_dim[d][k] for d, k in enumerate(corner)]
        idx = 0
        for d, e in enumerate(entries):
            idx = idx + e[0] * strides[d]
        yield idx, entries


def _product(ws):
    w = None
    for wk in ws:
        w = wk if w is None else w * wk
    return w


def _inbounds_mask(grid, shape, extrapolate):
    if extrapolate:
        return None
    ok = torch.ones(grid.shape[:-1], dtype=torch.bool, device=grid.device)
    for d in range(grid.shape[-1]):
        x = grid[..., d]
        ok &= (x >= -_TINY) & (x <= shape[d] - 1 + _TINY)
    return ok


def _prep(inp, grid):
    ndim = grid.shape[-1]
    squeeze = inp.dim() == ndim
    if squeeze:
        inp = inp[..., None]
    spatial = tuple(inp.shape[:-1])
    if len(spatial) != ndim:
        raise ValueError(f"input spatial rank {len(spatial)} != grid "
                         f"dimension {ndim}")
    return inp, spatial, ndim, squeeze


def _per_dim(grid, shape, interpolation, bound, derivs):
    ndim = grid.shape[-1]
    orders = _as_list(interpolation, ndim)
    bounds = _as_list(bound, ndim)
    return [_nodes(grid[..., d], shape[d], orders[d], bounds[d], derivs)
            for d in range(ndim)]


def grid_pull(inp, grid, interpolation=1, bound="zero", extrapolate=True):
    """Sample `inp` at `grid`. inp: (*spatial, C) or (*spatial,); grid:
    (*out, ndim) voxel coordinates. Returns (*out, C) or (*out,)."""
    inp, spatial, ndim, squeeze = _prep(inp, grid)
    C = inp.shape[-1]
    flat = inp.reshape(-1, C)
    per_dim = _per_dim(grid, spatial, interpolation, bound, derivs=0)
    out = torch.zeros(grid.shape[:-1] + (C,), dtype=inp.dtype,
                      device=inp.device)
    for idx, entries in _corners(per_dim, _strides(spatial)[0]):
        w = _product([e[1] for e in entries])
        out = out + flat[idx] * w[..., None]
    ok = _inbounds_mask(grid, spatial, extrapolate)
    if ok is not None:
        out = torch.where(ok[..., None], out, 0.0)
    return out[..., 0] if squeeze else out


def grid_push(inp, grid, shape=None, interpolation=1, bound="zero",
              extrapolate=True):
    """Splat `inp` at `grid` into a volume of `shape` (default: the grid's
    spatial shape): the adjoint of grid_pull."""
    ndim = grid.shape[-1]
    squeeze = tuple(inp.shape) == tuple(grid.shape[:-1])
    if squeeze:
        inp = inp[..., None]
    if tuple(inp.shape[:-1]) != tuple(grid.shape[:-1]):
        raise ValueError("push input must match the grid's spatial shape")
    shape = tuple(inp.shape[:-1]) if shape is None else tuple(shape)
    C = inp.shape[-1]
    ok = _inbounds_mask(grid, shape, extrapolate)
    if ok is not None:
        inp = torch.where(ok[..., None], inp, 0.0)
    per_dim = _per_dim(grid, shape, interpolation, bound, derivs=0)
    strides, total = _strides(shape)
    flat_inp = inp.reshape(-1, C)
    out = torch.zeros((total, C), dtype=inp.dtype, device=inp.device)
    for idx, entries in _corners(per_dim, strides):
        w = _product([e[1] for e in entries])
        out = out.index_add(0, idx.reshape(-1),
                            (flat_inp * w.reshape(-1, 1)).to(inp.dtype))
    out = out.reshape(shape + (C,))
    return out[..., 0] if squeeze else out


def grid_count(grid, shape, interpolation=1, bound="zero", extrapolate=True):
    """grid_push of ones (fp32)."""
    ones = torch.ones(grid.shape[:-1], dtype=torch.float32,
                      device=grid.device)
    return grid_push(ones, grid, shape, interpolation, bound, extrapolate)


def grid_grad(inp, grid, interpolation=1, bound="zero", extrapolate=True):
    """Spatial gradient of the spline at `grid`: (*out, C, ndim), or
    (*out, ndim) for a channel-less input."""
    inp, spatial, ndim, squeeze = _prep(inp, grid)
    C = inp.shape[-1]
    flat = inp.reshape(-1, C)
    per_dim = _per_dim(grid, spatial, interpolation, bound, derivs=1)
    acc = [torch.zeros(grid.shape[:-1] + (C,), dtype=inp.dtype,
                       device=inp.device) for _ in range(ndim)]
    for idx, entries in _corners(per_dim, _strides(spatial)[0]):
        vals = flat[idx]
        for gdim in range(ndim):
            w = _product([e[2] if d == gdim else e[1]
                          for d, e in enumerate(entries)])
            acc[gdim] = acc[gdim] + vals * w[..., None]
    out = torch.stack(acc, dim=-1)
    ok = _inbounds_mask(grid, spatial, extrapolate)
    if ok is not None:
        out = torch.where(ok[..., None, None], out, 0.0)
    return out[..., 0, :] if squeeze else out


def grid_hess(inp, grid, interpolation=1, bound="zero", extrapolate=True):
    """Hessian of the interpolant in the sampling coordinates:
    (*out, C, ndim, ndim), or (*out, ndim, ndim) for a channel-less input.
    Off-diagonal terms are products of first derivatives; the diagonal
    takes the second-derivative weights (zero almost everywhere below
    order 2)."""
    inp, spatial, ndim, squeeze = _prep(inp, grid)
    C = inp.shape[-1]
    flat = inp.reshape(-1, C)
    per_dim = _per_dim(grid, spatial, interpolation, bound, derivs=2)
    zero = torch.zeros(grid.shape[:-1] + (C,), dtype=inp.dtype,
                       device=inp.device)
    acc = [[zero] * ndim for _ in range(ndim)]
    for idx, entries in _corners(per_dim, _strides(spatial)[0]):
        vals = flat[idx]
        for i in range(ndim):
            for j in range(i, ndim):
                w = _product([e[3] if d == i == j else
                              e[2] if d in (i, j) else e[1]
                              for d, e in enumerate(entries)])
                acc[i][j] = acc[i][j] + vals * w[..., None]
                if j != i:
                    acc[j][i] = acc[j][i] + vals * w[..., None]
    out = torch.stack([torch.stack(row, dim=-1) for row in acc], dim=-2)
    ok = _inbounds_mask(grid, spatial, extrapolate)
    if ok is not None:
        out = torch.where(ok[..., None, None, None], out, 0.0)
    return out[..., 0, :, :] if squeeze else out


def identity_grid(shape, dtype=torch.float32, device=None):
    """The identity transformation field (*shape, ndim)."""
    mesh = torch.meshgrid(*[torch.arange(s, dtype=dtype, device=device)
                            for s in shape], indexing="ij")
    return torch.stack(mesh, dim=-1)


def add_identity_grid(disp):
    """A displacement field (*shape, ndim) as a transformation field."""
    dim = disp.shape[-1]
    return disp + identity_grid(disp.shape[-dim - 1:-1], disp.dtype,
                                disp.device)


def affine_grid(mat, shape):
    """The dense transformation grid (*batch, *shape, D) of an affine
    matrix (*batch, D or D+1, D+1)."""
    mat = torch.as_tensor(mat)
    shape = tuple(shape)
    nb_dim = mat.shape[-1] - 1
    if nb_dim != len(shape):
        raise ValueError("affine matrix dimension does not match shape")
    if mat.shape[-2] not in (nb_dim, nb_dim + 1):
        raise ValueError("affine matrix must be (..., D|D+1, D+1)")
    batch = tuple(mat.shape[:-2])
    grid = identity_grid(shape, mat.dtype, mat.device)
    lin = mat[..., :nb_dim, :nb_dim]
    off = mat[..., :nb_dim, -1]
    return torch.einsum(
        "...ij,...j->...i",
        lin.reshape(*batch, *(1,) * nb_dim, nb_dim, nb_dim),
        grid) + off.reshape(*batch, *(1,) * nb_dim, nb_dim)
