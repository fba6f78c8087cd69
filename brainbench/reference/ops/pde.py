"""Advection right-hand side for the pathology shapes (port of
brainfm_tpu/ops/pde.py): upwind differences switched on the local
velocity's sign, with the Neumann boundary re-imposed on the state before
each evaluation."""

from __future__ import annotations

from .fd import axis_derivative


def apply_neumann_bc(c):
    """Replace the one-voxel boundary shell of the last three axes with its
    inner neighbour: out[i, j, k] = c[clip(i, 1, n-2), ...], the edge
    padding of the interior."""
    out = c.clone()
    for axis in range(c.dim() - 3, c.dim()):
        n = c.shape[axis]
        out.narrow(axis, 0, 1).copy_(out.narrow(axis, 1, 1))
        out.narrow(axis, n - 1, 1).copy_(out.narrow(axis, n - 2, 1))
    return out


def upwind_gradient(c, v, axis: int):
    """Upwind derivative of c along spatial axis `axis`: backward where
    v > 0, forward where v <= 0."""
    df = axis_derivative(c, axis, "f")
    db = axis_derivative(c, axis, "b")
    flag = (v > 0).to(c.dtype)
    return df * (1.0 - flag) + db * flag


def advect_rhs(c, vx, vy, vz, bc: str = "neumann"):
    """dC/dt = -(V . grad_upwind C) for a divergence-free V."""
    if bc in ("neumann", "cauchy", "dirichlet_neumann", "source_neumann"):
        c = apply_neumann_bc(c)
    cx = upwind_gradient(c, vx, 0)
    cy = upwind_gradient(c, vy, 1)
    cz = upwind_gradient(c, vz, 2)
    return -(vx * cx + vy * cy + vz * cz)
