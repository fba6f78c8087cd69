"""Random spatial deformation: affine + nonlinear SVF (port of
brainfm_tpu/synth/deform.py).

The low-res field lives in a buffer of static maximal shape with an
effective size held in a tensor, and the grid addresses the whole subject
volume, as in the JAX package. `integrate_svf` composes the field with
itself through K1 (ops/warp.py::warp_volume) on the card and through its
plain version, ops/interp.py::trilinear3d, on the CPU.
"""

from __future__ import annotations

import math

import torch

from ..ops.separable import apply_axis_matrix, linear_resample_matrix
from ..ops.warp import warp_volume
from ..utils.profiling import count
from .draws import Draws


def make_affine_matrix(rot, sh, s):
    """Rotation (3,), shear (3,) and scaling (3,) -> (3, 3)."""
    one, zero = torch.ones_like(rot[0]), torch.zeros_like(rot[0])
    cx, sx = torch.cos(rot[0]), torch.sin(rot[0])
    cy, sy = torch.cos(rot[1]), torch.sin(rot[1])
    cz, sz = torch.cos(rot[2]), torch.sin(rot[2])

    def m(rows):
        return torch.stack([torch.stack(r) for r in rows])
    Rx = m([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = m([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = m([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    SHx = m([[one, zero, zero], [sh[1], one, zero], [sh[2], zero, one]])
    SHy = m([[one, sh[0], zero], [zero, one, zero], [zero, sh[2], one]])
    SHz = m([[one, zero, sh[0]], [zero, one, sh[1]], [zero, zero, one]])
    A = SHx @ SHy @ SHz @ Rx @ Ry @ Rz
    return A * s[:, None]


def random_affine(draws: Draws, cfg, shp):
    """Random rotation/shear/scale and centre. shp: (3,) float tensor, the
    subject's true voxel extent. Returns (scaling_factor_distances, A, c2)."""
    rot = ((2 * cfg.max_rotation * draws.uniform("rot_u", (3,))
            - cfg.max_rotation) / 180.0 * math.pi)
    shear = (2 * cfg.max_shear * draws.uniform("shear_u", (3,))
             - cfg.max_shear)
    scal = (1 + 2 * cfg.max_scaling * draws.uniform("scal_u", (3,))
            - cfg.max_scaling)
    sfd = torch.prod(scal) ** (1.0 / 3.0)
    A = make_affine_matrix(rot, shear, scal)
    count("host_syncs")
    size = torch.tensor(cfg.size, dtype=torch.float32, device=shp.device)
    if cfg.random_shift:
        max_shift = ((shp - size) / 2.0).clamp(min=0.0)
        c2 = (shp - 1) / 2.0 + (2 * max_shift * draws.uniform("shift_u", (3,))
                                - max_shift)
    else:
        c2 = (shp - 1) / 2.0
    return sfd, A, c2


def zoom_from_effective(field, eff_sizes, out_sizes):
    """Centre-aligned linear upsample from the first `eff_sizes` voxels of
    a statically shaped buffer, as three per-axis matrix products.

    field: (Dm, Hm, Wm[, C]); eff_sizes: (3,) float tensor; out_sizes:
    static tuple."""
    squeeze = field.dim() == 3
    x = field[..., None] if squeeze else field
    for d, out in enumerate(out_sizes):
        eff = eff_sizes[d]
        factor = out / eff
        delta = (1.0 - factor) / (2.0 * factor)
        v = delta + torch.arange(out, device=field.device) / factor
        v = torch.minimum(v.clamp(min=0.0), eff - 1.0)
        W = linear_resample_matrix(v, field.shape[d], upper=eff - 1.0)
        x = apply_axis_matrix(x, W, d)
    return x[..., 0] if squeeze else x


def small_field_buffer_shape(cfg, photo_possible: bool | None = None):
    """Static low-res buffer shape covering both the nonlinear-scale range
    and photo mode's spac-driven axis-1 size."""
    if photo_possible is None:
        photo_possible = cfg.photo_prob > 0 or cfg.left_hemis_only
    frac = [cfg.nonlin_scale_max] * 3
    if photo_possible:
        frac[1] = max(frac[1], 1.0 / 2.5)
    return tuple(int(math.ceil(f * s)) + 1 for f, s in zip(frac, cfg.size))


def random_nonlinear_field(draws: Draws, cfg, setup,
                           need_inverse: bool = False):
    """Low-res gaussian SVF upsampled to `cfg.size`. Returns (F, None), or
    with need_inverse the integrated field and its inverse (F, Fneg)."""
    dev = draws.device
    nonlin_scale = (cfg.nonlin_scale_min + draws.uniform("scale_u")
                    * (cfg.nonlin_scale_max - cfg.nonlin_scale_min))
    count("host_syncs")
    size = torch.tensor(cfg.size, dtype=torch.float32, device=dev)
    eff = torch.round(nonlin_scale * size)
    photo = setup["photo_mode"]
    eff1 = torch.where(photo > 0, torch.round(size[1] / setup["spac"]),
                       eff[1])
    eff = torch.stack([eff[0], eff1, eff[2]]).clamp(min=2.0)

    buf_shape = small_field_buffer_shape(cfg)
    nonlin_std = cfg.nonlin_std_max * draws.uniform("std_u")
    fsmall = nonlin_std * draws.normal("small_n", (*buf_shape, 3))
    F = zoom_from_effective(fsmall, eff, cfg.size)
    if torch.is_tensor(photo):
        count("host_syncs")
    if photo > 0:
        F[..., 1] = 0.0
    if need_inverse:
        return integrate_svf(F, cfg.n_steps_svf_integration)
    return F, None


def integrate_svf(F, n_steps: int):
    """Scaling and squaring of the stationary velocity field F (D,H,W,3)
    and of its negative: (exp(F), exp(-F)) as displacement fields."""
    size = F.shape[:3]
    xx, yy, zz = torch.meshgrid(
        *[torch.arange(s, dtype=F.dtype, device=F.device) for s in size],
        indexing="ij")

    def compose(f):
        grid = [(xx + f[..., 0]).contiguous(), (yy + f[..., 1]).contiguous(),
                (zz + f[..., 2]).contiguous()]
        return f + warp_volume(f.contiguous(), grid)

    step = 1.0 / (2.0 ** n_steps)
    fsvf = F * step
    fneg = -F * step
    for _ in range(n_steps):
        fsvf = compose(fsvf)
        fneg = compose(fneg)
    return fsvf, fneg


def deform_grid(cfg, shp, A, c2, F=None):
    """Sampling coordinates into the whole resident subject volume.
    Returns (xx2, yy2, zz2), each of shape cfg.size."""
    size = cfg.size
    dev = A.device
    xx, yy, zz = torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=dev) for s in size],
        indexing="ij")
    count("host_syncs")
    c = (torch.tensor(size, dtype=torch.float32, device=dev) - 1) / 2.0
    xc, yc, zc = xx - c[0], yy - c[1], zz - c[2]
    if F is not None:
        xc = xc + F[..., 0]
        yc = yc + F[..., 1]
        zc = zc + F[..., 2]
    xx2 = A[0, 0] * xc + A[0, 1] * yc + A[0, 2] * zc + c2[0]
    yy2 = A[1, 0] * xc + A[1, 1] * yc + A[1, 2] * zc + c2[1]
    zz2 = A[2, 0] * xc + A[2, 1] * yc + A[2, 2] * zc + c2[2]
    xx2 = torch.minimum(xx2.clamp(min=0.0), shp[0] - 1)
    yy2 = torch.minimum(yy2.clamp(min=0.0), shp[1] - 1)
    zz2 = torch.minimum(zz2.clamp(min=0.0), shp[2] - 1)
    return xx2, yy2, zz2
