"""3-D Perlin and fractal gradient noise, thresholded shapes and
divergence-free velocities (port of brainfm_tpu/ops/perlin.py).

The lattice draws (theta and phi, one uniform per lattice point) are named
draws (synth/draws.py): `theta_u` and `phi_u` per noise field, under
`octave[i]` for fractal noise and `potential[i]` for the three potentials
of a velocity.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from ..utils.profiling import count
from .fd import curl_3d

if TYPE_CHECKING:   # synth/ imports this module
    from ..synth.draws import Draws


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin_noise_3d(draws: Draws, shape, res, tileable=(False, False, False)):
    """Gradient noise on `shape` with `res` lattice periods per axis; shape
    must be a multiple of res. float32 on the draws' device."""
    shape = tuple(int(s) for s in shape)
    res = tuple(int(r) for r in res)
    d = tuple(shape[i] // res[i] for i in range(3))
    dev = draws.device

    # local cell coordinates in [0, 1) per voxel
    ax = [(torch.arange(shape[i], device=dev) % d[i]) / d[i]
          for i in range(3)]
    grid = torch.stack(torch.meshgrid(*ax, indexing="ij"), dim=-1).float()

    lattice = (res[0] + 1, res[1] + 1, res[2] + 1)
    theta = 2 * math.pi * draws.uniform("theta_u", lattice)
    phi = 2 * math.pi * draws.uniform("phi_u", lattice)
    gradients = torch.stack((torch.sin(phi) * torch.cos(theta),
                             torch.sin(phi) * torch.sin(theta),
                             torch.cos(phi)), dim=3)
    if tileable[0]:
        gradients[-1, :, :] = gradients[0, :, :]
    if tileable[1]:
        gradients[:, -1, :] = gradients[:, 0, :]
    if tileable[2]:
        gradients[:, :, -1] = gradients[:, :, 0]

    g = gradients.repeat_interleave(d[0], 0).repeat_interleave(
        d[1], 1).repeat_interleave(d[2], 2)
    D, H, W = (g.shape[i] - d[i] for i in range(3))

    def corner(a, b, c):
        return g[a * d[0]:a * d[0] + D, b * d[1]:b * d[1] + H,
                 c * d[2]:c * d[2] + W]

    def ramp(offset, gcorner):
        count("host_syncs")   # the offset copied to the card
        rel = grid - torch.tensor(offset, dtype=grid.dtype, device=dev)
        return torch.sum(rel * gcorner, dim=3)

    n000 = ramp((0, 0, 0), corner(0, 0, 0))
    n100 = ramp((1, 0, 0), corner(1, 0, 0))
    n010 = ramp((0, 1, 0), corner(0, 1, 0))
    n110 = ramp((1, 1, 0), corner(1, 1, 0))
    n001 = ramp((0, 0, 1), corner(0, 0, 1))
    n101 = ramp((1, 0, 1), corner(1, 0, 1))
    n011 = ramp((0, 1, 1), corner(0, 1, 1))
    n111 = ramp((1, 1, 1), corner(1, 1, 1))

    t = _fade(grid)
    n00 = n000 * (1 - t[..., 0]) + t[..., 0] * n100
    n10 = n010 * (1 - t[..., 0]) + t[..., 0] * n110
    n01 = n001 * (1 - t[..., 0]) + t[..., 0] * n101
    n11 = n011 * (1 - t[..., 0]) + t[..., 0] * n111
    n0 = (1 - t[..., 1]) * n00 + t[..., 1] * n10
    n1 = (1 - t[..., 1]) * n01 + t[..., 1] * n11
    return (1 - t[..., 2]) * n0 + t[..., 2] * n1


def fractal_noise_3d(draws: Draws, shape, res, octaves=1, persistence=0.5,
                     lacunarity=2, tileable=(False, False, False)):
    """Octave sum of Perlin noise."""
    noise = torch.zeros(tuple(shape), device=draws.device)
    frequency, amplitude = 1, 1.0
    for i in range(octaves):
        noise = noise + amplitude * perlin_noise_3d(
            draws.sub("octave", i), shape,
            (frequency * res[0], frequency * res[1], frequency * res[2]),
            tileable)
        frequency *= lacunarity
        amplitude *= persistence
    return noise


def percentile_nosort(x, q):
    """jnp.percentile(x, q, method='linear') with the same arithmetic as the
    JAX package's sort-free form: the float32 rank q/100 * (n-1), its floor
    and ceil order statistics, then low*lw + high*hw. The order statistics
    are exact (`torch.kthvalue`), so the result is bitwise jnp.percentile's.
    Assumes no NaNs."""
    xf = x.reshape(-1)
    n = xf.numel()
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    qq = (q / 100.0).float() * (n - 1)
    low = torch.floor(qq)
    high = torch.ceil(qq)
    hw = qq - low
    lw = 1.0 - hw
    count("host_syncs", 2)
    low_i = int(low.clamp(0, n - 1))
    high_i = int(high.clamp(0, n - 1))
    v_low = torch.kthvalue(xf, low_i + 1).values
    v_high = v_low if high_i == low_i else torch.kthvalue(xf,
                                                          high_i + 1).values
    return (v_low * lw + v_high * hw).to(x.dtype)


def shape_3d(draws: Draws, shape, perlin_res, percentile):
    """Percentile-thresholded noise shape: (mask, masked noise)."""
    noise = perlin_noise_3d(draws, shape, perlin_res,
                            tileable=(True, False, False))
    thres = percentile_nosort(noise, percentile)
    mask = (noise >= thres).to(noise.dtype)
    return mask, noise * mask


def velocity_3d(draws: Draws, shape, perlin_res, v_multiplier):
    """Divergence-free velocity, the curl of three noise potentials.
    Returns {Vx, Vy, Vz}."""
    a, b, c = (perlin_noise_3d(draws.sub("potential", i), shape, perlin_res,
                               tileable=(True, False, False))
               for i in range(3))
    vx, vy, vz = curl_3d(a, b, c)
    return {"Vx": vx * v_multiplier, "Vy": vy * v_multiplier,
            "Vz": vz * v_multiplier}
