"""Pathology shape synthesis, advection and image encoding (port of
brainfm_tpu/synth/pathology.py).

Named draws: `percentile_u` and the `shape` noise lattice (random_shape);
`nt` and the `velocity` potentials (augment_pathology); `mus_u`,
`sigmas_u` and `noise` (encode_pathology); `dir_u` (pathology_direction).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ode import odeint_masked_final
from ..ops.pde import advect_rhs
from ..ops.perlin import shape_3d, velocity_3d
from ..utils.profiling import count
from .draws import Draws


def binarize(p, thres):
    """1 where p >= thres * max(p), else 0."""
    t = thres * p.max()
    return (p >= t).to(p.dtype)


def random_shape(draws: Draws, size, cfg):
    """Random Perlin lesion shape. Returns (prob, mask)."""
    percentile = (cfg.mask_percentile_min + draws.uniform("percentile_u")
                  * (cfg.mask_percentile_max - cfg.mask_percentile_min))
    mask, prob = shape_3d(draws.sub("shape"), size, cfg.perlin_res,
                          percentile)
    return prob, mask


def augment_pathology(draws: Draws, pprob, cfg):
    """Advect the lesion probability by a random divergence-free velocity
    for a random number nt in [1, max_nt] of dt steps; nt <= 1 leaves it
    as it is. The counter `ode.nt` takes nt (utils/profiling.py), beside
    the solver's (ops/ode.py)."""
    count("host_syncs")
    nt = int(draws.randint("nt", 1, cfg.max_nt + 1))
    count("ode.nt", nt)
    if nt <= 1:
        return pprob
    v = velocity_3d(draws.sub("velocity"), pprob.shape, cfg.perlin_res,
                    cfg.v_multiplier)

    def f(t, y):
        return advect_rhs(y, v["Vx"], v["Vy"], v["Vz"], bc=cfg.bc)

    npdt = np.float64 if pprob.dtype == torch.float64 else np.float32
    ts = np.arange(cfg.max_nt).astype(npdt) * npdt(cfg.dt)
    return odeint_masked_final(f, pprob, ts, nt, dt=cfg.dt,
                               method=cfg.integ_method)


def encode_pathology(draws: Draws, img, P, Pprob, pathol_direction):
    """Paint the pathology into the image; pathol_direction 1 is bright
    (T2/FLAIR-like), 0 dark (T1-like). P is binary on every path of the
    engine (binarize, then {0, 1} keep masks), so the reference's
    10000-row table lookup reads rows 0 and 1 only: a 2-way select of
    those rows of the (10000,) draws."""
    psum = torch.sum(P).clamp(min=1e-6)
    i_mu = torch.sum(img * P) / psum
    pth_mus = 3 * i_mu / 4 + i_mu / 4 * draws.uniform("mus_u", (10000,))
    pth_mus = torch.where(pathol_direction > 0, pth_mus, -pth_mus)
    pth_sigmas = i_mu / 4 * draws.uniform("sigmas_u", (10000,))
    noise = draws.normal("noise", tuple(P.shape))
    sel = P > 0.5
    mu = torch.where(sel, pth_mus[1], pth_mus[0])
    sig = torch.where(sel, pth_sigmas[1], pth_sigmas[0])
    out = img + Pprob * (mu + sig * noise)
    return out.clamp(min=0.0)


def pathology_direction(draws: Draws, input_mode: str, synth_dir=None):
    """0/1: the synthetic contrast's own direction when given, else by the
    real modality (T1/CT dark, T2/FLAIR bright), else a coin."""
    if synth_dir is not None:
        return synth_dir
    if input_mode in ("T1", "CT"):
        return torch.zeros((), device=draws.device)
    if input_mode in ("T2", "FLAIR"):
        return torch.ones((), device=draws.device)
    return (draws.uniform("dir_u") < 0.5).float()
