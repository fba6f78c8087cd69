"""GMM contrast tables from generation label maps (port of
brainfm_tpu/synth/gmm.py: `build_contrast_lut` and `sample_contrast_lut`)."""

from __future__ import annotations

import torch

from .constants import CT_BRIGHTNESS_GROUP
from .draws import Draws


def build_contrast_lut(mus, sigmas, ct_levels=None, is_ct=False,
                       zero_bg=False, photo_mode=None):
    """Deterministic 256-entry (mus, sigmas) tables from drawn base values:
    CT brightness groups, background zeroing and partial-volume ramps.

    ct_levels: (darker, dark, bright, brighter) scalars or None; is_ct and
    zero_bg may be boolean tensors."""
    mus, sigmas = mus.clone(), sigmas.clone()
    dev = mus.device
    if ct_levels is not None:
        ct_mus = mus.clone()
        for group, val in zip(("darker", "dark", "bright", "brighter"),
                              ct_levels):
            idx = CT_BRIGHTNESS_GROUP[group]
            if idx:
                ct_mus[idx] = val
        mus = torch.where(torch.as_tensor(is_ct, device=dev), ct_mus, mus)

    # zero background always in photo mode, else with probability 0.5
    if photo_mode is None:
        photo_mode = torch.zeros((), device=dev)
    bg0 = (photo_mode > 0) | torch.as_tensor(zero_bg, device=dev)
    mus[0] = torch.where(bg0, 0.0, mus[0])

    # partial-volume ramps: 1=lesion, 2=WM, 3=GM, 4=CSF
    v = 0.02 * torch.arange(50, dtype=torch.float32, device=dev)
    mus[100:150] = mus[1] * (1 - v) + mus[2] * v
    mus[150:200] = mus[2] * (1 - v) + mus[3] * v
    mus[200:250] = mus[3] * (1 - v) + mus[4] * v
    mus[250] = mus[4]
    sigmas[100:150] = torch.sqrt(sigmas[1] ** 2 * (1 - v) + sigmas[2] ** 2 * v)
    sigmas[150:200] = torch.sqrt(sigmas[2] ** 2 * (1 - v) + sigmas[3] ** 2 * v)
    sigmas[200:250] = torch.sqrt(sigmas[3] ** 2 * (1 - v) + sigmas[4] ** 2 * v)
    sigmas[250] = sigmas[4]
    return mus, sigmas


def sample_contrast_lut(draws: Draws, ct_prob: float = 0.0, photo_mode=None):
    """Random per-label means/stds. Returns (mus[256], sigmas[256])."""
    mus = 25.0 + 200.0 * draws.uniform("mus_u", (256,))
    sigmas = 5.0 + 20.0 * draws.uniform("sigmas_u", (256,))

    ct_levels = None
    is_ct = False
    if ct_prob > 0:
        is_ct = draws.uniform("ct_u") < ct_prob
        levels = draws.uniform("ct_levels_u", (4,))
        ct_levels = (25.0 + 10.0 * levels[0], 90.0 + 20.0 * levels[1],
                     110.0 + 20.0 * levels[2], 150.0 + 50.0 * levels[3])

    zero_bg = draws.uniform("zero_bg_u") < 0.5
    return build_contrast_lut(mus, sigmas, ct_levels, is_ct, zero_bg,
                              photo_mode)
