"""GMM contrast tables from generation label maps, and the per-voxel
intensity draw (port of brainfm_tpu/synth/gmm.py: `build_contrast_lut`,
`sample_contrast_lut`, `synth_intensities`)."""

from __future__ import annotations

import torch

from ..ops.lut import lut_apply
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


def synth_intensities(draws: Draws, gen_labels, mus, sigmas, hemis_mask=None,
                      noise=None):
    """Per-voxel gaussian intensities from the label tables (parity:
    datasets.py:364-374): the white-matter lesion label 77 merged into 2,
    labels outside `hemis_mask` zeroed, the labels rounded and clipped to
    [0, 255], then one K2 lookup (`lut_gather_f32`) of the (256, 2) table
    [mus, sigmas] and `mus + sigmas * noise`, clamped at 0. `noise`: a
    standard-normal field of gen_labels' shape, drawn from `draws`
    ('noise') when not given."""
    g = torch.where(gen_labels == 77, 2, gen_labels)
    if hemis_mask is not None:
        g = torch.where(hemis_mask == 0, 0, g)
    if g.is_floating_point():
        g = torch.round(g)
    gr = g.to(torch.int32).clamp(0, 255)
    ms = lut_apply(torch.stack([mus, sigmas], dim=1).float().contiguous(),
                   gr.contiguous())
    if noise is None:
        noise = draws.normal("noise", tuple(gr.shape))
    return (ms[..., 0] + ms[..., 1] * noise).clamp(min=0.0)
