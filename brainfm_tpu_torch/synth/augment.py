"""Intensity augmentation chain: gamma, bias field, resolution resampling,
noise, and the restore-to-grid step (port of brainfm_tpu/synth/augment.py).

Intermediate shapes are static maximal buffers with effective sizes held
in tensors; the mild/severe/real/synth strengths enter as the `knobs`
dict of tensors.
"""

from __future__ import annotations

import math

import torch

from ..ops.blur import gaussian_blur_3d
from ..ops.separable import apply_axis_matrix, linear_resample_matrix
from ..utils.profiling import count
from .deform import zoom_from_effective
from .draws import Draws, to_tensor


def _max_blur_sigma(cfg) -> float:
    """Static blur-kernel cap from the worst-case slice-thickness sigma:
    1.15 * ln5/pi * max_thickness / min(res_training_data)."""
    res = [float(r) for r in
           (getattr(cfg, "res_training_data", None) or (1.0, 1.0, 1.0))]
    max_thick = float(getattr(cfg, "max_thickness", None) or 6.0)
    sig = 1.15 * math.log(5.0) / math.pi * max_thick / max(min(res), 1e-3)
    return max(4.0, sig)


def gamma_transform(draws: Draws, img, gamma_std, gamma=None):
    """`gamma`: optional injected exponent."""
    if gamma is None:
        gamma = torch.exp(gamma_std * draws.normal("gamma_n"))
    return 300.0 * (img / 300.0) ** gamma


def sample_bias_field(draws: Draws, cfg, setup, knobs, bf_scale=None,
                      std=None, small_noise=None):
    """Low-res log-field -> full-size BFlog. bf_scale/std/small_noise:
    optional injected draws (small_noise is the standard-normal buffer)."""
    dev = draws.device
    if bf_scale is None:
        bf_scale = knobs["bf_scale_min"] + draws.uniform("bf_scale_u") * (
            knobs["bf_scale_max"] - knobs["bf_scale_min"])
    # the static buffer below is sized from cfg.bf_scale_max
    bf_scale = torch.clamp(torch.as_tensor(bf_scale, device=dev),
                           max=cfg.bf_scale_max)
    count("host_syncs")
    size = torch.tensor(cfg.size, dtype=torch.float32, device=dev)
    eff = torch.round(bf_scale * size)
    eff1 = torch.where(setup["photo_mode"] > 0,
                       torch.round(size[1] / setup["spac"]), eff[1])
    eff = torch.stack([eff[0], eff1, eff[2]]).clamp(min=2.0)
    frac1 = (1.0 / 2.5 if (cfg.photo_prob > 0 or cfg.left_hemis_only)
             else cfg.bf_scale_max)
    frac1 = max(cfg.bf_scale_max, frac1)
    buf = (int(math.ceil(cfg.bf_scale_max * cfg.size[0])) + 1,
           int(math.ceil(frac1 * cfg.size[1])) + 1,
           int(math.ceil(cfg.bf_scale_max * cfg.size[2])) + 1)
    if std is None:
        std = knobs["bf_std_min"] + (knobs["bf_std_max"]
                                     - knobs["bf_std_min"]) \
            * draws.uniform("bf_std_u")
    if small_noise is None:
        small_noise = draws.normal("bf_small_n", buf)
    small = std * torch.as_tensor(small_noise, device=dev)
    return zoom_from_effective(small, eff, cfg.size)


def resample_resolution(draws: Draws, img, cfg, setup, rnd=None):
    """Slice-thickness blur + downsample to the acquisition resolution.
    Returns (low-res padded buffer, effective new_size (3,)). `rnd`:
    optional injected blur jitter."""
    dev = img.device
    count("host_syncs", 2)   # the two host tables copied to the card
    res_td = torch.tensor(cfg.res_training_data, dtype=torch.float32,
                          device=dev)
    if rnd is None:
        rnd = 0.85 + 0.3 * draws.uniform("resample_u")
    stds = rnd * math.log(5.0) / math.pi * setup["thickness"] / res_td
    stds = torch.where(setup["thickness"] <= res_td, 0.0, stds)
    blurred = gaussian_blur_3d(img, stds, max_sigma=_max_blur_sigma(cfg))

    size = torch.tensor(cfg.size, dtype=torch.float32, device=dev)
    new_size = torch.floor(size * res_td / setup["resolution"])
    new_size = new_size.clamp(min=1.0)
    factors = new_size / size
    delta = (1.0 - factors) / (2.0 * factors)
    # rows outside the strict (0, n-1] bound are zeroed (the masked
    # default is 0, so the masking composes across axes)
    small = blurred
    for d, out in enumerate(cfg.size):
        v = delta[d] + torch.arange(out, device=dev) / factors[d]
        W = linear_resample_matrix(v, small.shape[d], mask_oob=True)
        small = apply_axis_matrix(small, W, d)
    return small, new_size


def add_noise(draws: Draws, img, noise_std_min, noise_std_max, std=None,
              noise=None):
    """std/noise: optional injected draws."""
    if std is None:
        std = noise_std_min + (noise_std_max - noise_std_min) \
            * draws.uniform("noise_std_u")
    if noise is None:
        noise = draws.normal("noise_n", img.shape)
    noisy = img + std * torch.as_tensor(noise, device=img.device)
    return noisy.clamp(min=0.0)


def restore_resolution(small, new_size, cfg):
    """Back to the training grid: zoom from the effective new_size."""
    return zoom_from_effective(small, new_size, cfg.size)


def augment_chain(draws: Draws, img, cfg, setup, knobs,
                  steps=("gamma", "bias_field", "resample", "noise"),
                  is_ct=False, overrides=None):
    """Run the configured augmentation steps.

    knobs: dict of tensors {gamma_std, bf_scale_min, bf_scale_max,
    bf_std_min, bf_std_max, noise_std_min, noise_std_max}.
    overrides: optional injected draws ({gamma, bf_scale, bf_std,
    bf_small_noise, resample_rnd, noise_std, noise_field}).
    Returns (restored_img, aux dict with 'BFlog', 'high_res', 'factors')."""
    ov = {k: to_tensor(v, torch.float32, img.device)
          for k, v in (overrides or {}).items()}
    aux = {}
    x = img
    count("host_syncs", 2)   # cfg.size copied to the card, twice
    new_size = torch.tensor(cfg.size, dtype=torch.float32, device=img.device)
    for step in steps:
        if step == "gamma":
            x = gamma_transform(draws, x, knobs["gamma_std"],
                                gamma=ov.get("gamma"))
        elif step == "bias_field":
            if is_ct:
                aux["high_res"] = x
            else:
                bflog = sample_bias_field(
                    draws, cfg, setup, knobs, bf_scale=ov.get("bf_scale"),
                    std=ov.get("bf_std"),
                    small_noise=ov.get("bf_small_noise"))
                x = x * torch.exp(bflog)
                aux["BFlog"] = bflog
                aux["high_res"] = x
        elif step == "resample":
            x, new_size = resample_resolution(draws, x, cfg, setup,
                                              rnd=ov.get("resample_rnd"))
        elif step == "noise":
            x = add_noise(draws, x, knobs["noise_std_min"],
                          knobs["noise_std_max"], std=ov.get("noise_std"),
                          noise=ov.get("noise_field"))
        else:
            raise ValueError(step)
    restored = restore_resolution(x, new_size, cfg)
    aux["factors"] = new_size / torch.tensor(cfg.size, dtype=torch.float32,
                                             device=img.device)
    return restored, aux
