"""Generator configuration and per-item stochastic setup (port of
brainfm_tpu/synth/params.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..utils.profiling import count
from .draws import Draws


@dataclass(frozen=True)
class SynthStatic:
    """Static generator parameters (cfgs/generator/default.yaml)."""

    size: Tuple[int, int, int] = (128, 128, 128)
    max_rotation: float = 15.0
    max_shear: float = 0.2
    max_scaling: float = 0.2
    nonlin_scale_min: float = 0.03
    nonlin_scale_max: float = 0.06
    nonlin_std_max: float = 4.0
    bf_scale_min: float = 0.02
    bf_scale_max: float = 0.04
    bf_std_min: float = 0.1
    bf_std_max: float = 0.6
    gamma_std: float = 0.1
    noise_std_min: float = 5.0
    noise_std_max: float = 15.0
    photo_prob: float = 0.2
    pathology_prob: float = 0.0
    random_shape_prob: float = 0.0
    augment_pathology: bool = False
    flip_prob: float = 0.5
    ct_prob: float = 0.0
    mix_synth_prob: float = 0.0
    low_res_only: bool = False
    left_hemis_only: bool = False
    random_shift: bool = False
    deform_one_hots: bool = False
    nonlinear_transform: bool = True
    bspline_zooming: bool = False
    n_steps_svf_integration: int = 8
    max_surf_distance: float = 3.0
    perlin_res: Tuple[int, int, int] = (2, 2, 2)
    mask_percentile_min: float = 85.0
    mask_percentile_max: float = 99.9
    v_multiplier: float = 500.0
    dt: float = 0.1
    max_nt: int = 10
    pathol_thres: float = 0.5
    pathol_tol: float = 1e-7
    integ_method: str = "dopri5"
    bc: str = "neumann"
    all_samples: int = 4
    mild_samples: int = 2
    # bf16 warp modes of the TPU kernel; the CUDA warp always accumulates
    # in fp32, so both are read and have no effect in the port
    approx_warp: bool = True
    approx_warp_targets: bool = True
    res_training_data: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    aug_steps_synth: Tuple[str, ...] = ("gamma", "bias_field", "resample",
                                        "noise")
    aug_steps_real: Tuple[str, ...] = ("gamma", "bias_field", "resample",
                                       "noise")

    @classmethod
    def from_cfg(cls, cfg):
        """Build from an AttrDict config tree (generator + shape-gen blocks)."""
        g = cfg.generator
        sg = cfg.pathology_shape_generator or {}

        def gv(d, k, default):
            v = d.get(k) if d else None
            return default if v is None else v
        return cls(
            size=tuple(g.size),
            max_rotation=float(gv(g, "max_rotation", 15.0)),
            max_shear=float(gv(g, "max_shear", 0.2)),
            max_scaling=float(gv(g, "max_scaling", 0.2)),
            nonlin_scale_min=float(gv(g, "nonlin_scale_min", 0.03)),
            nonlin_scale_max=float(gv(g, "nonlin_scale_max", 0.06)),
            nonlin_std_max=float(gv(g, "nonlin_std_max", 4.0)),
            bf_scale_min=float(gv(g, "bf_scale_min", 0.02)),
            bf_scale_max=float(gv(g, "bf_scale_max", 0.04)),
            bf_std_min=float(gv(g, "bf_std_min", 0.1)),
            bf_std_max=float(gv(g, "bf_std_max", 0.6)),
            gamma_std=float(gv(g, "gamma_std", 0.1)),
            noise_std_min=float(gv(g, "noise_std_min", 5.0)),
            noise_std_max=float(gv(g, "noise_std_max", 15.0)),
            photo_prob=float(gv(g, "photo_prob", 0.2)),
            pathology_prob=float(gv(g, "pathology_prob", 0.0)),
            random_shape_prob=float(gv(g, "random_shape_prob", 0.0)),
            augment_pathology=bool(gv(g, "augment_pathology", False)),
            flip_prob=float(gv(g, "flip_prob", 0.5)),
            ct_prob=float(gv(g, "ct_prob", 0.0)),
            mix_synth_prob=float(gv(cfg, "mix_synth_prob", 0.0)),
            low_res_only=bool(gv(g, "low_res_only", False)),
            left_hemis_only=bool(gv(g, "left_hemis_only", False)),
            random_shift=bool(gv(g, "random_shift", False)),
            deform_one_hots=bool(gv(g, "deform_one_hots", False)),
            nonlinear_transform=bool(gv(g, "nonlinear_transform", True)),
            bspline_zooming=bool(gv(g, "bspline_zooming", False)),
            n_steps_svf_integration=int(gv(g, "n_steps_svf_integration", 8)),
            max_surf_distance=float(gv(cfg, "max_surf_distance", 3.0)),
            perlin_res=tuple(gv(sg, "perlin_res", (2, 2, 2))),
            mask_percentile_min=float(gv(sg, "mask_percentile_min", 85.0)),
            mask_percentile_max=float(gv(sg, "mask_percentile_max", 99.9)),
            v_multiplier=float(gv(sg, "V_multiplier", 500.0)),
            dt=float(gv(sg, "dt", 0.1)),
            max_nt=int(gv(sg, "max_nt", 10)),
            pathol_thres=float(gv(sg, "pathol_thres", 0.5)),
            pathol_tol=float(gv(sg, "pathol_tol", 1e-7)),
            integ_method=str(gv(sg, "integ_method", "dopri5")),
            bc=str(gv(sg, "bc", "neumann")),
            all_samples=int(gv(g, "all_samples", 1)),
            mild_samples=int(gv(g, "mild_samples", 0)),
            approx_warp=bool(gv(g, "approx_warp", True)),
            approx_warp_targets=bool(gv(g, "approx_warp_targets", True)),
            aug_steps_synth=tuple(_aug_steps(cfg, "synth")),
            aug_steps_real=tuple(_aug_steps(cfg, "real")),
        )


def _aug_steps(cfg, mode: str):
    """augmentation_steps is either one flat list (both modes) or a
    {'synth': [...], 'real': [...]} dict."""
    default = ("gamma", "bias_field", "resample", "noise")
    steps = cfg.get("augmentation_steps") if hasattr(cfg, "get") else None
    if steps is None:
        return default
    if isinstance(steps, (list, tuple)):
        return steps
    return steps.get(mode, default)


def _f32(values, device):
    """A host table on `device`: one host sync."""
    count("host_syncs")
    return torch.tensor(values, dtype=torch.float32, device=device)


def resolution_sampler(draws: Draws, low_res_only: bool = False):
    """4-branch acquisition model. Returns (resolution[3], thickness[3])."""
    dev = draws.device
    r = draws.uniform("res_r")
    if low_res_only:
        r = 0.5 + 0.5 * r
    ones = torch.ones(3, device=dev)
    # branch 2: clinical, low-res in one random dimension
    idx = draws.randint("res_idx", 0, 3)
    u = draws.uniform("res_u2", (2,))
    hot = torch.arange(3, device=dev) == idx
    res2 = torch.where(hot, 2.5 + 6.0 * u[0], ones)
    thk2 = torch.where(hot, torch.minimum(2.5 + 6.0 * u[0], 4.0 + 2.0 * u[1]),
                       ones)
    # branch 3: low-field stock (axial); branch 4: low-field isotropic-ish
    u3 = draws.uniform("res_u3", (3,))
    res3 = _f32([1.3, 1.3, 4.8], dev) + 0.4 * u3
    res4 = 2.0 + 3.0 * u3
    # count of thresholds <= r: an exact boundary draw falls in the branch
    # above, like the reference's `elif r < 0.5` bucketing
    branch = (r >= 0.25).long() + (r >= 0.5).long() + (r >= 0.75).long()
    res = torch.where(branch == 0, ones, torch.where(
        branch == 1, res2, torch.where(branch == 2, res3, res4)))
    thk = torch.where(branch == 0, ones, torch.where(
        branch == 1, thk2, torch.where(branch == 2, res3, res4)))
    return res, thk


def sample_setup(draws: Draws, cfg: SynthStatic):
    """Per-item stochastic setup; photo_mode/pathol/flip are 0/1 floats."""
    dev = draws.device
    if cfg.low_res_only:
        photo = torch.zeros((), device=dev)
    elif cfg.left_hemis_only:
        photo = torch.ones((), device=dev)
    else:
        photo = (draws.uniform("photo_u") < cfg.photo_prob).float()
    pathol = (draws.uniform("pathol_u") < cfg.pathology_prob).float()
    pathol_shape = (draws.uniform("shape_u") < cfg.random_shape_prob).float()
    spac = 2.5 + 10.0 * draws.uniform("spac_u")
    if cfg.left_hemis_only:
        flip = torch.zeros((), device=dev)
    else:
        # the reference compares a normal draw with flip_prob
        flip = (draws.normal("flip_n") < cfg.flip_prob).float()

    res_s, thk_s = resolution_sampler(draws, cfg.low_res_only)
    rtd = _f32(cfg.res_training_data, dev)
    res_photo = torch.stack([rtd[0], spac, rtd[2]])
    thk_photo = _f32([cfg.res_training_data[0], 0.1,
                      cfg.res_training_data[2]], dev)
    resolution = torch.where(photo > 0, res_photo, res_s)
    thickness = torch.where(photo > 0, thk_photo, thk_s)
    return {
        "photo_mode": photo, "pathol_mode": pathol,
        "pathol_random_shape": pathol_shape, "spac": spac, "flip": flip,
        "resolution": resolution, "thickness": thickness,
    }
