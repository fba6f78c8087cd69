"""The synthesis engine: one training item per call (port of
brainfm_tpu/synth/engine.py).

`synth_item(generator, subject, cfg, tasks, input_mode, knobs_stack)`
produces the (target, samples) pair for one subject with `all_samples`
intra-subject augmentations, on the subject's device. Subject volumes live
in the subject frame (padded to the bank shape, true extent in
subject['shape']); targets and samples are made at cfg.size, channels-last,
samples stacked on a leading S axis.

Ported: synth and real input modes without pathology, the label path with
deform_one_hots off. The pathology and surface tasks and the one-hot warp
are not ported yet and raise.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lut import lut_apply
from ..ops.warp import warp_labels, warp_volume
from .augment import augment_chain
from .constants import (LABELS_EXTRACEREBRAL, LABELS_LEFT, build_lut,
                        build_vflip)
from .deform import deform_grid, random_affine, random_nonlinear_field
from .draws import Draws
from .gmm import sample_contrast_lut
from .params import SynthStatic, sample_setup


def _flip0(x, flip):
    """Sagittal flip (axis 0) when the flip draw is on."""
    return torch.flip(x, (0,)) if flip > 0 else x


def _one_hot(lab, n: int):
    """float32 one-hot; a label outside [0, n) gives a zero row, as
    jax.nn.one_hot does (F.one_hot would raise)."""
    return (lab[..., None] == torch.arange(n, device=lab.device)).float()


@lru_cache(maxsize=None)
def _label_tables(left: bool):
    """(labels, lut, vflip) numpy tables for a hemisphere mode."""
    labels = LABELS_LEFT if left else LABELS_EXTRACEREBRAL
    return labels, build_lut(labels), build_vflip(len(labels))


def _hemis_mask_src(subject, cfg, lut):
    """Source-space left-hemisphere mask: compact segmentation > 0 and MNI
    x-coordinate < 0; None unless cfg.left_hemis_only."""
    if not cfg.left_hemis_only:
        return None
    if "seg" not in subject or "reg" not in subject:
        raise ValueError(
            "left_hemis_only requires every subject to carry 'seg' and "
            f"'reg' volumes; got keys {sorted(subject)}")
    s = lut_apply(lut, subject["seg"].int().clamp(0, lut.shape[0] - 1))
    return ((s > 0) & (subject["reg"][..., 0] < 0)).int()


def _target_segmentation(seg, grid, flip, lut, vflip, hemis_mask=None,
                         deform_one_hots=False):
    """One-hot segmentation target. The LUT commutes with the nearest warp,
    so the raw labels are compacted first (K2), the compact index volume is
    warped (K1 nearest), and the sagittal flip is applied in label space
    (K2 on vflip) before the one-hot."""
    if deform_one_hots:
        raise NotImplementedError("deform_one_hots is not ported yet")
    s = seg.int()
    if hemis_mask is not None:
        s = torch.where(hemis_mask == 0, 0, s)
    sc = lut_apply(lut, s.clamp(0, lut.shape[0] - 1))
    scd = warp_labels(sc, grid)
    # flip(onehot(l))[..., vflip] == onehot(vflip[flip(l)]): vflip is the
    # half-swap involution
    lab = lut_apply(vflip, torch.flip(scd, (0,))) if flip > 0 else scd
    return _one_hot(lab, int(vflip.shape[0]))


def make_targets(subject, grid, setup, sfd, cfg, tasks, extra=None,
                 hemis_mask=None):
    """Deform every requested target. All trilinear targets, plus `extra`
    channels (the synthetic contrasts), are stacked channel-wise into ONE
    fused warp with per-channel out-of-bounds defaults (K1). Returns
    (target dict, warped extra channels or None)."""
    flip = setup["flip"]
    left = cfg.left_hemis_only
    dev = grid[0].device
    _, lut_np, vflip_np = _label_tables(left)
    lut = torch.from_numpy(lut_np).to(dev)
    vflip = torch.from_numpy(vflip_np).to(dev)

    if hemis_mask is None:
        hemis_mask = _hemis_mask_src(subject, cfg, lut)

    def hmask(v):
        return (torch.where(hemis_mask == 0, 0.0, v)
                if hemis_mask is not None else v)

    stack, defaults, spans = [], [], {}
    n_dist = 2 if left else 4
    zero = torch.zeros((), device=dev)

    def push(name, vol, default):
        spans[name] = (len(stack), len(stack) + 1)
        stack.append(vol)
        defaults.append(default)

    # the real contrasts are deformed for the mix with synthetic ones
    # (mix_synth_prob) even when not requested as tasks; synth_item drops
    # them again before returning
    mix_aux = extra is not None and cfg.mix_synth_prob > 0
    for t in ("T1", "T2", "FLAIR"):
        if (t in tasks or mix_aux) and t in subject:
            push(t, hmask(torch.nan_to_num(subject[t])), zero)
            dm = subject.get(f"{t}_DM")
            if dm is not None and t in tasks:
                push(f"{t}_DM", hmask(torch.nan_to_num(dm)), zero)
    if "CT" in tasks and "CT" in subject:
        push("CT", hmask(torch.nan_to_num(subject["CT"]) / 1000.0), zero)
        dm = subject.get("CT_DM")
        if dm is not None:
            push("CT_DM", hmask(torch.nan_to_num(dm)), zero)
    if "distance" in tasks and "dist" in subject:
        first = len(stack)
        for c in range(n_dist):
            v = hmask((torch.nan_to_num(subject["dist"][..., c]) - 128.0)
                      / 20.0)
            stack.append(v)
            defaults.append(v.max())  # taken after masking
        spans["dist"] = (first, len(stack))
    if "registration" in tasks and "reg" in subject:
        first = len(stack)
        for c in range(3):
            stack.append(hmask(torch.nan_to_num(subject["reg"][..., c])
                               / 10000.0))
            defaults.append(zero)
        spans["reg"] = (first, len(stack))

    warped = {}
    extra_warped = None
    n_extra = 0 if extra is None else extra.shape[-1]
    if stack or n_extra:
        parts = ([torch.stack(stack, dim=-1)] if stack else []) + \
            ([extra] if n_extra else [])
        big = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        dvec = torch.cat([torch.stack(defaults) if defaults
                          else torch.zeros(0, device=dev),
                          torch.zeros(n_extra, device=dev)])
        wall = warp_volume(big.contiguous(), grid, default=dvec,
                           approx=cfg.approx_warp and cfg.approx_warp_targets)
        warped = {n: wall[..., a:b] for n, (a, b) in spans.items()}
        if n_extra:
            extra_warped = wall[..., len(stack):]

    target = {}
    for t in ("T1", "T2", "FLAIR"):
        if t in warped:
            idef = warped[t][..., 0]
            idef = idef - idef.min()
            idef = idef / idef.max().clamp(min=1e-12)
            target[t] = _flip0(idef, flip)[..., None]
            if f"{t}_DM" in warped:
                d = warped[f"{t}_DM"][..., 0].clamp(min=0.0)
                d = d / d.max().clamp(min=1e-12)
                target[f"{t}_DM"] = _flip0(d, flip)[..., None]
    if "CT" in warped:
        target["CT"] = _flip0(warped["CT"][..., 0], flip)[..., None]
        if "CT_DM" in warped:
            d = warped["CT_DM"][..., 0].clamp(min=0.0)
            d = d / d.max().clamp(min=1e-12)
            target["CT_DM"] = _flip0(d, flip)[..., None]
    if "segmentation" in tasks and "seg" in subject:
        target["segmentation"] = _target_segmentation(
            subject["seg"], grid, flip, lut, vflip, hemis_mask,
            cfg.deform_one_hots)
    if "dist" in warped:
        chans = [warped["dist"][..., c] for c in range(n_dist)]
        if not left and flip > 0:
            lp, lw, rp, rw = (torch.flip(c, (0,)) for c in chans)
            chans = [rp, rw, lp, lw]
        out = torch.stack(chans, dim=-1)
        target["distance"] = (out / sfd).clamp(-cfg.max_surf_distance,
                                               cfg.max_surf_distance)
    if "reg" in warped:
        rx, ry, rz = (warped["reg"][..., c] for c in range(3))
        if flip > 0:
            rx, ry, rz = (-torch.flip(rx, (0,)), torch.flip(ry, (0,)),
                          torch.flip(rz, (0,)))
        target["registration"] = torch.stack([rx, ry, rz], dim=-1)
    if "age" in tasks and "age" in subject:
        target["age"] = subject["age"]
    return target, extra_warped


def _finish_sample(draws: Draws, idef, cfg, setup, knobs, tasks,
                   input_mode):
    """Augmentation chain + restore + normalize + flip."""
    if input_mode == "CT":
        idef = idef.clamp(0.0, 80.0)
    steps = cfg.aug_steps_synth if input_mode == "synth" \
        else cfg.aug_steps_real
    restored, aux = augment_chain(draws, idef, cfg, setup, knobs,
                                  steps=steps, is_ct=(input_mode == "CT"),
                                  overrides=draws.value("aug"))
    maxi = restored.max().clamp(min=1e-12)
    final = restored / maxi

    flip = setup["flip"]
    sample = {"input": _flip0(final, flip)[..., None]}
    if "super_resolution" in tasks and "high_res" in aux:
        sr = aux["high_res"] / maxi - final
        sample["high_res_residual"] = _flip0(sr, flip)[..., None]
    if "bias_field" in tasks and input_mode != "CT" and "BFlog" in aux:
        sample["bias_field_log"] = _flip0(aux["BFlog"], flip)[..., None]
    return sample


def _synth_volumes(draws: Draws, subject, cfg, setup, hemis_mask=None):
    """All S synthetic contrasts in the subject frame, channel-stacked
    (D,H,W,S): they share the deformation grid, so they join the target
    channel stack and ride the one fused warp (make_targets `extra`).
    One K2 lookup fetches all 2S (mu, sigma) columns."""
    S = cfg.all_samples
    gen = subject["gen"]
    luts = [sample_contrast_lut(draws.sub("contrast", i), cfg.ct_prob,
                                setup["photo_mode"]) for i in range(S)]
    mus = torch.stack([m for m, _ in luts], dim=-1)      # (256, S)
    sigmas = torch.stack([s for _, s in luts], dim=-1)   # (256, S)

    g = torch.where(gen == 77, 2, gen)
    if hemis_mask is not None:
        g = torch.where(hemis_mask == 0, 0, g)
    gr = g.int().clamp(0, 255)
    noise = draws.normal("syn_noise", (*gr.shape, S))
    ms = lut_apply(torch.cat([mus, sigmas], dim=1).contiguous(), gr)
    return (ms[..., :S] + ms[..., S:] * noise).clamp(min=0.0)


def _synth_sample(draws: Draws, syn, subject, cfg, setup, knobs, tasks,
                  target):
    """Per-sample tail of the synthetic contrast: random linear mix with
    the real contrasts, then the augmentation chain."""
    if cfg.mix_synth_prob > 0:
        mix = draws.uniform("mix_u") < cfg.mix_synth_prob
        v = draws.uniform("mix_v", (4,)).clone()
        # weights of unavailable contrasts are zeroed and the rest
        # renormalized, so the blend stays unit-sum
        for i, t in enumerate(("T1", "T2", "FLAIR"), start=1):
            if t not in subject or t not in target:
                v[i] = 0.0
        v = v / v.sum()
        if mix:
            mixed = v[0] * syn
            # targets are flipped when setup.flip: unflip them to mix
            for i, t in enumerate(("T1", "T2", "FLAIR"), start=1):
                if t in target:
                    mixed = mixed + v[i] * _flip0(target[t][..., 0],
                                                  setup["flip"])
            syn = mixed
    syn = syn.clamp(min=0.0)
    return _finish_sample(draws, syn, cfg, setup, knobs, tasks, "synth")


def synth_item(generator, subject: dict, cfg: SynthStatic,
               tasks: Sequence[str], input_mode: str, knobs_stack,
               draws=None, record=None):
    """Generate one training item: (target dict, samples dict stacked on a
    leading S axis). `input_mode` in {'synth','T1','T2','FLAIR','CT'};
    knobs_stack leaves have leading dim cfg.all_samples.

    generator: torch.Generator on the subject's device (None: PyTorch's
    default one). draws: optional nested dict of injected draws, by the
    names the random functions use; record: optional dict that receives
    every draw made, so `draws=record` replays the item."""
    tasks = tuple(tasks)
    for t in ("pathology", "surface"):
        if t in tasks:
            raise NotImplementedError(f"the {t} task is not ported yet")
    dev = subject["gen"].device
    d = Draws(generator, dev, draws, record)
    setup = sample_setup(d.sub("setup"), cfg)
    shp = subject["shape"]
    sfd, A, c2 = random_affine(d.sub("affine"), cfg, shp)
    F = None
    if cfg.nonlinear_transform:
        F, _ = random_nonlinear_field(d.sub("field"), cfg, setup)
    grid = deform_grid(cfg, shp, A, c2, F)

    S = cfg.all_samples
    _, lut_np, _ = _label_tables(cfg.left_hemis_only)
    hemis_mask = _hemis_mask_src(subject, cfg,
                                 torch.from_numpy(lut_np).to(dev))
    extra = None
    if input_mode == "synth":
        extra = _synth_volumes(d.sub("synth"), subject, cfg, setup,
                               hemis_mask)

    target, extra_warped = make_targets(subject, grid, setup, sfd, cfg,
                                        tasks, extra=extra,
                                        hemis_mask=hemis_mask)

    if input_mode != "synth":
        # the real image is warped once: all S samples share the grid
        v = torch.nan_to_num(subject["image"])
        if hemis_mask is not None:
            v = torch.where(hemis_mask == 0, 0.0, v)
        idef_real = warp_volume(v.contiguous(), grid, approx=cfg.approx_warp)
    samples = []
    for i in range(S):
        di = d.sub("samples", i)
        knobs = {k: torch.as_tensor(a, dtype=torch.float32).to(dev)[i]
                 for k, a in knobs_stack.items()}
        if input_mode == "synth":
            sample = _synth_sample(di, extra_warped[..., i], subject, cfg,
                                   setup, knobs, tasks, target)
        else:
            sample = _finish_sample(di, idef_real, cfg, setup, knobs, tasks,
                                    input_mode)
        samples.append(sample)

    # drop mix-only contrasts (deformed for the blend, not requested)
    for t in ("T1", "T2", "FLAIR"):
        if t not in tasks:
            target.pop(t, None)

    stacked = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
    return target, stacked


# ---------------------------------------------------------------------------
# subject bank
# ---------------------------------------------------------------------------

MILD_KNOBS = dict(gamma_std=0.01, bf_scale_min=0.01, bf_scale_max=0.02,
                  bf_std_min=0.0, bf_std_max=0.02, noise_std_min=0.0,
                  noise_std_max=0.02)
SEVERE_KNOBS = dict(gamma_std=0.1, bf_scale_min=0.02, bf_scale_max=0.04,
                    bf_std_min=0.1, bf_std_max=0.6, noise_std_min=0.05,
                    noise_std_max=1.0)
SYNTH_NOISE = dict(noise_std_min=5.0, noise_std_max=15.0)
REAL_NOISE = dict(noise_std_min=0.0, noise_std_max=0.02)


def build_knobs_stack(cfg: SynthStatic, input_mode: str,
                      mild=None, severe=None, noise=None):
    """Per-sample augmentation strengths: mild/severe by sample index, then
    the synth/real noise override. Returns {knob: (S,) float32 tensor}."""
    mild = dict(MILD_KNOBS, **(mild or {}))
    severe = dict(SEVERE_KNOBS, **(severe or {}))
    noise = dict(SYNTH_NOISE if input_mode == "synth" else REAL_NOISE,
                 **(noise or {}))
    rows = []
    for i in range(cfg.all_samples):
        row = dict(mild if i < cfg.mild_samples else severe)
        row.update(noise)
        rows.append(row)
    return {k: torch.tensor([r[k] for r in rows], dtype=torch.float32)
            for k in rows[0]}


def knobs_from_cfg(cfg_tree, scfg: SynthStatic, input_mode: str):
    """Knob rows from the config tree's mild_generator / severe_generator /
    synth_image_generator / real_image_generator blocks; unknown keys are
    ignored and missing blocks fall back to the defaults above."""
    known = set(MILD_KNOBS) | set(SYNTH_NOISE)

    def blk(name):
        b = cfg_tree.get(name) if hasattr(cfg_tree, "get") else None
        if not b or not hasattr(b, "items"):
            return {}
        return {k: float(v) for k, v in dict(b).items() if k in known}

    noise_name = ("synth_image_generator" if input_mode == "synth"
                  else "real_image_generator")
    return build_knobs_stack(scfg, input_mode, mild=blk("mild_generator"),
                             severe=blk("severe_generator"),
                             noise=blk(noise_name))


class SubjectBank:
    """Host-side subject store: subjects padded to one bank shape, shipped
    to the device on demand. Procedural debug subjects let the whole
    pipeline run without data. (Loading NIfTI files is not ported yet.)"""

    def __init__(self, bank_shape=(192, 192, 192)):
        self.bank_shape = tuple(bank_shape)
        self.subjects = []
        self._dev_cache = OrderedDict()

    @staticmethod
    def _pad(vol, shape):
        out = np.zeros(shape + vol.shape[3:], vol.dtype)
        sl = tuple(slice(0, min(s, t)) for s, t in zip(vol.shape[:3], shape))
        out[sl] = vol[tuple(sl)]
        return out

    def add_debug_subject(self, seed=0, extent=(160, 160, 160)):
        """Procedural label-blob subject for tests and benchmarks (the same
        volumes as brainfm_tpu's SubjectBank.add_debug_subject)."""
        rng = np.random.default_rng(seed)
        D, H, W = extent
        zz, yy, xx = np.meshgrid(np.linspace(-1, 1, D), np.linspace(-1, 1, H),
                                 np.linspace(-1, 1, W), indexing="ij")
        r = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
        gen = np.zeros(extent, np.int32)
        gen[r < 0.8] = 3    # GM shell
        gen[r < 0.6] = 2    # WM
        gen[r < 0.2] = 4    # ventricle/CSF
        for lab in (10, 11, 12, 13, 17, 18):
            c = rng.uniform(-0.4, 0.4, 3)
            rr = np.sqrt((xx - c[0]) ** 2 + (yy - c[1]) ** 2 + (zz - c[2]) ** 2)
            gen[rr < rng.uniform(0.05, 0.12)] = lab
        seg = gen.copy()
        t1 = (gen > 0).astype(np.float32) * (
            100 + 50 * rng.standard_normal(extent)).clip(0)
        dist = np.stack([128 + 20 * (r - 0.7)] * 4, axis=-1).astype(np.float32)
        reg = np.stack([xx, yy, zz], axis=-1).astype(np.float32) * 10000
        subj = {
            "gen": self._pad(gen, self.bank_shape),
            "seg": self._pad(seg, self.bank_shape),
            "T1": self._pad(t1, self.bank_shape),
            "image": self._pad(t1, self.bank_shape),
            "dist": self._pad(dist, self.bank_shape),
            "reg": self._pad(reg, self.bank_shape),
            "shape": np.asarray([min(s, b) for s, b in
                                 zip(extent, self.bank_shape)], np.float32),
            "age": np.float32(rng.uniform(20.0, 90.0)),
        }
        self.subjects.append(subj)
        return len(self.subjects) - 1

    def to_device(self, idx: int, device=None, cache_size: int = 4):
        """Device-resident view of subject `idx` (default device: CUDA),
        LRU-cached so a hot subject is not shipped again every item."""
        dev = resolve_device(device)
        key = (idx, str(dev))
        if key in self._dev_cache:
            self._dev_cache.move_to_end(key)
            return self._dev_cache[key]
        # float64 host volumes arrive as float32, as jnp.asarray gives them
        out = {k: torch.as_tensor(np.asarray(
            v, np.float32 if np.asarray(v).dtype == np.float64 else None))
            .to(dev) for k, v in self.subjects[idx].items()}
        while len(self._dev_cache) >= cache_size:
            self._dev_cache.popitem(last=False)
        self._dev_cache[key] = out
        return out

    def __len__(self):
        return len(self.subjects)
