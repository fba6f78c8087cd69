"""The synthesis engine: one training item per call (port of
brainfm_tpu/synth/engine.py).

`synth_item(generator, subject, cfg, tasks, input_mode, knobs_stack)`
produces the (target, samples) pair for one subject with `all_samples`
intra-subject augmentations, on the subject's device. Subject volumes live
in the subject frame (padded to the bank shape, true extent in
subject['shape']); targets and samples are made at cfg.size, channels-last,
samples stacked on a leading S axis.

Every path of the JAX engine is ported: synth and real input modes, the
label path with deform_one_hots on (K1 linear on the one-hot) or off (K2,
K1 nearest, K2), the pathology task (a random Perlin shape or a lesion
file warped by K1, advected, encoded into each sample) and the surface
task's deformation state. The SubjectBank reads subject files through the
port's codec (runtime/loader.py).
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
from ..utils.profiling import annotate, count
from .augment import augment_chain
from .constants import (LABELS_EXTRACEREBRAL, LABELS_LEFT, build_lut,
                        build_vflip)
from .deform import deform_grid, random_affine, random_nonlinear_field
from .draws import Draws
from .gmm import sample_contrast_lut
from .params import SynthStatic, sample_setup
from .pathology import (augment_pathology, binarize, encode_pathology,
                        pathology_direction, random_shape)


def _on(flag) -> bool:
    """flag > 0 on the host: a drawn tensor's is one host sync."""
    if torch.is_tensor(flag):
        count("host_syncs")
    return bool(flag > 0)


def _to(table, dev):
    """A host table copied to `dev`: one host sync (the copy from pageable
    memory waits for the card's queue)."""
    count("host_syncs")
    return torch.from_numpy(table).to(dev)


def _flip0(x, flip):
    """Sagittal flip (axis 0) when the flip draw is on."""
    return torch.flip(x, (0,)) if _on(flip) else x


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
    (K2 on vflip) before the one-hot. deform_one_hots: the one-hot of the
    compacted labels (56 channels, 18 left-only) is warped by K1 linear
    instead, then flipped with the vflip channel permutation."""
    s = seg.int()
    if hemis_mask is not None:
        s = torch.where(hemis_mask == 0, 0, s)
    sc = lut_apply(lut, s.clamp(0, lut.shape[0] - 1))
    if deform_one_hots:
        onehot = _one_hot(sc, int(vflip.shape[0]))
        sd = warp_volume(onehot, grid)
        return torch.flip(sd, (0,))[..., vflip.long()] if _on(flip) else sd
    scd = warp_labels(sc, grid)
    # flip(onehot(l))[..., vflip] == onehot(vflip[flip(l)]): vflip is the
    # half-swap involution
    lab = lut_apply(vflip, torch.flip(scd, (0,))) if _on(flip) else scd
    return _one_hot(lab, int(vflip.shape[0]))


def _target_pathology(draws: Draws, subject, grid, setup, cfg):
    """(P, Pprob), each (*size, 1): with pathol_mode on, a random Perlin
    shape (pathol_random_shape, or no lesion file) or the subject's lesion
    probability warped by K1, advected when cfg.augment_pathology, then
    binarized; both zero when pathol_mode is off or the shape is below
    cfg.pathol_tol. Spans `gen.shape` or `gen.lesion_warp`, and
    `gen.advect` (utils/profiling.py)."""
    size = tuple(grid[0].shape)
    dev = grid[0].device
    on = _on(setup["pathol_mode"])
    if on:
        use_random = (_on(setup["pathol_random_shape"])
                      or "pathol_prob" not in subject)
        if use_random:
            with annotate("gen.shape"):
                pdef, _ = random_shape(draws.sub("shape"), size, cfg)
        else:
            with annotate("gen.lesion_warp"):
                pdef = warp_volume(torch.nan_to_num(
                    subject["pathol_prob"]).contiguous(), grid)
        if cfg.augment_pathology:
            with annotate("gen.advect"):
                pdef = augment_pathology(draws.sub("augment"), pdef, cfg)
    else:
        pdef = torch.zeros(size, device=dev)
    p = binarize(pdef, cfg.pathol_thres)
    if on:
        count("host_syncs")
    alive = on and bool(torch.mean(p) > cfg.pathol_tol)
    if not alive:
        p, pdef = torch.zeros_like(p), torch.zeros_like(pdef)
    return p[..., None], pdef[..., None]


def make_targets(subject, grid, setup, sfd, cfg, tasks, extra=None,
                 hemis_mask=None, draws=None):
    """Deform every requested target. All trilinear targets, plus `extra`
    channels (the synthetic contrasts and, with pathology, their masked
    copies), are stacked channel-wise into ONE fused warp with per-channel
    out-of-bounds defaults (K1). `draws`: the pathology target's draws.
    Returns (target dict, warped extra channels or None)."""
    flip = setup["flip"]
    left = cfg.left_hemis_only
    dev = grid[0].device
    _, lut_np, vflip_np = _label_tables(left)
    lut = _to(lut_np, dev)
    vflip = _to(vflip_np, dev)

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
        if not left and _on(flip):
            lp, lw, rp, rw = (torch.flip(c, (0,)) for c in chans)
            chans = [rp, rw, lp, lw]
        out = torch.stack(chans, dim=-1)
        target["distance"] = (out / sfd).clamp(-cfg.max_surf_distance,
                                               cfg.max_surf_distance)
    if "reg" in warped:
        rx, ry, rz = (warped["reg"][..., c] for c in range(3))
        if _on(flip):
            rx, ry, rz = (-torch.flip(rx, (0,)), torch.flip(ry, (0,)),
                          torch.flip(rz, (0,)))
        target["registration"] = torch.stack([rx, ry, rz], dim=-1)
    if "pathology" in tasks:
        with annotate("gen.pathology"):
            p, pprob = _target_pathology(
                draws if draws is not None else Draws(device=dev), subject,
                grid, setup, cfg)
        target["pathology"] = p
        target["pathology_prob"] = pprob
    if "age" in tasks and "age" in subject:
        target["age"] = subject["age"]
    return target, extra_warped


def _finish_sample(draws: Draws, idef, cfg, setup, knobs, tasks, target,
                   pathol_direction, input_mode):
    """Pathology encode + augmentation chain + restore + normalize + flip."""
    if input_mode == "CT":
        idef = idef.clamp(0.0, 80.0)
    if "pathology" in tasks:
        p = target["pathology"][..., 0]
        pprob = target["pathology_prob"][..., 0]
        enc = encode_pathology(draws.sub("encode"), idef, p, pprob,
                               pathol_direction)
        idef = torch.where(torch.sum(p) > 0, enc.clamp(min=0.0), idef)
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


def _synth_volumes(draws: Draws, subject, cfg, setup, tasks,
                   hemis_mask=None):
    """All S synthetic contrasts in the subject frame, channel-stacked
    (D,H,W,S): they share the deformation grid, so they join the target
    channel stack and ride the one fused warp (make_targets `extra`).
    One K2 lookup fetches all 2S (mu, sigma) columns. With the pathology
    task the S cerebral-masked copies that the keep masks need join too
    (2S channels), and each contrast's pathology direction (grey brighter
    than white matter) is returned. Returns (chans, pathol_dir (S,) or
    None)."""
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
    syn = (ms[..., :S] + ms[..., S:] * noise).clamp(min=0.0)
    if "pathology" not in tasks:
        return syn, None
    wm = ((gr == 2) | (gr == 41))[..., None]
    gm = (gr != 0)[..., None] & ~wm
    wm_mean = torch.sum(syn * wm, dim=(0, 1, 2)) / wm.sum().clamp(min=1)
    gm_mean = torch.sum(syn * gm, dim=(0, 1, 2)) / gm.sum().clamp(min=1)
    pathol_dir = (gm_mean > wm_mean).float()
    masked = torch.where((gr == 0)[..., None], 0.0, syn)
    return torch.cat([syn, masked], dim=-1), pathol_dir


def _synth_sample(draws: Draws, syn, keep, pathol_dir, subject, cfg, setup,
                  knobs, tasks, target):
    """Per-sample tail of the synthetic contrast: random linear mix with
    the real contrasts, the pathology keep mask (applied to the shared
    target, so it accumulates over the samples, as in the JAX package),
    then the pathology encode and the augmentation chain."""
    if cfg.mix_synth_prob > 0:
        mix = draws.uniform("mix_u") < cfg.mix_synth_prob
        v = draws.uniform("mix_v", (4,)).clone()
        # weights of unavailable contrasts are zeroed and the rest
        # renormalized, so the blend stays unit-sum
        for i, t in enumerate(("T1", "T2", "FLAIR"), start=1):
            if t not in subject or t not in target:
                count("host_syncs")
                v[i] = 0.0
        v = v / v.sum()
        count("host_syncs")
        if mix:
            mixed = v[0] * syn
            # targets are flipped when setup.flip: unflip them to mix
            for i, t in enumerate(("T1", "T2", "FLAIR"), start=1):
                if t in target:
                    mixed = mixed + v[i] * _flip0(target[t][..., 0],
                                                  setup["flip"])
            syn = mixed
    if "pathology" in tasks:
        target["pathology"] = target["pathology"] * keep
        target["pathology_prob"] = target["pathology_prob"] * keep
    syn = syn.clamp(min=0.0)
    return _finish_sample(draws, syn, cfg, setup, knobs, tasks, target,
                          pathol_dir, "synth")


def synth_item(generator, subject: dict, cfg: SynthStatic,
               tasks: Sequence[str], input_mode: str, knobs_stack,
               draws=None, record=None):
    """Generate one training item: (target dict, samples dict stacked on a
    leading S axis). `input_mode` in {'synth','T1','T2','FLAIR','CT'};
    knobs_stack leaves have leading dim cfg.all_samples.

    generator: torch.Generator on the subject's device (None: PyTorch's
    default one). draws: optional nested dict of injected draws, by the
    names the random functions use; record: optional dict that receives
    every draw made, so `draws=record` replays the item. The item is the
    span `gen.item` (a unit of work, utils/profiling.py) over `gen.setup`,
    `gen.deform`, `gen.synth`, `gen.targets` and one `gen.sample` a
    sample."""
    with annotate("gen.item", unit=True):
        return _synth_item(generator, subject, cfg, tuple(tasks),
                           input_mode, knobs_stack, draws, record)


def _synth_item(generator, subject, cfg, tasks, input_mode, knobs_stack,
                draws, record):
    dev = subject["gen"].device
    d = Draws(generator, dev, draws, record)
    shp = subject["shape"]
    with annotate("gen.setup"):
        setup = sample_setup(d.sub("setup"), cfg)
        sfd, A, c2 = random_affine(d.sub("affine"), cfg, shp)
    with annotate("gen.deform"):
        F = Fneg = None
        if cfg.nonlinear_transform:
            F, Fneg = random_nonlinear_field(d.sub("field"), cfg, setup,
                                             need_inverse="surface" in tasks)
        grid = deform_grid(cfg, shp, A, c2, F)

    S = cfg.all_samples
    with annotate("gen.synth"):
        _, lut_np, _ = _label_tables(cfg.left_hemis_only)
        hemis_mask = _hemis_mask_src(subject, cfg, _to(lut_np, dev))
        extra = pathol_dir = None
        if input_mode == "synth":
            extra, pathol_dir = _synth_volumes(d.sub("synth"), subject, cfg,
                                               setup, tasks, hemis_mask)

    with annotate("gen.targets"):
        target, extra_warped = make_targets(subject, grid, setup, sfd, cfg,
                                            tasks, extra=extra,
                                            hemis_mask=hemis_mask,
                                            draws=d.sub("pathology"))

    if input_mode != "synth":
        # the real image is warped once: all S samples share the grid
        v = torch.nan_to_num(subject["image"])
        if hemis_mask is not None:
            v = torch.where(hemis_mask == 0, 0.0, v)
        idef_real = warp_volume(v.contiguous(), grid, approx=cfg.approx_warp)
    samples = []
    for i in range(S):
        with annotate("gen.sample"):
            di = d.sub("samples", i)
            count("host_syncs", sum(not torch.is_tensor(a) or a.device != dev
                                    for a in knobs_stack.values()))
            knobs = {k: torch.as_tensor(a, dtype=torch.float32).to(dev)[i]
                     for k, a in knobs_stack.items()}
            if input_mode == "synth":
                keep = ((extra_warped[..., S + i] != 0).float()[..., None]
                        if "pathology" in tasks else None)
                sample = _synth_sample(
                    di, extra_warped[..., i], keep,
                    None if pathol_dir is None else pathol_dir[i], subject,
                    cfg, setup, knobs, tasks, target)
            else:
                sample = _finish_sample(
                    di, idef_real, cfg, setup, knobs, tasks, target,
                    pathology_direction(di, input_mode)
                    if "pathology" in tasks else None, input_mode)
        samples.append(sample)

    # the surface task's deformation state, for the mesh warp of
    # synth/surface.py::deform_surfaces
    if "surface" in tasks:
        target["surface_svf_neg"] = Fneg if Fneg is not None else \
            torch.zeros((*cfg.size, 3), device=dev)
        target["surface_affine_A"] = A
        target["surface_affine_c2"] = c2
        target["surface_flip"] = setup["flip"]

    # drop mix-only contrasts (deformed for the blend, not requested)
    for t in ("T1", "T2", "FLAIR"):
        if t not in tasks:
            target.pop(t, None)

    # the pathology targets are flipped last, after the keep masks
    if "pathology" in target:
        target["pathology"] = _flip0(target["pathology"], setup["flip"])
        target["pathology_prob"] = _flip0(target["pathology_prob"],
                                          setup["flip"])

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
    """Host-side subject store: subjects decoded once (the port's native
    codec, runtime/loader.py), padded to one bank shape, shipped to the
    device on demand. Procedural debug subjects let the whole pipeline run
    without data."""

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

    def add_many(self, subject_paths, ages=None):
        """Batch ingest: every volume of every subject decoded in one
        parallel codec pass, then the subjects assembled. The same bits as
        repeated `add_from_files`.

        subject_paths: list of dicts like add_from_files' `paths`; ages:
        optional list aligned with subject_paths. Returns the new subject
        indices."""
        from ..runtime.loader import VolCodec

        jobs = []  # (subject_idx, key, channel_idx|None, path)
        for si, paths in enumerate(subject_paths):
            for key, p in paths.items():
                if key in ("dist", "reg"):
                    jobs.extend((si, key, ci, str(q))
                                for ci, q in enumerate(p))
                else:
                    jobs.append((si, key, None, str(p)))
        arena, shapes, extras = VolCodec(
            self.bank_shape).decode_batch_with_shapes([j[3] for j in jobs])

        built = [dict() for _ in subject_paths]
        shape_of = [None] * len(subject_paths)
        for row, (si, key, ci, path) in enumerate(jobs):
            shp = shapes[row]
            if shape_of[si] is None:
                shape_of[si] = shp
            elif tuple(shp) != tuple(shape_of[si]):
                raise ValueError(
                    f"subject volumes disagree on shape: {key} is {shp}, "
                    f"expected {shape_of[si]}; all of a subject's volumes "
                    "must share one native grid")
            if row in extras:  # frames beyond 3-D are kept
                vol = self._pad(extras[row], self.bank_shape)
            else:
                vol = arena[row]
            if key in ("gen", "seg"):
                vol = vol.astype(np.int32)
            elif ci is None and row not in extras:
                # copy the row out of the decode arena: a view would pin
                # the whole (n_jobs, *bank_shape) arena for the bank's
                # life; dist/reg channels are copied by np.stack below
                vol = vol.copy()
            if ci is None:
                built[si][key] = vol
            else:
                built[si].setdefault(key, {})[ci] = vol
        out = []
        for si, (b, paths) in enumerate(zip(built, subject_paths)):
            subj = {}
            for key in paths:  # add_from_files' key order
                v = b[key]
                subj[key] = (np.stack([v[c] for c in sorted(v)], axis=-1)
                             if key in ("dist", "reg") else v)
            subj["shape"] = self._extent(shape_of[si])
            age = ages[si] if ages is not None else None
            if age is not None:
                subj["age"] = np.float32(age)
            self.subjects.append(subj)
            out.append(len(self.subjects) - 1)
        return out

    def add_from_files(self, paths: dict, age=None):
        """One subject from its files, read by the Python reader: paths
        {'gen': ..., 'seg': ..., 'T1': ..., 'dist': [4 paths], 'reg': [3
        paths], ...}."""
        from ..utils.nifti import load_nifti

        subj = {}
        shape = None
        for key, p in paths.items():
            if key in ("dist", "reg"):
                chans = [load_nifti(q)[0] for q in p]
                vol = np.stack(chans, axis=-1).astype(np.float32)
            else:
                vol, _ = load_nifti(p)
                vol = vol.astype(np.int32 if key in ("gen", "seg")
                                 else np.float32)
                # trailing singleton frames are a 3-D volume, as the codec
                # of add_many reads them
                while vol.ndim > 3 and vol.shape[-1] == 1:
                    vol = vol[..., 0]
            if shape is None:
                shape = vol.shape[:3]
            elif tuple(vol.shape[:3]) != tuple(shape):
                raise ValueError(
                    f"subject volumes disagree on shape: {key} is "
                    f"{vol.shape[:3]}, expected {shape}; all of a subject's "
                    "volumes must share one native grid")
            subj[key] = self._pad(vol, self.bank_shape)
        subj["shape"] = self._extent(shape)
        if age is not None:
            subj["age"] = np.float32(age)
        self.subjects.append(subj)
        return len(self.subjects) - 1

    def _extent(self, shape):
        """The extent the bank stores: a volume larger than bank_shape is
        cropped by _pad, so the native extent is clamped to it (else
        deform_grid would sample the zero padding)."""
        return np.asarray([min(s, b) for s, b in zip(shape, self.bank_shape)],
                          np.float32)

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
            "shape": self._extent(extent),
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
        out = self.stage(idx, dev)
        while len(self._dev_cache) >= cache_size:
            self._dev_cache.popitem(last=False)
        self._dev_cache[key] = out
        return out

    def stage(self, idx: int, device=None):
        """One-shot device view of subject `idx` (default device: CUDA),
        not cached: its tensors are freed once the caller drops them, so
        no bank volume stays on the card while the train step runs
        (cfg subject_staging: host). Costs one host-to-device copy of the
        subject per draw."""
        dev = resolve_device(device)
        # float64 host volumes arrive as float32, as jnp.asarray gives them
        return {k: torch.as_tensor(np.asarray(
            v, np.float32 if np.asarray(v).dtype == np.float64 else None))
            .to(dev) for k, v in self.subjects[idx].items()}

    def __len__(self):
        return len(self.subjects)
