"""Model assembly: task wiring, joiners, output processors, the two-stage
pair and the frozen pathology critic (port of brainfm_tpu/models/build.py).

The model modules run in NCDHW, the layout cuDNN expects; the joiners
take and return the JAX package's channels-last layout (N,D,H,W,C) and
permute once at their boundary. Mixed precision is the caller's
`torch.autocast`, not a compute dtype.

The two stages of two-stage inpainting are one `TwoStage` module with the
children `pathol` and `task`, so one optimizer, TrainState and checkpoint
carry the pair. The critic of `losses.implicit_pathol` is a frozen Joiner
outside the trained model: no gradient reaches its weights and no
optimizer holds them.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict

import torch
from torch import nn

from ..device import resolve_device
from ..ops.lut import lut_apply
from ..synth.constants import LABELS_EXTRACEREBRAL, LABELS_LEFT
from ..utils.profiling import count
from .heads import TaskHead
from .params_io import read_state_dict
from .unet3d import UNet2D, UNet3D, UNet3DSep

# the first N_NEUTRAL_EXTRACEREBRAL labels of LABELS_EXTRACEREBRAL are the
# neutral (non-lateral) ones (the reference's Trainer/models/__init__.py:30)
N_NEUTRAL_EXTRACEREBRAL = 20


def process_args(cfg):
    """Derive out_channels / output_names / target_names from the task
    toggles. Mutates and returns cfg."""
    task = cfg.task
    cfg.tasks = [k for k, v in dict(task).items() if v]
    gen = cfg.generator
    if gen.left_hemis_only:
        cfg.label_list_segmentation = LABELS_LEFT
    else:
        cfg.label_list_segmentation = LABELS_EXTRACEREBRAL
    cfg.n_labels = len(cfg.label_list_segmentation)

    unc = cfg.losses.uncertainty if cfg.losses else None
    img_ch = 2 if unc is not None else 1
    out_channels: Dict[str, int] = {}
    output_names, aux_output_names, target_names = [], [], []

    if "contrastive" not in cfg.tasks:
        for t in ("T1", "T2", "FLAIR", "CT"):
            if t in cfg.tasks:
                out_channels[t] = img_ch
                output_names.append(t)
                target_names.append(t)
                if unc is not None:
                    aux_output_names.append(f"{t}_sigma")
        if "bias_field" in cfg.tasks:
            out_channels["bias_field_log"] = img_ch
            output_names.append("bias_field")
            target_names.append("bias_field")
        if "segmentation" in cfg.tasks:
            out_channels["segmentation"] = cfg.n_labels
            output_names.append("label")
            target_names.append("label")
        if "distance" in cfg.tasks:
            n = 2 if gen.left_hemis_only else 4
            out_channels["distance"] = n
            names = ["distance", "lp", "lw"] + ([] if n == 2 else ["rp", "rw"])
            output_names += names
            target_names += names
        if "registration" in cfg.tasks:
            out_channels["registration"] = 3
            output_names += ["registration", "regx", "regy", "regz"]
            target_names += ["registration", "regx", "regy", "regz"]
        if "surface" in cfg.tasks:
            out_channels["surface"] = 8
            output_names.append("surface")
            target_names.append("surface")
        if "super_resolution" in cfg.tasks:
            out_channels["high_res_residual"] = img_ch
            output_names += ["high_res", "high_res_residual"]
            target_names += ["high_res", "high_res_residual"]
        if "pathology" in cfg.tasks:
            out_channels["pathology"] = 1
            output_names.append("pathology")
            target_names.append("pathology")
        if "age" in cfg.tasks:
            out_channels["age"] = -1

    cfg.out_channels = out_channels
    cfg.output_names = output_names
    cfg.aux_output_names = aux_output_names
    cfg.target_names = target_names
    return cfg


def _to_ncdhw(x):
    return x.movedim(-1, 1)


def _model_input(x):
    """The backbone's NCDHW input. A one-channel input keeps the
    channels-last strides its permute gives, and the network runs in that
    layout on the card, as measured since the first slice. On the CPU it
    gets plain NCDHW strides: PyTorch's CPU GroupNorm backward faults on a
    channels-last input that needs no gradient (the first GroupNorm in
    training)."""
    x = _to_ncdhw(x)
    if x.device.type == "cpu":
        return x.clone(memory_format=torch.contiguous_format)
    return x.contiguous()


def _to_ndhwc(x):
    return x.movedim(1, -1)


def _head_out(v):
    """A head output in the joiners' layout: channels last for a field;
    a scalar head's (N,) or (N, n) as it is."""
    return _to_ndhwc(v) if v.dim() > 2 else v


def _conditioned(x, cond):
    return x if cond is None else torch.cat([x, cond], dim=-1)


class Joiner(nn.Module):
    """Backbone + head. Takes x (N,D,H,W,C) and optional conditioning
    channels concatenated to it; returns {'feat': [...], <head outputs>},
    every field (N,D,H,W,C), a scalar head's output (N,) or (N, n)."""

    def __init__(self, backbone, head=None):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x, cond=None):
        feats = self.backbone.get_feature(_model_input(_conditioned(x, cond)))
        out = {"feat": [_to_ndhwc(f) for f in feats]}
        if self.head is not None:
            out.update({k: _head_out(v) for k, v in self.head(feats).items()})
        return out


class SepJoiner(nn.Module):
    """UNet3DSep + a normal and a pathology head: returns
    {'feat_normal': [...], 'feat_pathology': [...], <head outputs>}."""

    def __init__(self, backbone, head_normal=None, head_pathol=None):
        super().__init__()
        self.backbone = backbone
        self.head_normal = head_normal
        self.head_pathol = head_pathol

    def forward(self, x, cond=None):
        feats = self.backbone.get_feature(_model_input(_conditioned(x, cond)))
        out = {"feat_normal": [_to_ndhwc(f) for f in feats["normal"]],
               "feat_pathology": [_to_ndhwc(f) for f in feats["pathology"]]}
        for head, key in ((self.head_normal, "normal"),
                          (self.head_pathol, "pathology")):
            if head is not None:
                out.update({k: _head_out(v)
                            for k, v in head(feats[key]).items()})
        return out


def _cond_terms(cfg) -> int:
    return sum(t in str(cfg.get("condition") or "") for t in ("mask", "flip"))


def build_backbone(cfg, name: str | None = None, cond_channels=None):
    """The backbone `name` (default cfg.backbone): unet3d, unet3d_sep or
    unet2d. cfg.remat sets its blocks' rematerialization in the backward
    pass (unet3d.remat_mode: False, True/'full', 'save_convs'), and
    cfg.phase_upconv (default true, as the JAX package reads it) the
    decoders' pair form (unet3d.Decoder). The input is widened by
    `cond_channels`, by default one channel per term of a conditioned
    config (cfg.condition 'mask', 'flip' or 'mask+flip'), the
    channels the train step concatenates (train/loop.py::apply_condition)."""
    name = name or cfg.backbone or "unet3d"
    classes = {"unet3d": UNet3D, "unet3d_sep": UNet3DSep, "unet2d": UNet2D}
    if name not in classes:
        raise ValueError(f"unknown backbone {name}")
    if cond_channels is None:
        cond_channels = _cond_terms(cfg)
    return classes[name](in_channels=int(cfg.in_channels or 1) + cond_channels,
                         f_maps=int(cfg.f_maps or 64),
                         num_levels=int(cfg.num_levels or 5),
                         layer_order=cfg.layer_order or "gcl",
                         num_groups=int(cfg.num_groups or 8),
                         is_unit_vector=bool(cfg.unit_feat),
                         remat=cfg.get("remat") or False,
                         phase_upconv=bool(cfg.get("phase_upconv", True)))


def _task_head(cfg, out_channels, is_3d=True):
    return TaskHead(int(cfg.f_maps or 64), tuple(cfg.task_f_maps or [64]),
                    dict(out_channels), tuple(cfg.generator.size),
                    is_3d=is_3d)


def _without_pathology(cfg):
    return {k: v for k, v in cfg.out_channels.items() if k != "pathology"}


def build_model(cfg, device=None):
    """Assemble the model for cfg on `device` (default CUDA): a Joiner, or
    for a `sep` backbone a SepJoiner whose pathology head has the
    pathology output and whose normal head has the rest. Returns (cfg,
    model)."""
    dev = resolve_device(device)
    cfg = process_args(cfg)
    name = cfg.backbone or "unet3d"
    backbone = build_backbone(cfg)
    if "sep" in name:
        model = SepJoiner(backbone, _task_head(cfg, _without_pathology(cfg)),
                          _task_head(cfg, {"pathology": 1}))
    else:
        model = Joiner(backbone, _task_head(cfg, cfg.out_channels,
                                           is_3d=name != "unet2d"))
    return cfg, model.to(dev)


def build_conditioned_model(cfg, device=None):
    """The mask-conditioned inpainting model: a Joiner whose input is
    widened by the conditioning channels (cfg.condition's terms, at least
    the one mask channel) and whose head has every output but pathology.
    Returns (cfg, model)."""
    dev = resolve_device(device)
    cfg = process_args(cfg)
    backbone = build_backbone(cfg, cond_channels=max(_cond_terms(cfg), 1))
    return cfg, Joiner(backbone,
                       _task_head(cfg, _without_pathology(cfg))).to(dev)


def twostage_forward(pathol_model, task_model, x, detach_stage0=False):
    """The chained two-stage forward: stage 0 predicts the pathology mask
    (its sigmoid); stage 1 sees x * (1 - mask) conditioned on the mask.
    Returns stage 1's outputs with 'pathology' (the mask), 'feat_pathol'
    and 'feat_task' (each stage's feature levels). `detach_stage0`: no
    gradient flows through stage 0 (its parameters get none)."""
    out_p = pathol_model(x)
    pathol = torch.sigmoid(out_p["pathology"])
    if detach_stage0:
        pathol = pathol.detach()
    out_t = task_model(x * (1.0 - pathol), cond=pathol)
    out = dict(out_t)
    out["pathology"] = pathol
    out["feat_pathol"] = out_p["feat"]
    out["feat_task"] = out_t["feat"]
    return out


class TwoStage(nn.Module):
    """The two-stage pair as one module: `pathol` (stage 0, a Joiner with
    the pathology head) and `task` (stage 1, a Joiner one mask channel
    wider, with every other head). forward(x) is twostage_forward; its
    'pathology' output is already a sigmoid (process_outputs keeps it)."""

    def __init__(self, pathol, task):
        super().__init__()
        self.pathol = pathol
        self.task = task

    def forward(self, x, cond=None, detach_stage0=False):
        if cond is not None:
            raise ValueError("a two-stage model conditions stage 1 on stage "
                             "0's mask; it takes no cond")
        return twostage_forward(self.pathol, self.task, x, detach_stage0)


def build_inpaint_model(cfg, device=None):
    """Two-stage inpainting for an 'a+b' backbone (twostage.yaml: stage 0
    on backbone a predicts pathology; stage 1 on backbone b, its input one
    channel wider for the mask). Returns (cfg, TwoStage)."""
    dev = resolve_device(device)
    cfg = process_args(cfg)
    names = (cfg.backbone or "unet3d+unet3d").split("+")
    pathol = Joiner(build_backbone(cfg, names[0], cond_channels=0),
                    _task_head(cfg, {"pathology": 1}))
    task = Joiner(build_backbone(cfg, names[-1], cond_channels=1),
                  _task_head(cfg, _without_pathology(cfg)))
    return cfg, TwoStage(pathol, task).to(dev)


def build_pathol_critic(f_maps: int = 64, num_levels: int = 5, remat=False):
    """The implicit-pathology critic: UNet3D (f_maps 64, 5 levels by
    default, 'gcl', min(8, f_maps) groups) + a 1-channel pathology head.
    `remat` only trades its activation memory for recompute."""
    backbone = UNet3D(f_maps=f_maps, num_levels=num_levels,
                      layer_order="gcl", num_groups=min(8, f_maps),
                      remat=remat)
    return Joiner(backbone, TaskHead(f_maps, (f_maps,), {"pathology": 1}))


def _load_critic(critic, paths):
    """Load the critic's weights from the .pth / .pt state dicts `paths`,
    each by name into the part it holds (a bare backbone into
    `backbone`); together they must cover every weight of the critic and
    name nothing else."""
    loaded = set()
    for p in paths:
        state, bare = read_state_dict(p)
        if bare:
            state = {f"backbone.{k}": v for k, v in state.items()}
        res = critic.load_state_dict(state, strict=False)
        if res.unexpected_keys:
            raise ValueError(f"{p}: keys the critic does not have: "
                             f"{res.unexpected_keys[:5]}")
        loaded |= set(state)
    missing = sorted(set(critic.state_dict()) - loaded)
    if missing:
        raise ValueError("supervised_pathol_seg_ckp_path leaves critic "
                         f"weights unloaded (random): {missing[:5]}")


def build_critic_from_cfg(cfg, device=None, seed: int = 7):
    """The frozen implicit-pathology critic of losses.implicit_pathol:
    (critic, image_key), or (None, None) when the flag is off. `image_key`
    is the image task the critic scores, the first of T1, T2, FLAIR, CT
    in cfg.tasks. The geometry is UNet3D f_maps 64, 5 levels
    (cfg.critic_f_maps / critic_num_levels override it); its blocks take
    cfg.remat. Weights come from cfg.supervised_pathol_seg_ckp_path: one
    path, or {'feat': ..., 'task': ...}; a path that is not on disk raises
    FileNotFoundError (loading part of the critic would train against a
    half-random one). Without the key the weights are random, from `seed`
    on the CPU, with a warning. The critic is in eval mode with
    requires_grad off, on `device` (default CUDA)."""
    losses = cfg.losses if getattr(cfg, "losses", None) else None
    if not (losses and losses.get("implicit_pathol")):
        return None, None
    image_key = next((t for t in ("T1", "T2", "FLAIR", "CT")
                      if t in cfg.tasks), None)
    if image_key is None:
        raise ValueError("losses.implicit_pathol requires an image task "
                         "(T1/T2/FLAIR/CT) for the critic to score")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        critic = build_pathol_critic(
            f_maps=int(cfg.get("critic_f_maps") or 64),
            num_levels=int(cfg.get("critic_num_levels") or 5),
            remat=cfg.get("remat") or False)
    ckp = cfg.get("supervised_pathol_seg_ckp_path")
    paths = []
    if ckp is not None:
        paths = [ckp] if isinstance(ckp, str) else \
            [p for p in (ckp.get("feat"), ckp.get("task")) if p]
        missing = [str(p) for p in paths if not os.path.isfile(str(p))]
        if missing:
            raise FileNotFoundError(
                "supervised_pathol_seg_ckp_path: checkpoint file(s) not "
                f"found: {missing}. Loading only part of the frozen critic "
                "would train implicit_pathol against a half-random critic; "
                "fix the path(s), or unset supervised_pathol_seg_ckp_path "
                "to run a random-init critic on purpose")
    if paths:
        _load_critic(critic, [str(p) for p in paths])
    else:
        warnings.warn(
            "implicit_pathol is on but no supervised_pathol_seg_ckp_path "
            "checkpoint was configured: the critic runs with RANDOM weights "
            "(fine for smoke tests, meaningless as supervision)")
    critic.requires_grad_(False)
    return critic.eval().to(dev), image_key


def implicit_pathol_outputs(critic, outputs, targets, image_key: str):
    """outputs with implicit_pathol_pred (the critic's pathology sigmoid on
    the predicted image, through which gradients reach the model) and
    implicit_pathol_orig (on the target image, without gradients)."""
    out = dict(outputs)
    out["implicit_pathol_pred"] = torch.sigmoid(
        critic(outputs[image_key])["pathology"])
    with torch.no_grad():
        out["implicit_pathol_orig"] = torch.sigmoid(
            critic(targets[image_key])["pathology"])
    return out


def apply_processors(outputs: dict, cfg) -> dict:
    """Output processors on the joiners' (N,D,H,W,C) outputs."""
    tasks = cfg.tasks
    out = dict(outputs)
    unc = cfg.losses.uncertainty if cfg.losses else None
    if unc is not None:
        for name in ("T1", "T2", "FLAIR", "CT", "high_res_residual"):
            if name in out and out[name].shape[-1] == 2:
                out[f"{name}_sigma"] = out[name][..., 1:2]
                out[name] = out[name][..., 0:1]
    if "contrastive" in tasks and "feat" in out:
        f = out["feat"][-1]
        out["feat"] = list(out["feat"])
        out["feat"][-1] = f / torch.linalg.vector_norm(
            f, dim=-1, keepdim=True).clamp(min=1e-12)
    if "age" in tasks and "age" in out:
        out["age"] = out["age"].abs()
    if "segmentation" in tasks and "segmentation" in out:
        out["segmentation"] = torch.softmax(out["segmentation"], dim=-1)
    if "distance" in tasks and "distance" in out:
        m = float(cfg.max_surf_distance or 3.0)
        out["distance"] = out["distance"].clamp(-m, m)
    if "pathology" in tasks and "pathology" in out:
        out["pathology"] = torch.sigmoid(out["pathology"])
    return out


def process_outputs(model, outputs: dict, cfg) -> dict:
    """apply_processors on `model`'s outputs; a TwoStage model's
    'pathology' is already stage 0's sigmoid and is kept as it is."""
    out = apply_processors(outputs, cfg)
    if isinstance(model, TwoStage) and "pathology" in outputs:
        out["pathology"] = outputs["pathology"]
    return out


def _at_least_fp32(v):
    if torch.is_tensor(v) and v.is_floating_point():
        return v.to(torch.promote_types(v.dtype, torch.float32))
    return v


def _fake_cortical(p, w, a=2.0):
    return (70 * (1 - (torch.tanh(a * (w + 0.3)) + 1) / 2)
            + 40 * (1 - (torch.tanh(a * p) + 1) / 2))


def postprocess(outputs: dict, cfg, samples: dict | None = None,
                target: dict | None = None) -> dict:
    """Final output shaping (parity: get_postprocessor,
    Trainer/models/__init__.py:272-354): distance split + fake-cortical tanh
    render, registration split, bias-field exp, label argmax -> FreeSurfer
    ids, CT rescale, SR residual+input. The label map is
    `label_list_segmentation[argmax]`, an int32 table lookup that runs
    through K2 (ops/lut.py::lut_apply) on CUDA. Floating outputs below fp32
    (a bf16 forward) are lifted to fp32 first; call it outside any
    autocast."""
    del target
    out = {k: _at_least_fp32(v) for k, v in outputs.items()}
    if samples is not None:
        samples = {k: _at_least_fp32(v) for k, v in samples.items()}
    tasks = cfg.tasks
    if "super_resolution" in tasks and samples is not None \
            and "high_res_residual" in out:
        out["high_res"] = out["high_res_residual"] + samples["input"]
    if "bias_field" in tasks and "bias_field_log" in out:
        out["bias_field"] = torch.exp(out.pop("bias_field_log"))
    if "distance" in tasks and "distance" in out:
        d = out.pop("distance")
        out["lp"], out["lw"] = d[..., 0:1], d[..., 1:2]
        fake = _fake_cortical(out["lp"], out["lw"])
        if not cfg.generator.left_hemis_only:
            out["rp"], out["rw"] = d[..., 2:3], d[..., 3:4]
            fake = fake + _fake_cortical(out["rp"], out["rw"])
        out["fake_cortical"] = fake
    if "registration" in tasks and "registration" in out:
        r = out.pop("registration")
        out["regx"], out["regy"], out["regz"] = (r[..., 0:1], r[..., 1:2],
                                                 r[..., 2:3])
    if "segmentation" in tasks and "segmentation" in out:
        seg = out["segmentation"]
        count("host_syncs")   # the label table copied to the card
        lab = torch.tensor(list(cfg.label_list_segmentation),
                           dtype=torch.int32, device=seg.device)
        idx = torch.argmax(seg, dim=-1).to(torch.int32)
        out["label"] = lut_apply(lab, idx)[..., None]
    if "CT" in tasks and "CT" in out:
        out["CT"] = out["CT"] * 1000.0
    return out
