"""Model assembly: task wiring, joiner and output processors (port of
brainfm_tpu/models/build.py).

The model modules run in NCDHW, the layout cuDNN expects; the `Joiner`
takes and returns the JAX package's channels-last layout (N,D,H,W,C) and
permutes once at its boundary. Mixed precision is the caller's
`torch.autocast`, not a compute dtype.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..device import resolve_device
from ..ops.lut import lut_apply
from ..synth.constants import LABELS_EXTRACEREBRAL, LABELS_LEFT
from .heads import TaskHead
from .unet3d import UNet3D


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
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class Joiner(nn.Module):
    """Backbone + head. Takes x (N,D,H,W,C) and optional conditioning
    channels concatenated to it; returns {'feat': [...], <head outputs>},
    every tensor (N,D,H,W,C)."""

    def __init__(self, backbone, head=None):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x, cond=None):
        if cond is not None:
            x = torch.cat([x, cond], dim=-1)
        feats = self.backbone.get_feature(_to_ncdhw(x).contiguous())
        out = {"feat": [_to_ndhwc(f) for f in feats]}
        if self.head is not None:
            out.update({k: _to_ndhwc(v) for k, v in self.head(feats).items()})
        return out


def build_backbone(cfg, name: str | None = None):
    name = name or cfg.backbone or "unet3d"
    if name != "unet3d":
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    return UNet3D(in_channels=int(cfg.in_channels or 1),
                  f_maps=int(cfg.f_maps or 64),
                  num_levels=int(cfg.num_levels or 5),
                  layer_order=cfg.layer_order or "gcl",
                  num_groups=int(cfg.num_groups or 8),
                  is_unit_vector=bool(cfg.unit_feat))


def build_model(cfg, device=None):
    """Assemble the model for cfg on `device` (default CUDA).
    Returns (cfg, model)."""
    dev = resolve_device(device)
    cfg = process_args(cfg)
    backbone = build_backbone(cfg)
    head = TaskHead(int(cfg.f_maps or 64), tuple(cfg.task_f_maps or [64]),
                    dict(cfg.out_channels))
    return cfg, Joiner(backbone, head).to(dev)


def apply_processors(outputs: dict, cfg) -> dict:
    """Output processors on the Joiner's (N,D,H,W,C) outputs."""
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
        lab = torch.tensor(list(cfg.label_list_segmentation),
                           dtype=torch.int32, device=seg.device)
        idx = torch.argmax(seg, dim=-1).to(torch.int32)
        out["label"] = lut_apply(lab, idx)[..., None]
    if "CT" in tasks and "CT" in out:
        out["CT"] = out["CT"] * 1000.0
    return out
