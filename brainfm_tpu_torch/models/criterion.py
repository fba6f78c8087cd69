"""Multi-task criterion (port of brainfm_tpu/models/criterion.py).

The reference's loss registry, weighting, lesion re-weighting,
defacing-mask weighting and intra-subject sample averaging, as one function
over stacked outputs: every output carries a leading sample axis S and
sample averaging is a reduction.

Conventions (the port's Joiner output, channels last): outputs[name] is
(S, D, H, W, C); targets[name] is (1, D, H, W, C) and broadcasts; scalars
(age) are (S,) / (1,). Clips follow `torch.clamp`, whose gradient at an
exact tie with the bound passes whole where `jnp.clip` splits it.

The segmentation losses take either the processed probabilities
(outputs["segmentation"]) or the head's logits before the softmax
(outputs["segmentation_logits"], as `models/build.py::process_outputs`
leaves them for the train step), from which `ops/segloss.py::seg_losses`
computes both losses at once: the eager chain on the CPU, two hand-written
passes on the card.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .losses import (gaussian_loss, gradient_loss, hessian_loss, l1_loss,
                     l2_loss, laplace_loss, smoothness_loss)
from ..ops.segloss import cross_entropy as ce, dice as _dice, seg_losses
from ..utils.profiling import count

_IMAGES = ("T1", "T2", "FLAIR", "CT")
# losses of one target each, left out for a subject without that target
_TARGET_OF = {"seg_ce": "segmentation", "seg_dice": "segmentation",
              "distance": "distance", "registration": "registration",
              "registration_grad": "registration"}


def _to(t, device):
    """A host tensor copied to `device`: one host sync."""
    count("host_syncs")
    return t.to(device)


def _seg_weights(n_labels: int, label_list_with_csf, relative_weight_lesions: float):
    """Per-label weights: the lesion label 77 (through the with_csf label
    list) up-weighted, then normalized."""
    w = np.ones(n_labels, np.float32)
    lab = np.asarray(label_list_with_csf)
    idx = np.where(lab == 77)[0]
    w[idx[idx < n_labels]] = relative_weight_lesions
    return w / w.sum()


def make_criterion(cfg) -> tuple[list, dict, Callable]:
    """Build (loss_names, weight_dict, loss_fn) from config: tasks,
    n_labels, label_list_segmentation_with_csf, relative_weight_lesions,
    losses.*, weights.*, contrastive temperatures when used."""
    tasks = list(cfg.tasks)
    losses_cfg = cfg.losses
    weights_cfg = cfg.weights
    uncertainty = losses_cfg.get("uncertainty")
    n_labels = int(cfg.n_labels)
    w_seg = torch.from_numpy(_seg_weights(
        n_labels, cfg.label_list_segmentation_with_csf,
        float(cfg.get("relative_weight_lesions", 1.0))))
    w_seg_on = {}

    def w_seg_to(device):
        """w_seg on `device`, copied there at its first use."""
        if device not in w_seg_on:
            w_seg_on[device] = _to(w_seg, device)
        return w_seg_on[device]

    if uncertainty == "gaussian":
        reg_loss = gaussian_loss
    elif uncertainty == "laplace":
        reg_loss = laplace_loss
    else:
        reg_loss = None  # plain l1

    bflog_loss = l1_loss if losses_cfg.get("bias_field_log_type") == "l1" else l2_loss

    loss_names: list[str] = []
    weight_dict: Dict[str, float] = {}

    def add(name, weight, key=None):
        loss_names.append(name)
        weight_dict[f"loss_{key or name}"] = float(weight)

    if "contrastive" in tasks:
        add("contrastive", weights_cfg.contrastive)
    else:
        for t in tasks:
            if t in _IMAGES:
                add(t, weights_cfg.image)
                if losses_cfg.get("image_grad"):
                    add(f"{t}_grad", weights_cfg.image_grad)
            if t == "segmentation":
                add("seg_ce", weights_cfg.seg_ce)
                add("seg_dice", weights_cfg.seg_dice)
            if t == "bias_field":
                add("bias_field_log", weights_cfg.bias_field_log)
            if t == "super_resolution":
                add("SR", weights_cfg.image)
                if losses_cfg.get("image_grad"):
                    add("SR_grad", weights_cfg.image_grad)
            if t == "distance":
                add("distance", weights_cfg.distance)
            if t == "registration":
                add("registration", weights_cfg.registration)
                for extra in ("grad", "smooth", "hessian"):
                    if losses_cfg.get(f"registration_{extra}"):
                        add(f"registration_{extra}",
                            weights_cfg[f"registration_{extra}"])
            if t == "age":
                add("age", weights_cfg.age)
            if t == "pathology":
                add("pathol_ce", weights_cfg.pathol_ce)
                add("pathol_dice", weights_cfg.pathol_dice)
            if t == "surface":
                add("surface", weights_cfg.get("surface", 1.0))
        if losses_cfg.get("implicit_pathol"):
            # frozen-critic supervision on predicted images
            add("implicit_pathol_ce",
                weights_cfg.get("implicit_pathol_ce", weights_cfg.pathol_ce))
            add("implicit_pathol_dice",
                weights_cfg.get("implicit_pathol_dice",
                                weights_cfg.pathol_dice))

    def image_loss(out, tgt, sigma=None, weights=1.0):
        if sigma is not None and reg_loss is not None:
            return reg_loss(out, sigma, tgt)
        return l1_loss(out, tgt, weights)

    def loss_fn(outputs, targets, samples):
        S = next((v.shape[0] for v in outputs.values()
                  if torch.is_tensor(v) and v.dim() >= 1), None)
        losses = {}
        logits, seg = outputs.get("segmentation_logits"), None
        for name in loss_names:
            if name in _TARGET_OF and _TARGET_OF[name] not in targets:
                # a subject without this target (the dataset layout's
                # subjects carry no distance or registration maps): the
                # loss is left out, as for an absent image target
                continue
            if name in _IMAGES:
                if name not in outputs or name not in targets:
                    continue
                dm = targets.get(f"{name}_DM")
                w = (1.0 - dm) if dm is not None else 1.0
                sig = outputs.get(f"{name}_sigma")
                losses[f"loss_{name}"] = image_loss(outputs[name], targets[name],
                                                    sig, w)
            elif name.endswith("_grad") and name[:-5] in _IMAGES:
                base = name[:-5]
                if base not in outputs or base not in targets:
                    continue
                dm = targets.get(f"{base}_DM")
                w = (1.0 - dm) if dm is not None else 1.0
                losses[f"loss_{name}"] = gradient_loss(outputs[base], targets[base], w)
            elif name == "SR":
                losses["loss_SR"] = image_loss(outputs["high_res_residual"],
                                               samples["high_res_residual"])
            elif name == "SR_grad":
                losses["loss_SR_grad"] = gradient_loss(outputs["high_res_residual"],
                                                       samples["high_res_residual"])
            elif name in ("seg_ce", "seg_dice") and logits is not None:
                if seg is None:   # both losses at once
                    seg = dict(zip(("seg_ce", "seg_dice"), seg_losses(
                        logits, targets["segmentation"],
                        w_seg_to(logits.device))))
                losses[f"loss_{name}"] = seg[name]
            elif name in ("seg_ce", "seg_dice"):
                p, t = outputs["segmentation"], targets["segmentation"]
                w = w_seg_to(p.device)
                # dice: sum over (S, labels) then / S, the reference's
                # sample averaging
                losses[f"loss_{name}"] = (ce(p, t, w) if name == "seg_ce"
                                          else _dice(p, t, w) / S)
            elif name in ("pathol_ce", "pathol_dice"):
                if "pathology" not in outputs or "pathology" not in targets:
                    continue
                p, t = outputs["pathology"], targets["pathology"]
                losses[f"loss_{name}"] = (ce(p, t) if name == "pathol_ce"
                                          else _dice(p, t) / S)
            elif name in ("implicit_pathol_ce", "implicit_pathol_dice"):
                if "implicit_pathol_pred" not in outputs:
                    continue
                p = outputs["implicit_pathol_pred"]
                t = outputs["implicit_pathol_orig"]
                losses[f"loss_{name}"] = (ce(p, t)
                                          if name == "implicit_pathol_ce"
                                          else _dice(p, t) / S)
            elif name == "distance":
                losses["loss_distance"] = image_loss(outputs["distance"],
                                                     targets["distance"])
            elif name == "registration":
                losses["loss_registration"] = image_loss(outputs["registration"],
                                                         targets["registration"])
            elif name == "registration_grad":
                losses["loss_registration_grad"] = gradient_loss(
                    outputs["registration"], targets["registration"])
            elif name == "registration_smooth":
                losses["loss_registration_smooth"] = smoothness_loss(
                    outputs["registration"])
            elif name == "registration_hessian":
                losses["loss_registration_hessian"] = hessian_loss(
                    outputs["registration"]) / S
            elif name == "bias_field_log":
                if "bias_field_log" not in samples:
                    continue
                mask = 1.0 - targets["segmentation"][..., 0:1]
                losses["loss_bias_field_log"] = bflog_loss(
                    outputs["bias_field_log"] * mask,
                    samples["bias_field_log"] * mask)
            elif name == "surface":
                if "surface" not in outputs or "surface" not in targets:
                    continue
                losses["loss_surface"] = torch.mean(
                    torch.abs(outputs["surface"] - targets["surface"]))
            elif name == "age":
                losses["loss_age"] = torch.mean(
                    torch.abs(outputs["age"] - targets["age"]))
            elif name == "contrastive":
                # samples ride the leading axis of the last decoder level
                feat = outputs["feat"]
                flast = feat[-1] if isinstance(feat, (list, tuple)) else feat
                f1, f2 = flast[0], flast[1]
                temps = cfg.contrastive_temperatures
                ta, tb, tg = (float(temps.alpha), float(temps.beta),
                              float(temps.gamma))
                num = torch.sum(torch.exp(f1 * f2 / ta), dim=-1)
                s_all = torch.sum(f1, dim=-1, keepdim=True)
                den = torch.sum(torch.exp(f1 ** 2 / tb)
                                + torch.exp((f1 * s_all - f1 ** 2) / tg), dim=-1)
                losses["loss_contrastive"] = torch.mean(-torch.log(num / den))
        return losses

    return loss_names, weight_dict, loss_fn


def weighted_total(losses: dict, weight_dict: dict):
    """Weighted sum over the losses present."""
    total = 0.0
    for k, w in weight_dict.items():
        if k in losses:
            total = total + w * losses[k]
    return total
